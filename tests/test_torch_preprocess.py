"""The port's preprocess stage (vidsum_tpu_torch/preprocess/) against the JAX
package's: the backbones (GoogLeNet, R3D-18) on the committed goldens and
against ``googlenet_apply`` / ``r3d18_apply`` through the parameter
converters, folded and not; the state-dict coverage check; the transforms;
the extractor; the annotation readers; the dataset builder's h5 and its
CLI."""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from vidsum_tpu.cli import build_dataset as jax_build_cli
from vidsum_tpu.data import TSDataset
from vidsum_tpu.preprocess import annotations as jax_annotations
from vidsum_tpu.preprocess import build_dataset as jax_build
from vidsum_tpu.preprocess.googlenet import (
    fold_googlenet, googlenet_apply, googlenet_from_torch_state,
)
from vidsum_tpu.preprocess.r3d import (
    fold_r3d18, r3d18_apply, r3d18_from_torch_state,
)
from vidsum_tpu.preprocess.transforms import (
    imagenet_normalize as jax_imagenet_normalize,
    resize_shorter_side as jax_resize, video_normalize as jax_video_normalize,
)
from vidsum_tpu.train import save_checkpoint as jax_save_checkpoint
from vidsum_tpu_torch.cli import build_dataset as build_cli
from vidsum_tpu_torch.preprocess import (
    FeatureExtractor, GoogLeNet, R3D18, device_normalize,
    googlenet_params_from_jax, load_backbone, r3d18_params_from_jax,
)
from vidsum_tpu_torch.preprocess import annotations as port_annotations
from vidsum_tpu_torch.preprocess import build_dataset as port_build
from vidsum_tpu_torch.preprocess import reduce_fps as port_rf
from vidsum_tpu_torch.preprocess.extract import embed
from vidsum_tpu_torch.preprocess.nn import exact_f32_convs
from vidsum_tpu_torch.preprocess.transforms import (
    prepare_video, resize_shorter_side, resize_video,
)
from tests.test_torch_finetune import _actions
from tests.torch_mirrors import GoogLeNetMirror, R3D18Mirror, randomize_bn_stats

GOLDENS = os.path.join(os.path.dirname(__file__), "data",
                       "backbone_goldens.npz")
NETS = {"google": (GoogLeNet, GoogLeNetMirror, 0, 1, googlenet_from_torch_state,
                   googlenet_apply, fold_googlenet, googlenet_params_from_jax),
        "r3d18": (R3D18, R3D18Mirror, 2, 3, r3d18_from_torch_state,
                  r3d18_apply, fold_r3d18, r3d18_params_from_jax)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs six workers on a few cores: torch's default of one
    thread a core per worker oversubscribes them, and OpenMP's waiting
    threads slowed this module's convolutions up to a hundredfold there.
    Two threads a worker while its tests run, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def mirror_state(kind, double=False):
    """The seeded torch mirror's state (torchvision keys, nontrivial BN
    statistics), as numpy, as the JAX tests make it."""
    _, mirror_cls, seed, bn_seed = NETS[kind][:4]
    torch.manual_seed(seed)
    mirror = mirror_cls()
    if double:
        mirror = mirror.double()
    randomize_bn_stats(mirror.eval(), bn_seed)
    return mirror, {k: v.numpy() for k, v in mirror.state_dict().items()}


def port_net(kind, state):
    return NETS[kind][0]().load_torch_state(state)


def run(net, x_nchw):
    with torch.inference_mode():
        return net(torch.as_tensor(x_nchw, dtype=torch.float32)).numpy()


@pytest.mark.parametrize("kind,key_in,key_out", [
    ("google", "google_in", "google_pool5"), ("r3d18", "r3d_in", "r3d_embed")])
def test_backbone_goldens(kind, key_in, key_out):
    """Loaded from the fp64 mirror's state dict, the port reproduces the
    committed golden features at the JAX tests' bound, folded and not."""
    g = np.load(GOLDENS)
    _, state = mirror_state(kind, double=True)
    net = port_net(kind, state)
    for n in (net, net.fold()):
        np.testing.assert_allclose(run(n, g[key_in]), g[key_out], rtol=1e-3,
                                   atol=1e-4)


@pytest.mark.parametrize("kind", ["google", "r3d18"])
def test_backbone_matches_jax_through_converter(kind, tmp_path):
    """JAX params (from the mirror's state) -> ``*_params_from_jax`` -> the
    port equals ``googlenet_apply`` / ``r3d18_apply`` at rtol 1e-4 / atol
    1e-5, unfolded and folded: the port's own fold, and the JAX folded tree
    loaded into the folded net. The JAX package's msgpack of either tree
    loads through ``load_backbone`` with the same weights."""
    _, _, _, _, from_state, apply, fold, from_jax = NETS[kind]
    _, state = mirror_state(kind)
    params = from_state(state)
    rng = np.random.default_rng(0)
    shape = (1, 3, 64, 64) if kind == "google" else (1, 3, 8, 56, 56)
    x = rng.normal(size=shape).astype(np.float32)
    x_last = np.moveaxis(x, 1, -1)
    fwd = jax.jit(apply)
    want = np.asarray(fwd(params, x_last))
    want_f = np.asarray(fwd(fold(params), x_last))
    net = NETS[kind][0]().load_torch_state(from_jax(params))
    np.testing.assert_allclose(run(net, x), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(run(net.fold(), x), want_f, rtol=1e-4,
                               atol=1e-5)
    folded_jax = NETS[kind][0]().fold().load_torch_state(
        from_jax(jax.tree_util.tree_map(np.asarray, fold(params))))
    np.testing.assert_allclose(run(folded_jax, x), want_f, rtol=1e-4,
                               atol=1e-5)
    # the two folds' arithmetic is the same: equal weights
    for k, v in net.fold().state_dict().items():
        np.testing.assert_array_equal(v.numpy(),
                                      folded_jax.state_dict()[k].numpy(), k)
    for tree, want_net, fold_bn in ((params, net, False),
                                    (fold(params), folded_jax, True)):
        path = str(tmp_path / f"{kind}_{fold_bn}.msgpack")
        jax_save_checkpoint(path, tree)
        loaded = load_backbone(kind, path, fold_bn=fold_bn, device="cpu")
        for k, v in want_net.state_dict().items():
            np.testing.assert_array_equal(loaded.state_dict()[k].numpy(),
                                          v.numpy(), k)


def test_state_coverage_catches_renames():
    """A renamed torchvision key fails the load; an unused extra key fails
    the coverage check; the heads the reference strips load."""
    _, state = mirror_state("google")
    GoogLeNet().load_torch_state(dict(state))
    renamed = dict(state)
    renamed["inception5b.branch4.2.conv.weight"] = renamed.pop(
        "inception5b.branch4.1.conv.weight")
    with pytest.raises(KeyError):
        GoogLeNet().load_torch_state(renamed)
    extra = dict(state)
    extra["inception9z.branch1.conv.weight"] = state["conv2.conv.weight"]
    with pytest.raises(ValueError, match="not consumed"):
        GoogLeNet().load_torch_state(extra)
    heads = dict(state, **{"fc.weight": np.zeros((1000, 1024), np.float32),
                           "aux1.conv.conv.weight": np.zeros((128, 512, 1, 1)),
                           "conv1.bn.num_batches_tracked": np.asarray(0)})
    GoogLeNet().load_torch_state(heads)
    _, r_state = mirror_state("r3d18")
    r_extra = dict(r_state, **{"layer9.0.conv1.0.weight":
                               r_state["stem.0.weight"]})
    with pytest.raises(ValueError, match="not consumed"):
        R3D18().load_torch_state(r_extra)


def test_exact_f32_convs_scope():
    """The backbones' TF32 switch is scoped to the call: off inside, the
    global flag untouched outside."""
    before = torch.backends.cudnn.allow_tf32
    with exact_f32_convs():
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == before


def test_transforms_bit_equal():
    """resize_shorter_side and the normalisations equal the JAX host
    functions bit for bit (device_normalize on the CPU over every uint8
    value: 0 ULP, where JAX's own device normalisation is within 2 ULP);
    a frame already at the size skips PIL and PIL's resize there is the
    identity."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for shape in ((120, 240, 3), (240, 120, 3), (64, 96, 3)):
        frame = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(resize_shorter_side(frame, 60),
                                      jax_resize(frame, 60))
    same = rng.integers(0, 256, (224, 398, 3), dtype=np.uint8)
    assert resize_shorter_side(same, 224) is same
    np.testing.assert_array_equal(
        np.asarray(Image.fromarray(same).resize((398, 224), Image.BILINEAR)),
        same)
    allv = np.broadcast_to(np.arange(256, dtype=np.uint8)[None, :, None, None],
                           (1, 256, 2, 3)).copy()
    for kind, host in (("google", jax_imagenet_normalize),
                       ("r3d18", jax_video_normalize)):
        got = device_normalize(torch.from_numpy(allv), kind).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, host(allv))
    video = rng.integers(0, 256, (3, 48, 64, 3), dtype=np.uint8)
    out = prepare_video(video, 32, "google")
    assert out.shape == (3, 32, 43, 3) and out.dtype == np.float32


def test_feature_extractor():
    """Streaming equals the eager batching (fixed batches, zero-padded
    tail); folded by default (no BN left) and within f32 rounding of the
    unfolded net; an empty stream gives (0, 1024); clip equals
    clip_resized; the entry points run on the card unless asked."""
    rng = np.random.default_rng(3)
    video = rng.integers(0, 256, (10, 48, 64, 3), dtype=np.uint8)
    ex = FeatureExtractor("google", batch_size=4, device="cpu")
    assert not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                   for m in ex.net.modules())
    x = resize_video(video, 64)
    outs = []
    for start in range(0, 10, 4):
        chunk = x[start:start + 4]
        pad = 4 - chunk.shape[0]
        chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:],
                                                np.uint8)])
        outs.append(embed(ex.net, "google", torch.from_numpy(chunk))
                    [: 4 - pad].numpy())
    oracle = np.concatenate(outs)
    assert np.array_equal(ex.frames(video, size=64), oracle)
    assert np.array_equal(ex.frames_stream(iter(video), size=64), oracle)
    assert ex.frames_stream(iter([]), size=64).shape == (0, 1024)
    unfolded = FeatureExtractor("google", batch_size=4, fold_bn=False,
                                device="cpu")
    np.testing.assert_allclose(ex.frames(video, size=64),
                               unfolded.frames(video, size=64), rtol=2e-4,
                               atol=2e-5)
    r3d = FeatureExtractor("r3d18", device="cpu")
    clip = rng.integers(0, 256, (6, 48, 64, 3), dtype=np.uint8)
    a = r3d.clip(clip, size=48)
    assert a.shape == (512,)
    assert np.array_equal(a, r3d.clip_resized(resize_video(clip, 48)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            FeatureExtractor("google")


def _tvsum_mat(path, videos):
    """A MATLAB v7.3-shaped TVSum annotation file (h5 object references)."""
    import h5py

    with h5py.File(path, "w") as f:
        refs = f.create_group("#refs#")
        root = f.create_group("tvsum50")
        fields = {k: [] for k in ("video", "gt_score", "nframes", "user_anno",
                                  "title", "category")}
        for i, v in enumerate(videos):
            for k, val in v.items():
                if isinstance(val, str):
                    val = np.array([ord(c) for c in val], np.uint16)[:, None]
                d = refs.create_dataset(f"{k}_{i}", data=val)
                fields[k].append(d.ref)
        for k, rs in fields.items():
            root.create_dataset(k, data=np.array(rs, dtype=h5py.ref_dtype)
                                [:, None])


def test_annotation_readers_match_jax(tmp_path):
    from scipy import io

    rng = np.random.default_rng(4)
    videos = [dict(video=f"vid{i}", title=f"t{i}", category="VT",
                   gt_score=rng.random((1, 30)), nframes=np.array([[30.0]]),
                   user_anno=rng.integers(1, 6, (30, 4)).astype(np.float64))
              for i in range(2)]
    mat = str(tmp_path / "tvsum.mat")
    _tvsum_mat(mat, videos)
    summe = tmp_path / "summe"
    summe.mkdir()
    io.savemat(str(summe / "Air_Force_One.mat"),
               {"gt_score": rng.random((40, 1)), "nFrames": [[40]],
                "user_score": (rng.random((40, 3)) > 0.8).astype(float),
                "segments": np.zeros((1, 3))})
    for reader, arg in (("read_tvsum_annotations", mat),
                        ("read_summe_annotations", str(summe))):
        got = getattr(port_annotations, reader)(arg)
        want = getattr(jax_annotations, reader)(arg)
        assert got.keys() == want.keys() and got
        for k in want:
            for field in ("video_id", "n_frames", "title", "category"):
                assert getattr(got[k], field) == getattr(want[k], field)
            for field in ("gt_score", "user_anno"):
                np.testing.assert_array_equal(getattr(got[k], field),
                                              getattr(want[k], field))


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("videos")
    for vi in range(2):
        w = cv2.VideoWriter(str(d / f"vid{vi}.mp4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), 30, (96, 64))
        if not w.isOpened():
            pytest.skip("cv2.VideoWriter unavailable")
        rng = np.random.default_rng(vi)
        for _ in range(3):
            base = rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)
            for _ in range(30):
                noise = rng.integers(-10, 10, base.shape)
                w.write(np.clip(base.astype(int) + noise, 0, 255)
                        .astype(np.uint8))
        w.release()
    return str(d)


def _annotations(n_frames=90, n_users=4):
    out = {}
    for vi in range(2):
        rng = np.random.default_rng(100 + vi)
        gt = rng.random(n_frames).astype(np.float32)
        out[f"vid{vi}"] = port_annotations.VideoAnnotation(
            video_id=f"vid{vi}", gt_score=gt, n_frames=n_frames,
            user_anno=(gt[None] * 4 + rng.random((n_users, n_frames)))
            .astype(np.float32))
    return out


@pytest.fixture(scope="module")
def built(video_dir, tmp_path_factory):
    """One ``cli.build_dataset`` run on the CPU over the two videos, with
    TVSum annotations (a v7.3-shaped .mat), R3D-18 reps and the packaging
    tar."""
    d = tmp_path_factory.mktemp("built")
    annos = _annotations()
    mat = str(d / "tvsum.mat")
    _tvsum_mat(mat, [dict(video=k, title=k, category="VT",
                          gt_score=a.gt_score[None].astype(np.float64),
                          nframes=np.array([[float(a.n_frames)]]),
                          user_anno=a.user_anno.T.astype(np.float64))
                     for k, a in annos.items()])
    out_h5 = str(d / "summarizer_dataset_tvsum_google_pool5.h5")
    with pytest.MonkeyPatch.context() as mp:
        # the 6 sampled frames of a video fill one batch of 8, not one of
        # the CPU default's 64 (the padding's work, nothing else, changes)
        mp.setattr(port_build, "FeatureExtractor",
                   functools.partial(FeatureExtractor, batch_size=8))
        build_cli.main(["--videos", video_dir, "--out", out_h5,
                        "--annotations", mat, "--dataset", "tvsum",
                        "--video_rep_dir", str(d / "reps"), "--tar",
                        str(d / "p.tar.gz")], device="cpu")
    return d, out_h5, port_annotations.read_tvsum_annotations(mat)


def test_build_dataset_h5_has_the_jax_schema(built):
    """The port's h5 reads back through the JAX data layer, and each group
    holds the fields the JAX builder writes for the same features, with
    their dtypes and shapes, the derived ones (change points, user
    summaries, gtscore) bit-equal to the JAX ``entry_from_features``'s."""
    import h5py

    d, out_h5, annos = built
    ds = TSDataset(str(d), "tvsum", "tvsum", split="val")
    feats, target, user = ds[0]
    assert feats.shape == (6, 1024) and target.shape == (6,)
    assert user.n_frames == 90
    assert user.picks.tolist() == [0, 15, 30, 45, 60, 75]
    assert user.change_points[-1, 1] == 89
    assert user.user_summary.shape == user.user_scores.shape == (4, 90)
    with h5py.File(out_h5) as f:
        assert sorted(f.keys()) == ["video_0", "video_1"]
        for i, name in enumerate(("vid0", "vid1")):
            g = f[f"video_{i}"]
            features = np.asarray(g["features"])
            want = jax_build.entry_from_features(
                features, None, np.asarray(g["picks"]), 90, annos[name])
            want["video_name"] = np.bytes_(name)
            assert set(g.keys()) == set(want)
            for field, value in want.items():
                got = np.asarray(g[field])
                assert got.dtype == np.asarray(value).dtype, field
                np.testing.assert_array_equal(got, value, err_msg=field)


def test_build_dataset_cli(built):
    """``cli.build_dataset``'s parser equals the JAX one; its run wrote the
    R3D-18 reps and the packaging tar beside the h5."""
    import pickle
    import tarfile

    assert _actions(build_cli.build_parser()) == _actions(
        jax_build_cli.build_parser())
    d, _, _ = built
    assert np.load(str(d / "reps" / "video_0.npy")).shape == (512,)
    with tarfile.open(str(d / "p.tar.gz"), "r:gz") as tar:
        with tar.extractfile("annotations") as f:
            assert set(pickle.load(f)) == {"vid0", "vid1"}
        assert "features/video/vid1.npy" in tar.getnames()


def test_reduce_fps_stream_matches_eager(video_dir):
    """The lazy decode equals the eager reduce_fps frame for frame, with
    the picks contract (pick i is original frame i * step)."""
    path = os.path.join(video_dir, "vid0.mp4")
    frames, picks, n_frames = port_rf.reduce_fps(path, fps=2)
    rs = port_rf.iter_reduced_frames(path, fps=2)
    streamed = list(rs.frames)
    assert rs.n_frames == n_frames == 90
    assert np.array_equal(np.stack(streamed), frames)
    assert np.array_equal(rs.picks(len(streamed)), picks)
    assert picks.tolist() == [0, 15, 30, 45, 60, 75]

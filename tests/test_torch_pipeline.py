"""The port's raw-video path (vidsum_tpu_torch/pipeline.py, cli.summarize,
export/{attention,frames}.py) against the JAX package's on one cv2-written
video with planted scene cuts, both packages with the same weights: the
features, scores, change points, picks and summaries, host and device KTS,
the chunking, the two-deep directory loop, the sequence-sharded route and
the CLI."""

import json
import shutil

import numpy as np
import pytest
import torch

from vidsum_tpu import pipeline as jax_pl
from vidsum_tpu.cli import serve as jax_serve_cli
from vidsum_tpu.cli import summarize as jax_summarize_cli
from vidsum_tpu.config import Config as JaxConfig
from vidsum_tpu.config import DataConfig as JaxDataConfig
from vidsum_tpu.config import ModelConfig as JaxModelConfig
from vidsum_tpu.data import PATH as JAX_PATH
from vidsum_tpu.data import TSDataset as JaxTSDataset
from vidsum_tpu.data.synthetic import make_synthetic_h5
from vidsum_tpu.export.attention import (
    collect_attention_weights as jax_collect_attention,
)
from vidsum_tpu.export.frames import reduce_fps_and_save as jax_save_frames
from vidsum_tpu.preprocess.googlenet import (
    fold_googlenet, googlenet_from_torch_state,
)
from vidsum_tpu.train import save_checkpoint as jax_save_checkpoint
from vidsum_tpu_torch import pipeline as pl
from vidsum_tpu_torch.cli import serve as serve_cli
from vidsum_tpu_torch.cli import summarize as summarize_cli
from vidsum_tpu_torch.config import Config, DataConfig, ModelConfig
from vidsum_tpu_torch.data.datasets import TSDataset
from vidsum_tpu_torch.export import (
    collect_attention_weights, reduce_fps_and_save,
)
from vidsum_tpu_torch.models.convert import params_to_jax
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.parallel.mesh import make_mesh
from vidsum_tpu_torch.preprocess import GoogLeNet
from vidsum_tpu_torch.preprocess import reduce_fps as port_rf
from vidsum_tpu_torch.train.checkpoint import save_checkpoint
from tests.test_torch_finetune import _actions, port_actions

cv2 = pytest.importorskip("cv2")

KW = dict(d_model=32, num_heads=4, num_layers=1, dropout=0.0, max_len=256)
SIZE = 64           # the 96 x 64 frames already have it: no resize
BUDGET = 0.5        # at 0.15 no 150-frame shot fits: summaries all empty


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


@pytest.fixture(scope="module")
def video_path(tmp_path_factory):
    """6 scenes of 150 frames at 30 fps: 60 picks at 2 fps."""
    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (96, 64))
    if not w.isOpened():
        pytest.skip("cv2.VideoWriter unavailable")
    rng = np.random.default_rng(0)
    for _ in range(6):
        base = rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)
        for _ in range(150):
            noise = rng.integers(-8, 8, base.shape)
            w.write(np.clip(base.astype(int) + noise, 0, 255).astype(np.uint8))
    w.release()
    return path


@pytest.fixture(scope="module")
def models():
    """The same weights in both packages: the port's seeded GoogLeNet
    (folded by each package's own fold) and SimNet."""
    cfg = ModelConfig(**KW)
    google = GoogLeNet(generator=torch.Generator().manual_seed(1))
    state = {k: v.numpy() for k, v in google.state_dict().items()}
    jax_google = fold_googlenet(googlenet_from_torch_state(state))
    scorer = SimNet(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    return (cfg, scorer, google.fold(), JaxModelConfig(**KW),
            params_to_jax(scorer.state_dict()), jax_google)


@pytest.fixture(scope="module")
def pending(video_path, models):
    """Both packages' decode + features + scores (nothing selected yet)."""
    cfg, scorer, google, jcfg, jscorer, jgoogle = models
    j = jax_pl._begin_video(video_path, jscorer, jcfg, jgoogle, 2, SIZE, 64,
                            None, 256)
    p = pl._begin_video(video_path, scorer, cfg, google, 2, SIZE, 64, None,
                        256, torch.device("cpu"))
    return j, p


def test_features_and_scores_match_jax(pending):
    """Features at the backbone bound (rtol 1e-4 / atol 1e-5), scores at
    1e-5, picks equal."""
    j, p = pending
    assert p.n_real == j.n_real == 60 and p.n_frames == j.n_frames == 900
    np.testing.assert_array_equal(p.picks, j.picks)
    np.testing.assert_allclose(p.feats.numpy(),
                               np.asarray(j.feats)[: j.n_real], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(p.scores[: p.n_real].numpy(),
                               np.asarray(j.scores)[: j.n_real], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kts_impl", ["host", "device"])
def test_summarize_video_matches_jax(video_path, models, kts_impl):
    """``summarize_video`` in both packages, host and device KTS: scores
    within 1e-5, change points, picks and the summary equal; the planted
    cuts are found."""
    cfg, scorer, google, jcfg, jscorer, jgoogle = models
    want = jax_pl.summarize_video(video_path, jscorer, jcfg, jgoogle, fps=2,
                                  size=SIZE, budget_ratio=BUDGET,
                                  kts_impl=kts_impl)
    got = pl.summarize_video(video_path, scorer, cfg, google, fps=2,
                             size=SIZE, budget_ratio=BUDGET,
                             kts_impl=kts_impl, device="cpu")
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.change_points, want.change_points)
    np.testing.assert_array_equal(got.picks, want.picks)
    np.testing.assert_array_equal(got.summary, want.summary)
    assert got.n_frames == 900 and got.summary.sum() > 0
    assert len(got.change_points) == 3   # ncp = max(60 // 25, 1) = 2 cuts


def test_summarize_video_chunk_invariance(video_path, models):
    """Chunks of 4 frames scored at length 128 against one chunk scored at
    256: the padded frames are masked, so scores agree within 1e-5 and the
    selection is equal."""
    cfg, scorer, google = models[:3]
    outs = [pl.summarize_video(video_path, scorer, cfg, google, fps=2,
                               size=SIZE, pad_multiple=pm, stream_chunk=c,
                               budget_ratio=BUDGET, device="cpu")
            for pm, c in ((4, 4), (256, 512))]
    assert pl.score_length(60, 4) == 128 and pl.score_length(60, 256) == 256
    np.testing.assert_allclose(outs[0].scores, outs[1].scores, rtol=1e-5,
                               atol=1e-6)
    assert outs[0].summary.sum() > 0
    assert np.array_equal(outs[0].summary, outs[1].summary)
    assert np.array_equal(outs[0].change_points, outs[1].change_points)


def test_summarize_directory_matches_jax(video_path, models, tmp_path):
    """The two-deep directory loop writes JAX's JSON, and each entry equals
    a sequential ``summarize_video`` call."""
    cfg, scorer, google, jcfg, jscorer, jgoogle = models
    vdir = tmp_path / "vids"
    vdir.mkdir()
    for name in ("a.mp4", "b.mp4"):
        shutil.copy(video_path, vdir / name)
    jres = jax_pl.summarize_directory(str(vdir), jscorer, jcfg, jgoogle,
                                      out_json=str(tmp_path / "j.json"),
                                      fps=2, size=SIZE, budget_ratio=BUDGET)
    res = pl.summarize_directory(str(vdir), scorer, cfg, google,
                                 out_json=str(tmp_path / "p.json"), fps=2,
                                 size=SIZE, budget_ratio=BUDGET, device="cpu")
    with open(tmp_path / "p.json") as f, open(tmp_path / "j.json") as g:
        assert f.read() == g.read()
    assert res == jres
    seq = pl.summarize_video(video_path, scorer, cfg, google, fps=2,
                             size=SIZE, budget_ratio=BUDGET, device="cpu")
    assert res["video_0"] == np.nonzero(seq.summary)[0].tolist() != []


def test_seq_sharded_route_through_the_decoder_seam(models, monkeypatch):
    """A numpy-made video through the decoder seam (the card's stand-in for
    cv2) on a CPU ``DeviceMesh`` (1, 2): the length pads to 2 x 64, scores
    within 2e-4 of the single-device route (the seq forward's bound); the
    device KTS there finds the host KTS's change points (the 6 scenes), and
    the summaries are equal."""
    cfg, scorer, google = models[:3]
    n_real, step = 300, 15
    rng = np.random.default_rng(3)
    scenes = rng.integers(0, 255, (6, 32, 48, 3), dtype=np.uint8)
    frames = np.clip(np.repeat(scenes, n_real // 6, axis=0).astype(int)
                     + rng.integers(-8, 8, (n_real, 32, 48, 3)), 0,
                     255).astype(np.uint8)

    def fake_iter(path, fps=2):
        return port_rf.ReducedStream(frames=iter(frames),
                                     n_frames=n_real * step, step=step,
                                     final_count=n_real, height=32, width=48)

    monkeypatch.setattr(port_rf, "iter_reduced_frames", fake_iter)
    mesh = make_mesh((1, 2), "cpu")
    assert pl.score_length(n_real, 64, mesh) == 384
    sharded = pl.summarize_video("seam.mp4", scorer, cfg, google, fps=2,
                                 size=32, mesh=mesh, kts_impl="device",
                                 device="cpu")
    dense = pl.summarize_video("seam.mp4", scorer, cfg, google, fps=2,
                               size=32, device="cpu")
    np.testing.assert_allclose(sharded.scores, dense.scores, rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_array_equal(sharded.change_points, dense.change_points)
    np.testing.assert_array_equal(sharded.summary, dense.summary)
    # the planted cuts are among the shots' starts
    assert {750, 1500, 2250, 3000, 3750} <= set(
        dense.change_points[:, 0].tolist())
    assert sharded.summary.shape == (n_real * step,)


def test_cli_summarize(video_path, models, tmp_path):
    """``cli.summarize`` on the CPU: its parser equals the JAX one (with
    the port's ``--arch``); a JAX msgpack ``--ckpt`` and the port's own
    checkpoint of the same weights
    select the same frames; ``--seq_shards 2 --kts_impl device`` selects
    the default run's frames."""
    assert port_actions(summarize_cli.build_parser()) == _actions(
        jax_summarize_cli.build_parser())
    cfg, scorer = models[:2]
    jpath, ppath = str(tmp_path / "j.ckpt"), str(tmp_path / "p.ckpt")
    jax_save_checkpoint(jpath, params_to_jax(scorer.state_dict()))
    save_checkpoint(ppath, scorer.state_dict())
    base = ["--video", video_path, "--d_model", "32", "--num_heads", "4",
            "--num_layers", "1", "--size", str(SIZE), "--budget",
            str(BUDGET)]
    outs = []
    for i, extra in enumerate((["--ckpt", jpath], ["--ckpt", ppath],
                               ["--ckpt", ppath, "--seq_shards", "2",
                                "--kts_impl", "device"])):
        out = str(tmp_path / f"s{i}.json")
        summarize_cli.main(base + extra + ["--out", out], device="cpu")
        with open(out) as f:
            outs.append(json.load(f))
    assert outs[0]["n_frames"] == 900 and outs[0]["selected_frames"]
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("cli_mod", [summarize_cli, serve_cli],
                         ids=["summarize", "serve"])
def test_cli_help_states_the_card_limits(cli_mod):
    """The card has no width limits of its own: the width flags' help
    reads as the JAX CLI's."""
    jax_cli = {summarize_cli: jax_summarize_cli, serve_cli: jax_serve_cli}[
        cli_mod]
    helps = [{a.dest: a.help for a in p._actions
              if a.dest in ("d_model", "num_heads")}
             for p in (cli_mod.build_parser(), jax_cli.build_parser())]
    assert helps[0] == helps[1]


def test_serve_parser_still_matches_jax():
    assert port_actions(serve_cli.build_parser()) == _actions(
        jax_serve_cli.build_parser())


@pytest.fixture(scope="module")
def val_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("exp")
    make_synthetic_h5(str(root / JAX_PATH["tvsum"]), n_videos=3, seed=21)
    return (JaxTSDataset(str(root), "tvsum", "tvsum", split="val"),
            TSDataset(str(root), "tvsum", "tvsum", split="val"), str(root))


def test_collect_attention_weights_matches_jax(val_sets, tmp_path):
    """Per-video maps (layers, heads, n, n) within 1e-5 of JAX's."""
    jval, val, root = val_sets
    model_kw = dict(d_model=32, num_heads=4, num_layers=2, dropout=0.0,
                    max_len=256)
    scorer = SimNet(ModelConfig(**model_kw), device="cpu",
                    generator=torch.Generator().manual_seed(5))
    want = jax_collect_attention(
        params_to_jax(scorer.state_dict()), jval,
        JaxConfig(model=JaxModelConfig(**model_kw),
                  data=JaxDataConfig(root=root)))
    got = collect_attention_weights(
        scorer, val, Config(model=ModelConfig(**model_kw),
                            data=DataConfig(root=root)))
    assert got.keys() == want.keys() == {"video_0", "video_1", "video_2"}
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_reduce_fps_and_save_matches_jax(video_path, tmp_path):
    n = reduce_fps_and_save(video_path, fps=2, out_root=str(tmp_path / "p"))
    assert n == jax_save_frames(video_path, fps=2,
                                out_root=str(tmp_path / "j")) == 60
    for i in (0, 59):
        a = tmp_path / "p" / "clip" / f"{i}.jpg"
        b = tmp_path / "j" / "clip" / f"{i}.jpg"
        assert a.read_bytes() == b.read_bytes()

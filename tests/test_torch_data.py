"""The port's data layer and eval helpers against the JAX package's, on the
CPU: the synthetic DSNet h5 files (both layouts) and pretraining trees,
``TSDataset`` item for item (train and val, fold keys, ``"+"``-joined
datasets, ``min_frames``, eccv16 files), the bundled split files, the
segmentation helpers, the legacy h5-direct F-score and ``count_params``."""

import os

import h5py
import jax
import numpy as np
import pytest
import yaml

from vidsum_tpu.config import ModelConfig as JaxModelConfig
from vidsum_tpu.data import TSDataset as JaxTSDataset
from vidsum_tpu.data import splits as jsplits
from vidsum_tpu.data import synthetic as jsynthetic
from vidsum_tpu.data.paths import ECCV16_PATH as JAX_ECCV16_PATH
from vidsum_tpu.data.paths import PATH as JAX_PATH
from vidsum_tpu.models.simnet import count_params as jax_count_params
from vidsum_tpu.models import init_simnet
from vidsum_tpu.ops import legacy_eval as jlegacy
from vidsum_tpu.ops import segmentation as jseg
from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.data import paths, splits, synthetic
from vidsum_tpu_torch.data.datasets import TSDataset
from vidsum_tpu_torch.models.simnet import SimNet, count_params
from vidsum_tpu_torch.ops import legacy_eval, segmentation

FEATURES = 64


def _h5_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("layout", ["summarizer", "eccv16"])
def test_make_synthetic_h5_equals_jax(tmp_path, layout):
    kw = dict(n_videos=3, feature_dim=FEATURES, seed=5, layout=layout)
    synthetic.make_synthetic_h5(str(tmp_path / "p.h5"), **kw)
    jsynthetic.make_synthetic_h5(str(tmp_path / "j.h5"), **kw)
    got, want = _h5_tree(tmp_path / "p.h5"), _h5_tree(tmp_path / "j.h5")
    assert got.keys() == want.keys() and len(got) >= 3 * 7
    for key, w in want.items():
        g = got[key]
        assert np.asarray(g).dtype == np.asarray(w).dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    with pytest.raises(ValueError, match="unknown layout"):
        synthetic.make_synthetic_h5(str(tmp_path / "x.h5"), layout="other")


def test_make_synthetic_pretrain_tree_equals_jax(tmp_path):
    kw = dict(n_videos=3, feature_dim=FEATURES, rep_dim=16, seed=2)
    synthetic.make_synthetic_pretrain_tree(str(tmp_path / "p"), **kw)
    jsynthetic.make_synthetic_pretrain_tree(str(tmp_path / "j"), **kw)
    for sub in ("frames", "video"):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert sorted(os.listdir(tmp_path / "p" / sub)) == names
        for n in names:
            np.testing.assert_array_equal(np.load(tmp_path / "p" / sub / n),
                                          np.load(tmp_path / "j" / sub / n))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """The four DSNet datasets (tvsum and summe in the summarizer layout)
    and the eccv16 tvsum file, written by the JAX package."""
    root = tmp_path_factory.mktemp("dsnet")
    for i, name in enumerate(["tvsum", "summe", "ovp", "youtube"]):
        jsynthetic.make_synthetic_h5(
            str(root / JAX_PATH[name]), n_videos=4, min_picks=30,
            max_picks=90, feature_dim=FEATURES, seed=20 + i)
    jsynthetic.make_synthetic_h5(
        str(root / JAX_ECCV16_PATH["tvsum"]), n_videos=4, min_picks=30,
        max_picks=90, feature_dim=FEATURES, seed=30, layout="eccv16")
    return str(root)


def _assert_items_equal(got, want):
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert len(g) == len(w)
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[0].dtype == w[0].dtype == np.float32
        if len(w) == 3:
            gu, wu = g[2], w[2]
            assert (gu.name, gu.n_frames) == (wu.name, wu.n_frames)
            for field in ("user_summary", "change_points", "picks"):
                np.testing.assert_array_equal(getattr(gu, field),
                                              getattr(wu, field))
            if wu.user_scores is None:
                assert gu.user_scores is None
            else:
                np.testing.assert_array_equal(gu.user_scores, wu.user_scores)


@pytest.mark.parametrize("case", [
    dict(ex_dataset="tvsum", datasets="tvsum", split="val"),
    dict(ex_dataset="tvsum", datasets="tvsum", split="val",
         keys=["a/eccv16_dataset_tvsum_google_pool5.h5/video_3",
               "b/video_1"]),
    dict(ex_dataset="tvsum", datasets="tvsum", split="val",
         path_scheme="eccv16"),
    dict(ex_dataset="summe", datasets="summe+tvsum+ovp+youtube",
         split="train", keys=["x/video_0", "x/video_2"]),
    dict(ex_dataset="tvsum", datasets="tvsum+summe", split="train",
         min_frames=60),
], ids=["val", "val_keys", "val_eccv16", "train_plus_keys",
        "train_min_frames"])
def test_tsdataset_equals_jax(data_root, case):
    """Item for item: features and gtscore f32; in val the eval metadata
    (eccv16: no user_scores, picks flattened from (n, 1)). The train split
    restricts only the experiment dataset to the keys; min_frames drops
    short videos."""
    got = TSDataset(data_root, **case)
    want = JaxTSDataset(data_root, **case)
    _assert_items_equal(got, want)
    if case.get("path_scheme") == "eccv16":
        assert got[0][2].user_scores is None and got[0][2].picks.ndim == 1
    if case.get("min_frames"):
        n_all = len(TSDataset(data_root, "tvsum", "tvsum+summe",
                              split="train", min_frames=0))
        assert len(got) < n_all


@pytest.mark.parametrize("name", ["tvsum", "summe", "tvsum_aug",
                                  "summe_aug"])
def test_builtin_splits_equal_jax(name):
    path = splits.builtin_split_path(name)
    jpath = jsplits.builtin_split_path(name)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    folds = splits.load_splits(path)
    assert folds == jsplits.load_splits(jpath) and len(folds) == 5
    keys = folds[0]["test_keys"]
    assert (splits.split_keys_to_names(keys)
            == jsplits.split_keys_to_names(keys))
    assert all(n.startswith("video_")
               for n in splits.split_keys_to_names(keys))


def test_yaml_split_file_and_paths(tmp_path):
    folds = [{"train_keys": ["a/x.h5/video_1"], "test_keys": ["video_2"]}]
    path = tmp_path / "folds.yaml"
    path.write_text(yaml.safe_dump(folds))
    assert splits.load_splits(str(path)) == jsplits.load_splits(str(path))
    assert (paths.PATH, paths.ECCV16_PATH) == (JAX_PATH, JAX_ECCV16_PATH)
    assert paths.h5_name("summe", "eccv16") == JAX_ECCV16_PATH["summe"]


def test_segmentation_equals_jax():
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(120, 16)).astype(np.float32)
    feats[40:80] += 3.0
    for n, sec, fps in ((100, 2, 2), (7, 1, 3)):
        got = segmentation.uniform_segmentation(n, sec, fps)
        np.testing.assert_array_equal(got, jseg.uniform_segmentation(n, sec,
                                                                     fps))
        np.testing.assert_array_equal(segmentation.starts_to_bounds(got, n),
                                      jseg.starts_to_bounds(got, n))
    np.testing.assert_array_equal(segmentation.kts_seg(feats, 6, 1.0),
                                  jseg.kts_seg(feats, 6, 1.0))
    assert (segmentation.get_segment_fn("kts").__name__
            == jseg.get_segment_fn("kts").__name__ == "kts_seg")
    for mod in (segmentation, jseg):
        with pytest.raises(NotImplementedError):
            mod.get_segment_fn("shots")
        with pytest.raises(NotImplementedError):
            mod.kts_seg(feats, 6, 1.0, kernel="rbf")


def test_legacy_f1_score_equals_jax(data_root):
    rng = np.random.default_rng(4)
    scores = {}
    with h5py.File(os.path.join(data_root, JAX_ECCV16_PATH["tvsum"])) as f:
        for name in f:
            scores[name] = rng.random(f[name]["features"].shape[0])
    for method in ("avg", "max"):
        got = legacy_eval.f1_score(scores, data_root, "tvsum", method)
        want = jlegacy.f1_score(scores, data_root, "tvsum", method)
        assert got == want and 0.0 <= got <= 100.0


@pytest.mark.parametrize("kw", [
    dict(in_features=FEATURES, d_model=32, num_heads=4, num_layers=1),
    dict(d_model=256, num_heads=4, num_layers=4),
], ids=["tiny", "flagship"])
def test_count_params_equals_jax(kw):
    params = init_simnet(jax.random.PRNGKey(0), JaxModelConfig(**kw))
    model = SimNet(ModelConfig(**kw), device="cpu")
    assert count_params(model) == jax_count_params(params) > 0

"""The port's host-side shot selection (ops/summary.py, ops/kts.py,
ops/knapsack.py and the C++ eval runtime copy) against the JAX package's:
selected frames, change points, KTS costs and knapsack picks are bit-equal,
on the golden fixture and on a seeded fuzz, on the native and the NumPy
paths."""

import importlib
import json
import os

import numpy as np
import pytest

from vidsum_tpu.ops.kts import kts_segmentation as jax_kts_segmentation
from vidsum_tpu.ops.summary import generate_summary as jax_generate_summary
from vidsum_tpu.serve.dispatch import auto_segments as jax_auto_segments
from vidsum_tpu_torch import native
from vidsum_tpu_torch.ops import knapsack as port_knapsack
from vidsum_tpu_torch.ops import kts as port_kts
from vidsum_tpu_torch.ops.summary import generate_summary
from vidsum_tpu_torch.serve.dispatch import auto_segments
from tests.test_golden import GOLDEN, make_fixture

jax_knapsack = importlib.import_module("vidsum_tpu.ops.knapsack")
jax_kts = importlib.import_module("vidsum_tpu.ops.kts")


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Run a test on both packages' native paths, or on both NumPy paths."""
    if request.param == "native":
        assert native.available(), native.load_error()
    else:
        for mod, names in ((port_knapsack, ["_knapsack_native"]),
                           (port_kts, ["_calc_scatters_native",
                                       "_cpd_dp_native"]),
                           (jax_knapsack, ["_knapsack_native"]),
                           (jax_kts, ["_calc_scatters_native",
                                      "_cpd_dp_native"])):
            for name in names:
                monkeypatch.setattr(mod, name, None)
    return request.param


def _fuzz_videos(seed: int, count: int):
    """Videos in the golden fixture's layout, half of them with many tiny
    shots (the flavour that stresses knapsack ties)."""
    rng = np.random.default_rng(seed)
    videos = []
    for i in range(count):
        n_picks = int(rng.integers(20, 160))
        step = int(rng.integers(5, 20))
        picks = np.arange(n_picks) * step
        n_frames = int(picks[-1] + rng.integers(1, step + 1))
        scores = rng.random(n_picks).astype(np.float32)
        if i % 2:
            scores = np.round(scores * 4) / 4   # ties between shots
        n_shots = int(rng.integers(2, min(n_frames, 60 if i % 2 else 15)))
        cuts = np.sort(rng.choice(np.arange(1, n_frames), n_shots - 1,
                                  replace=False))
        bounds = np.concatenate([[0], cuts, [n_frames]])
        cp = np.stack([bounds[:-1], bounds[1:] - 1], axis=1)
        videos.append((picks, n_frames, scores, cp))
    return videos


def _summaries(fn, videos):
    return fn([v[3] for v in videos], [v[2] for v in videos],
              [v[1] for v in videos], [v[0] for v in videos])


def test_golden_selected_frames(path):
    got = {f"video_{i}": np.nonzero(s)[0].tolist()
           for i, s in enumerate(_summaries(generate_summary,
                                            make_fixture()))}
    with open(GOLDEN) as f:
        assert got == json.load(f)


def test_fuzzed_summaries_bit_equal_to_jax(path):
    videos = _fuzz_videos(2024, 50)
    got = _summaries(generate_summary, videos)
    want = _summaries(jax_generate_summary, videos)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_knapsack_picks_bit_equal_to_jax(path):
    rng = np.random.default_rng(11)
    for _ in range(40):
        n = int(rng.integers(1, 80))
        wt = rng.integers(0, 40, n)
        val = np.round(rng.random(n) * 8) / 8
        W = int(rng.integers(0, int(wt.sum()) + 2))
        assert (port_knapsack.knapsack(W, wt, val)
                == jax_knapsack.knapsack(W, wt, val))


@pytest.mark.parametrize("n", [30, 75, 160])
def test_kts_bit_equal_to_jax(path, n):
    rng = np.random.default_rng(n)
    feats = rng.normal(size=(n, 24))
    feats[n // 3:] += 2.0                       # a real change point
    K = feats @ feats.T
    cps, costs = port_kts.kts_segmentation(K, max(n // 10, 1), vmax=1.0)
    want_cps, want_costs = jax_kts_segmentation(K, max(n // 10, 1), vmax=1.0)
    np.testing.assert_array_equal(cps, want_cps)
    np.testing.assert_array_equal(costs, want_costs)
    np.testing.assert_array_equal(port_kts.calc_scatters(K),
                                  jax_kts.calc_scatters(K))


@pytest.mark.parametrize("n,n_frames", [(60, 60), (60, 181), (130, 977)])
def test_auto_segments_bit_equal_to_jax(path, n, n_frames):
    feats = np.random.default_rng(n_frames).random((n, 32), dtype=np.float32)
    np.testing.assert_array_equal(auto_segments(feats, n_frames),
                                  jax_auto_segments(feats, n_frames))


def test_native_library_is_the_ports_own():
    """The port builds its own copy of the runtime into its _build/ dir and
    never loads the JAX package's library."""
    from vidsum_tpu_torch.native import build

    assert native.available()
    path = build.lib_path()
    assert os.path.dirname(path).endswith(os.path.join("vidsum_tpu_torch",
                                                       "_build"))
    assert os.path.exists(path)

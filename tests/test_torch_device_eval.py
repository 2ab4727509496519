"""On-device shot selection of the port (ops/kts.py's device KTS,
ops/knapsack.knapsack_device, ops/device_eval.py) against the JAX package's
device functions and the host oracles: change points and penalised-count
picks equal, knapsack picks and selected frames bit-equal, on the JAX
tests' fixtures; ``eval_metrics(impl="device")`` and ``cli.train
--eval_impl device`` on the CPU."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from vidsum_tpu.data.paths import PATH as JAX_PATH
from vidsum_tpu.data.synthetic import make_synthetic_h5
from vidsum_tpu.ops.device_eval import (
    device_generate_summary as jax_device_summary,
)
from vidsum_tpu.ops.kts import (
    calc_scatters_jax, cpd_nonlin_jax, kts_segmentation_jax,
)
from vidsum_tpu.ops.summary import generate_summary as jax_host_summary
from vidsum_tpu_torch.cli import train as train_cli
from vidsum_tpu_torch.data.datasets import UserSummaries
from vidsum_tpu_torch.ops.device_eval import (
    device_eligible, device_generate_summary,
)
from vidsum_tpu_torch.ops.knapsack import knapsack, knapsack_device
from vidsum_tpu_torch.ops.kts import (
    calc_scatters, calc_scatters_device, cpd_nonlin, cpd_nonlin_device,
    kts_segmentation, kts_segmentation_device,
)
from vidsum_tpu_torch.ops.metrics import eval_metrics
from tests.oracles import knapsack_oracle
from tests.test_golden import GOLDEN, make_fixture
from tests.test_reference_differential import _random_video

DATA = os.path.join(os.path.dirname(__file__), "data")
# the JAX functions jitted (one compile each instead of one per eager op)
jax_scatters = jax.jit(calc_scatters_jax)
jax_cpd = jax.jit(cpd_nonlin_jax, static_argnames=("ncp",))
jax_kts = jax.jit(kts_segmentation_jax, static_argnames=("ncp", "vmax"))


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


def planted_features(rng, seg_lens, dim=16):
    """Piecewise-constant means: obvious change points."""
    return np.concatenate([rng.normal(size=dim) * 5
                           + 0.1 * rng.normal(size=(n, dim))
                           for n in seg_lens])


# ---------------------------------------------------------------------------
# device KTS
# ---------------------------------------------------------------------------

def test_calc_scatters_device_f32_against_jax():
    """f32: the JAX tests' own bound against numpy (rtol / atol 2e-3) holds
    against the JAX f32 scatters; cumulative sums differ in order."""
    rng = np.random.default_rng(13)
    f = rng.normal(size=(40, 8)).astype(np.float32)
    K = f @ f.T
    got = calc_scatters_device(torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_scatters(K)),
                               rtol=2e-3, atol=2e-3)


def test_calc_scatters_device_f64_against_numpy():
    """f64: within 1e-12 of the host scatters (measured: bit-equal)."""
    rng = np.random.default_rng(7)
    for n in (1, 2, 5, 17, 40):
        f = rng.normal(size=(n, 8))
        K = f @ f.T
        want = calc_scatters(K, use_native=False)
        got = calc_scatters_device(torch.from_numpy(K)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("segs,ncp", [((30, 25, 40, 20, 35), 12),
                                      ((8, 8, 8), 2), ((12, 9), 5)])
def test_kts_device_f32_matches_jax_and_host(segs, ncp):
    """Planted cuts, f32 Gram: change points and the selected count equal
    JAX's f32 device KTS and the f64 host's. Costs up to the selected count
    lie within 2e-3 relative of both (measured <= 6.1e-4). Past it the
    residual scatter is f32 rounding of the cumulative sums, of the order
    eps32 * sum|K| / n: every finite cost within twice that of JAX's f32
    costs (measured <= 0.94 of it)."""
    rng = np.random.default_rng(21)
    f = planted_features(rng, segs)
    K64 = f @ f.T
    K32 = K64.astype(np.float32)
    cps_h, costs_h = kts_segmentation(K64, ncp, vmax=1.0)
    cps_j, m_j, costs_j = jax_kts(K32, ncp=ncp, vmax=1.0)
    cps_d, m_d, costs_d = kts_segmentation_device(torch.from_numpy(K32), ncp,
                                                  vmax=1.0)
    m = int(m_d)
    assert m == int(m_j) == len(cps_h)
    np.testing.assert_array_equal(cps_d.numpy()[:m], cps_h)
    np.testing.assert_array_equal(cps_d.numpy(), np.asarray(cps_j))
    costs_j, costs_d = np.asarray(costs_j), costs_d.numpy()
    np.testing.assert_allclose(costs_d[: m + 1], costs_j[: m + 1], rtol=2e-3)
    np.testing.assert_allclose(costs_d[: m + 1], costs_h[: m + 1], rtol=2e-3)
    finite = np.isfinite(costs_j)
    np.testing.assert_array_equal(np.isfinite(costs_d), finite)
    scale = np.finfo(np.float32).eps * np.abs(K64).sum() / K64.shape[0]
    np.testing.assert_allclose(costs_d[finite], costs_j[finite], rtol=0,
                               atol=2 * scale)


def test_pipeline_device_kts_keeps_the_scenes_of_pool5_scale_features():
    """A deliberate divergence from the JAX pipeline: pool5 features share
    a large common component (norm 184 here, scene means ~3.5 apart), and
    the f32 cumulative sums of their raw Gram lose the scenes to rounding.
    JAX's device route (``vidsum_tpu/pipeline.py:_finish_video``, the raw
    f32 Gram) then takes the most change points it may; the port's
    ``shot_bounds(kts_impl="device")`` centres the features first, which
    leaves every scatter as it is in exact arithmetic, and finds the
    planted cuts that the f64 host oracle finds."""
    from vidsum_tpu_torch.pipeline import shot_bounds

    rng = np.random.default_rng(0)
    n, lens = 240, []
    while sum(lens) < n:
        lens.append(int(rng.integers(16, 64)))
    lens[-1] -= sum(lens) - n
    lens = [x for x in lens if x > 0]
    common = np.abs(rng.normal(size=1024))
    common *= 184 / np.linalg.norm(common)
    f = np.concatenate([common + 0.077 * rng.normal(size=1024)
                        + 0.02 * rng.normal(size=(x, 1024))
                        for x in lens]).astype(np.float32)
    planted = np.cumsum(lens)[:-1]
    host = shot_bounds(torch.from_numpy(f), "host")
    np.testing.assert_array_equal(host, planted)
    np.testing.assert_array_equal(shot_bounds(torch.from_numpy(f), "device"),
                                  host)
    ncp = n // 25
    _, m_j, _ = jax_kts(jax.numpy.asarray(f) @ jax.numpy.asarray(f).T,
                        ncp=ncp, vmax=1.0)
    assert int(m_j) == ncp > len(planted)


def test_kts_device_f64_matches_host():
    """The f64 route is the host's arithmetic: change points equal, costs
    within 1e-12 (measured: bit-equal)."""
    rng = np.random.default_rng(22)
    f = planted_features(rng, (30, 25, 40, 20, 35))
    K = f @ f.T
    cps_h, costs_h = kts_segmentation(K, 12, vmax=1.0)
    cps_d, m_d, costs_d = kts_segmentation_device(torch.from_numpy(K), 12,
                                                  vmax=1.0)
    np.testing.assert_array_equal(cps_d.numpy()[: int(m_d)], cps_h)
    assert not cps_d.numpy()[int(m_d):].any()
    np.testing.assert_allclose(costs_d.numpy(), costs_h, rtol=1e-12)


def test_kts_device_zero_change_points():
    rng = np.random.default_rng(12)
    f = rng.normal(size=(10, 4))
    K = f @ f.T
    cps, scores = cpd_nonlin_device(torch.from_numpy(K), 0)
    cps_h, scores_h = cpd_nonlin(K, 0)
    assert cps.numel() == 0 and scores.shape == (1,)
    np.testing.assert_allclose(scores.numpy(), scores_h, rtol=1e-12)
    cps_pad, m_best, costs = kts_segmentation_device(torch.from_numpy(K), 0,
                                                     vmax=1.0)
    assert cps_pad.numel() == 0 and int(m_best) == 0 and costs.shape == (1,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpd_device_ties_take_the_earliest_t(dtype):
    """Identical frames: every candidate split ties, and each DP step must
    keep the first minimum (the reference's earliest t), as numpy's and
    XLA's argmin do."""
    K = np.ones((24, 24))
    cps, scores = cpd_nonlin_device(torch.tensor(K, dtype=dtype), 4)
    cps_h, scores_h = cpd_nonlin(K, 4)
    np.testing.assert_array_equal(cps.numpy(), cps_h)
    np.testing.assert_array_equal(
        cps.numpy(), np.asarray(jax_cpd(K.astype(np.float32), ncp=4)[0]))
    np.testing.assert_array_equal(scores.numpy(), scores_h)


def test_cpd_device_with_length_bounds_matches_host():
    rng = np.random.default_rng(9)
    f = rng.normal(size=(30, 8))
    K = f @ f.T
    cps, scores = cpd_nonlin_device(torch.from_numpy(K), 3, lmin=3, lmax=15)
    cps_h, scores_h = cpd_nonlin(K, 3, lmin=3, lmax=15)
    np.testing.assert_array_equal(cps.numpy(), cps_h)
    np.testing.assert_allclose(scores.numpy(), scores_h, rtol=1e-12)


# ---------------------------------------------------------------------------
# device knapsack
# ---------------------------------------------------------------------------

def _picks(mask_row):
    return np.nonzero(np.asarray(mask_row))[0].tolist()


@pytest.mark.parametrize("W,wt,val", [
    (7, [2, 2, 1, 1, 1, 2], [4.0, 4.0, 2.0, 2.0, 2.0, 4.0]),   # textbook
    (0, [1, 2], [1.0, 2.0]),                                   # zero capacity
    (4, [2, 2, 2], [1.0, 1.0, 1.0]),                           # ties
])
def test_knapsack_device_cases(W, wt, val):
    mask = knapsack_device(W, torch.tensor([wt]),
                           torch.tensor([val], dtype=torch.float32))
    assert _picks(mask[0]) == knapsack(W, wt, val) == knapsack_oracle(W, wt,
                                                                      val)


def test_knapsack_device_batched_random_instances():
    """The JAX tests' 200 random instances as one batched call (zero-padded
    shots, per-video budgets inside one table width): bit-equal picks."""
    rng = np.random.default_rng(0)
    inst = []
    for _ in range(200):
        n = int(rng.integers(1, 30))
        wt = rng.integers(1, 15, size=n).tolist()
        val = [float(np.float32(v).item()) for v in rng.random(n)]
        inst.append((int(rng.integers(0, 40)), wt, val))
    S = max(len(w) for _, w, _ in inst)
    wt_pad = np.zeros((len(inst), S), np.int64)
    val_pad = np.zeros((len(inst), S), np.float32)
    for i, (_, wt, val) in enumerate(inst):
        wt_pad[i, : len(wt)] = wt
        val_pad[i, : len(val)] = val
    W = max(b for b, _, _ in inst)
    mask = knapsack_device(W, torch.from_numpy(wt_pad),
                           torch.from_numpy(val_pad),
                           budget=torch.tensor([b for b, _, _ in inst]))
    for i, (b, wt, val) in enumerate(inst):
        assert _picks(mask[i]) == knapsack(b, wt, val) == \
            knapsack_oracle(b, wt, val), i


# ---------------------------------------------------------------------------
# device summaries
# ---------------------------------------------------------------------------

def _random_dsnet(rng, n_videos, shots=(2, 40), picks=(8, 300),
                  steps=(5, 30)):
    out = []
    for _ in range(n_videos):
        n_picks = int(rng.integers(*picks))
        step = int(rng.integers(*steps))
        pk = np.arange(n_picks) * step
        n_frames = int(pk[-1] + rng.integers(1, step + 1))
        scores = rng.random(n_picks).astype(np.float32)
        n_shots = int(rng.integers(shots[0], min(shots[1], n_frames)))
        cuts = np.sort(rng.choice(np.arange(1, n_frames),
                                  min(n_shots - 1, n_frames - 1),
                                  replace=False))
        bnd = np.concatenate([[0], cuts, [n_frames]])
        out.append((pk, n_frames, scores,
                    np.stack([bnd[:-1], bnd[1:] - 1], axis=1)))
    return out


def _storm():
    """Many 1-3-frame shots with quantised scores: hundreds of knapsack
    items and dense exact ties (test_device_eval's storm)."""
    rng = np.random.default_rng(99)
    out = []
    for _ in range(12):
        n_picks = int(rng.integers(60, 140))
        step = int(rng.integers(4, 16))
        pk = np.arange(n_picks) * step
        n_frames = int(pk[-1] + rng.integers(1, step + 1))
        seg = int(rng.integers(1, 4))
        bounds = np.concatenate([np.arange(0, n_frames, seg), [n_frames]])
        cp = np.stack([bounds[:-1], bounds[1:] - 1], axis=1)
        scores = (rng.integers(0, 4, size=n_picks) / 4.0).astype(np.float32)
        out.append((pk, n_frames, scores, cp))
    return out


def _tie_video():
    d = np.load(os.path.join(DATA, "device_eval_tie_video.npz"))
    return [(d["picks"], int(d["n_frames"]), d["scores"], d["cp"])]


def _contract():
    """Eligible and ineligible flavours interleaved in one call."""
    rng = np.random.default_rng(42)
    return [_random_video(rng, fl) for fl in (
        "plain", "nonmono", "ties", "short_scores", "tiny_shots", "overhang",
        "plain", "nonmono")]


def _all_ineligible():
    rng = np.random.default_rng(7)
    return [_random_video(rng, "nonmono") for _ in range(3)]


FIXTURES = {
    "golden": (make_fixture, 0.15),
    "random40": (lambda: _random_dsnet(np.random.default_rng(2024), 40),
                 0.15),
    "storm": (_storm, 0.15),
    "tie_video": (_tie_video, 0.15),
    "tiny_budget": (lambda: [(np.arange(10) * 10, 100,
                              np.linspace(0.1, 0.9, 10).astype(np.float32),
                              np.asarray([[0, 49], [50, 99]]))], 0.01),
    "contract": (_contract, 0.15),
    "all_ineligible": (_all_ineligible, 0.15),
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_device_summary_bit_equal(name):
    """The port's device summaries equal the JAX host oracle's and the JAX
    device path's bit for bit; ineligible videos take the host oracle."""
    make, ratio = FIXTURES[name]
    videos = make()
    args = ([v[3] for v in videos], [v[2] for v in videos],
            [v[1] for v in videos], [v[0] for v in videos])
    got = device_generate_summary(*args, budget_ratio=ratio, device="cpu")
    host = jax_host_summary(*args, budget_ratio=ratio)
    dev = jax_device_summary(*args, budget_ratio=ratio)
    assert len(got) == len(host) == len(dev)
    for i, (g, h, d) in enumerate(zip(got, host, dev)):
        assert g.dtype == np.int8
        np.testing.assert_array_equal(g, h, err_msg=f"{name} video {i}")
        np.testing.assert_array_equal(g, np.asarray(d),
                                      err_msg=f"{name} video {i}")
    if name == "golden":
        with open(GOLDEN) as f:
            want = json.load(f)
        assert {f"video_{i}": np.nonzero(s)[0].tolist()
                for i, s in enumerate(got)} == want
    if name == "tiny_budget":
        assert got[0].sum() == 0
    if name == "contract":
        flags = [device_eligible(v[0], v[2], v[1]) for v in videos]
        assert flags == [True, False, True, False, True, False, True, False]


def test_eval_metrics_device_equals_host():
    """``eval_metrics(impl="device")`` gives the host route's F / tau / rho
    exactly; an unknown impl raises."""
    rng = np.random.default_rng(5)
    sd, ud = {}, {}
    for i in range(4):
        n_picks = int(rng.integers(30, 90))
        picks = np.arange(n_picks) * 15
        n_frames = int(picks[-1] + 7)
        bnd = np.concatenate([[0], np.sort(rng.choice(
            np.arange(1, n_frames), 6, replace=False)), [n_frames]])
        name = f"video_{i}"
        sd[name] = rng.random(n_picks).astype(np.float32)
        ud[name] = UserSummaries(
            user_summary=(rng.random((5, n_frames)) < 0.15).astype(np.int32),
            user_scores=rng.random((5, n_frames)).astype(np.float32),
            change_points=np.stack([bnd[:-1], bnd[1:] - 1], axis=1),
            n_frames=n_frames, picks=picks, name=name)
    host = eval_metrics(sd, ud, impl="host")
    dev = eval_metrics(sd, ud, impl="device", device="cpu")
    assert host == dev
    with pytest.raises(ValueError, match="eval impl"):
        eval_metrics(sd, ud, impl="tpu")


def test_cli_train_eval_impl_device(tmp_path, capsys):
    """``cli.train --eval_impl device`` runs on the CPU and prints the host
    run's F / tau / rho bit for bit (training is the same; the summaries are
    the host oracle's)."""
    make_synthetic_h5(str(tmp_path / JAX_PATH["tvsum"]), n_videos=4, seed=3)
    split = tmp_path / "splits.json"
    split.write_text(json.dumps([{
        "train_keys": [f"x.h5/video_{i}" for i in range(2)],
        "test_keys": ["x.h5/video_2", "x.h5/video_3"]}]))
    outs = []
    for impl in ("host", "device"):
        wd = tmp_path / impl
        wd.mkdir()
        train_cli.main(["--data", str(tmp_path), "--d_model", "32",
                        "--num_heads", "4", "--num_layers", "1",
                        "--batch_size", "2", "--max_epoch", "1",
                        "--split_path", str(split), "--workdir", str(wd),
                        "--eval_impl", impl], device="cpu")
        outs.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    assert outs[0] == outs[1]

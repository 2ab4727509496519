"""The PGL-SUM cell (``serve-pglsum-long``): its operation counts by hand,
its metric readers with nothing to read, its driver end to end at a tiny
width on the CPU, and on the card (marked ``cuda``) the program within the
cell's limits and the control, the reference in TF32 products, beyond
them, through ``calibrate._serving``. Run the card part with ``python -m
pytest benchmark/tests/test_bench_pglsum.py -q`` on a GPU machine."""

import json

import pytest
import torch

from benchmark import calibrate, flops_pglsum, harness
from benchmark.drivers import serve_pglsum
from benchmark.reference import pglsum as ref_pglsum
from benchmark.tests.conftest import tiny_traffic

CELL = "serve-pglsum-long"
METRICS = ("mfu_pglsum.serve", "pgl_attn_roofline.serve",
           "pgl_forward_ms.serve", "pgl_launches.serve")


def _config(**kw) -> dict:
    cfg = dict(harness.load_config("pglsum-1024"))
    cfg.update(kw)
    return cfg


def test_counts_by_hand():
    """T = 10 at d 8, 4 segments of 3, 3, 3, 1 rows: attention 4 * 8 * 100
    + 4 * 2 * (9 + 9 + 9 + 1); per row 10 * 64 + 8 * 8 * 2 + 2 * 8."""
    cfg = _config(in_features=8)
    assert flops_pglsum.segment_lengths(10, 4) == [3, 3, 3, 1]
    assert flops_pglsum.segment_lengths(3, 4) == [1, 1, 1, 0]
    assert flops_pglsum.segment_lengths(5, 4) == [2, 2, 1, 0]
    assert flops_pglsum.attention_forward(cfg, [10]) == 3200 + 224
    assert flops_pglsum.dense_forward(cfg, [10, 2]) == 12 * (640 + 128 + 16)
    assert flops_pglsum.model_forward(cfg, [10]) == 3424 + 10 * 784
    # the published width: attention ~ 4,352 T^2 at a T that 4 divides
    full = _config()
    assert flops_pglsum.attention_forward(full, [4000]) == (
        4096 * 4000 ** 2 + 1024 * 4 * 1000 ** 2)
    assert flops_pglsum.dense_forward(full, [1]) == pytest.approx(1.26e7,
                                                                  rel=2e-3)


def _run(record, summary, config=None):
    return harness.Run(config or _config(), {}, record, summary, setup_s=1.0)


def test_readers_with_nothing_to_read():
    empty = {"window_s": 1.0, "busy_s": 0.0, "ops": {}, "h2d_s": 0.0,
             "idle_gaps": []}
    rec = {"kind": "serve", "lengths": [], "traced_lengths": [5],
           "window_s": 1.0}
    for name in METRICS:
        reader = harness.load_metric(name)
        assert reader.read(_run(rec, None)) is None, name
        assert reader.read(_run({"kind": "train"}, empty)) is None, name
    # a trace without the biased kernel (the parent's program), or of
    # SimNet's serving kernels alone
    simnet_only = dict(empty, ops={"vs::attn::fma_fwd_kernel<64, 16, 8, "
                                   "true>": 0.5})
    assert harness.load_metric("pgl_attn_roofline.serve").read(
        _run(rec, simnet_only)) is None


def test_readers_by_hand():
    rec = {"kind": "serve", "lengths": [2, 3], "traced_lengths": [2, 3],
           "window_s": 0.5}
    got = harness.load_metric("mfu_pglsum.serve").read(_run(rec, None))
    assert got == pytest.approx(100 * flops_pglsum.model_forward(
        _config(), [2, 3]) / 0.5 / 67e12)
    summary = {"window_s": 1.0, "busy_s": 0.4, "h2d_s": 0.0,
               "idle_gaps": [],
               "ops": {"vs::attn::fma_fwd_posbias_kernel<128, 16, 4>": 1e-6,
                       "vs::attn::fma_fwd_posbias_kernel<64, 16, 8>": 1e-6,
                       "vs::attn::fma_fwd_kernel<64, 16, 8, true>": 5.0}}
    got = harness.load_metric("pgl_attn_roofline.serve").read(
        _run(rec, summary))
    least = flops_pglsum.attention_forward(_config(), [2, 3]) / 67e12
    assert got == pytest.approx(100 * least / 2e-6)


def _tiny(traffic: dict) -> dict:
    tr = tiny_traffic("serve-long")
    tr.update(driver="serve_pglsum", limits=traffic["limits"])
    return tr


def test_tiny_session_on_the_cpu_is_correct():
    """The driver end to end at 64 wide on the CPU (the dense route): a
    short window, then the check against the reference passes, and the
    program's counters are read."""
    cfg = _config(in_features=64, d_model=64, num_heads=2, local_heads=2)
    tr = _tiny(harness.load_traffic(CELL))
    session = serve_pglsum.Session(cfg, tr, 2**31 + 17, "cpu")
    rec = session.window(0.5, None)
    assert rec["attempted"] >= 1 and rec["failed"] == 0
    checks = session.check()
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert set(session.weights) == set(ref_pglsum.param_shapes(cfg))
    assert harness.load_metric("pgl_launches.serve").read(
        _run(rec, None, cfg)) is not None


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [303, 2**31 + 41])
def test_program_within_limits_control_beyond(seed):
    """At the cell's widths and lengths (fewer clients and checked
    requests, and a 3-s window): the served scores within the cell's
    ``scores`` limit, the summaries exact, none lost; the reference in
    TF32 products beyond the limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's hand-written kernels have "
                    "no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = dict(cell_readings(seed, clients=4, sample_checked=6))
    limits = harness.load_traffic(CELL)["limits"]
    print(json.dumps({"seed": seed, "readings": readings}))
    for name, limit in limits.items():
        assert readings["program"][name] <= limit, (name, readings)
    assert readings["program"]["lost"] == 0
    assert readings["control"]["scores"] > limits["scores"], readings


def cell_readings(seed: int, seconds: float = 3.0, **traffic_changes):
    """``calibrate._serving``'s readings (program and control) of one seed
    of the cell on the card: a ``seconds`` window at the cell's load."""
    config = harness.load_config("pglsum-1024")
    traffic = dict(harness.load_traffic(CELL), **traffic_changes)
    session = serve_pglsum.Session(config, traffic, seed, "cuda")
    session.window(seconds, None)
    readings = calibrate._serving(session, control=True)
    del session
    torch.cuda.empty_cache()
    return readings

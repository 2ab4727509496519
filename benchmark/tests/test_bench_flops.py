"""Operation counts, the trace reduction and the roofline arithmetic on
hand-worked shapes."""

import pytest

from benchmark import flops, harness, trace

CFG = {"in_features": 8, "d_model": 4, "num_heads": 2, "num_layers": 2,
       "mlp_scale": 4, "num_classes": 1}


def test_forward_counts_by_hand():
    # lengths 2 and 3: sum n = 5, sum n^2 = 13
    lens = [2, 3]
    # attention: L * 4 * d * sum n^2 = 2 * 4 * 4 * 13
    assert flops.attention_forward(CFG, lens) == 416
    # blocks: L * 2 * d^2 * (4 + 2 * 4) * sum n = 2 * 2 * 16 * 12 * 5
    assert flops.block_forward(CFG, lens) == 3840 + 416
    # embed 2 * 8 * 4 * 5, head 2 * 4 * 1 * 5
    assert flops.embed_forward(CFG, lens) == 320
    assert flops.head_forward(CFG, lens) == 40
    assert flops.model_forward(CFG, lens) == 320 + 4256 + 40


def test_train_counts_by_hand():
    lens = [2, 3]
    assert flops.block_train(CFG, lens) == 3 * 4256
    assert flops.attention_train(CFG, lens) == 3 * 416
    plain = 2 * 320 + 3 * 4256 + 3 * 40
    assert flops.train_step(CFG, lens) == plain
    # video transform 2 * 4 * 512 * 5 (forward and input gradient), the
    # losses 2 * 512 * n (n + 1) (forward and backward: 3x)
    vt = 2 * 4 * 512 * 5
    losses = 2 * 512 * (2 * 3 + 3 * 4)
    assert flops.train_step(CFG, lens, pretrain=True) == (
        plain + 2 * vt + 3 * losses)


def test_counts_ignore_padding():
    # a count depends on true lengths only, never on a bucket
    assert flops.model_forward(CFG, [100]) == flops.model_forward(CFG,
                                                                 [100.0])
    assert flops.attention_forward(CFG, []) == 0


@pytest.mark.parametrize("raw,want", [
    ("void fma_fwd_kernel<64, 16, 4>(float const*, float*, int)",
     "fma_fwd_kernel<64, 16, 4>"),
    ("bt_gemm_kernel(float const*)", "bt_gemm_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
    ("void (anonymous namespace)::bt_gemm_kernel<true>(float const*)",
     "bt_gemm_kernel<true>"),
])
def test_kernel_name(raw, want):
    assert trace.kernel_name(raw) == want


class _Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def _events():
    return [
        _Ev("void vs::attn::fma_fwd_kernel<64>(float*)", True, 0, 300_000),
        _Ev("void bt_gemm_kernel(float*)", True, 200_000, 200_000),
        _Ev("Memcpy HtoD (Pageable -> Device)", True, 1_000_000, 500_000),
        _Ev("aten::copy_", False, 450_000, 400_000),
        _Ev("bench.step", False, 0, 2_000_000),
        # the span mirrored on the device's timeline: not an operation
        _Ev("bench.step", True, 0, 2_000_000),
    ]


def test_reduce_events():
    s = trace.reduce_events(_events(), window_s=0.002)
    # busy: [0, 0.4 ms] and [1.0, 1.5 ms]
    assert s["busy_s"] == pytest.approx(0.9e-3)
    assert s["h2d_s"] == pytest.approx(0.5e-3)
    assert s["ops"]["vs::attn::fma_fwd_kernel<64>"] == pytest.approx(0.3e-3)
    assert "bench.step" not in s["ops"]
    # the gap 0.4-1.0 ms: at its middle the innermost host activity is
    # the copy (started at 0.45 ms) inside the step span
    assert s["idle_gaps"] == [("aten::copy_", pytest.approx(0.6e-3))]
    assert trace.kernel_seconds(
        s, [r"(^|::)fma_", r"(^|::)bt_"]) == pytest.approx(0.5e-3)
    b = trace.breakdown(s, top=2)
    assert [n for n, _ in b["device_ops"]] == [
        "Memcpy HtoD (Pageable -> Device)", "vs::attn::fma_fwd_kernel<64>"]


def _run(record, summary):
    cfg = dict(CFG)
    return harness.Run(cfg, {}, record, summary, setup_s=1.0)


def test_roofline_arithmetic():
    summary = trace.reduce_events(_events(), window_s=0.002)
    rec = {"kind": "serve", "traced_lengths": [2, 3]}
    got = harness.load_metric("attn_roofline.serve").read(
        _run(rec, summary))
    least = 416 / 67e12
    assert got == pytest.approx(100 * least / 0.3e-3)
    rec = {"kind": "train", "traced_steps": 2, "traced_lengths": [2, 3]}
    got = harness.load_metric("block_train_roofline.train").read(
        _run(rec, summary))
    assert got == pytest.approx(100 * 3 * 4256 / 67e12 / 0.5e-3)
    got = harness.load_metric("attn_train_roofline.train").read(
        _run(rec, summary))
    assert got == pytest.approx(100 * 3 * 416 / 67e12 / 0.3e-3)
    assert harness.load_metric("h2d_ms.train").read(
        _run(rec, summary)) == pytest.approx(0.25)
    assert harness.load_metric("device_idle_pct.train").read(
        _run(rec, summary)) == pytest.approx(55.0)


def test_readers_without_a_trace_read_nothing():
    rec = {"kind": "train", "traced_steps": 0, "traced_lengths": []}
    for name in ("block_train_roofline.train", "attn_train_roofline.train",
                 "h2d_ms.train", "device_idle_pct.train"):
        assert harness.load_metric(name).read(_run(rec, None)) is None
    empty = {"window_s": 1.0, "busy_s": 0.0, "ops": {}, "h2d_s": 0.0,
             "idle_gaps": []}
    rec = {"kind": "serve", "traced_lengths": [5]}
    assert harness.load_metric("attn_roofline.serve").read(
        _run(rec, empty)) is None
    assert harness.load_metric("device_idle_pct.serve").read(
        _run(rec, empty)) is None


def test_mfu_by_hand():
    rec = {"kind": "train", "steps": 1, "lengths": [2, 3],
           "window_s": 2.0, "pretrain": False}
    got = harness.load_metric("mfu.train").read(_run(rec, None))
    assert got == pytest.approx(100 * flops.train_step(CFG, [2, 3])
                                / 2.0 / 67e12)
    rec = {"kind": "serve", "lengths": [2, 3], "window_s": 0.5}
    got = harness.load_metric("mfu.serve").read(_run(rec, None))
    assert got == pytest.approx(100 * flops.model_forward(CFG, [2, 3])
                                / 0.5 / 67e12)


def test_end_to_end_readers():
    rec = {"kind": "serve", "lengths": [100, 300], "window_s": 2.0,
           "latency_s": [0.01 * i for i in range(1, 101)],
           "submit_s": [0.001, 0.003], "batches": 4, "rows_scored": 6}
    run = _run(rec, None)
    assert harness.load_metric("serve_frames_per_s").read(run) == 200.0
    assert harness.load_metric("serve_p95_ms").read(run) == pytest.approx(
        950.5)
    assert harness.load_metric("submit_ms.serve").read(run) == \
        pytest.approx(2.0)
    assert harness.load_metric("batch_rows.serve").read(run) == 1.5
    assert harness.load_metric("setup_s").read(run) == 1.0
    assert harness.load_metric("train_frames_per_s").read(run) is None

"""The port's span recorder (``utils.profiling``): spans are kept from any
thread only while a ``torch.profiler`` profile runs, on the profiler's host
clock; the serving path's spans tile each request's latency and the
training steps' spans tile the step. The card test (marked ``cuda``) holds
the clock to the profiler's CUDA trace and times a span site; run it with
``python -m pytest tests/test_torch_tracing.py -q -rA`` on a GPU machine.
This file imports no JAX."""

import threading
import time
from collections import defaultdict, deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vidsum_tpu_torch.config import ModelConfig, PretrainConfig
from vidsum_tpu_torch.models.pretrain import VIDEO_REP_DIM, PretrainModel
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.serve import ScoringService
from vidsum_tpu_torch.train.steps import (
    make_finetune_step, make_optimizer, make_pretrain_step,
)
from vidsum_tpu_torch.utils import profiling

CFG = ModelConfig(in_features=32, d_model=32, num_heads=2, num_layers=1,
                  max_len=512)


@pytest.fixture(autouse=True)
def _fresh_buffer():
    profiling.clear()
    yield
    profiling.clear()


def _by_name(records):
    out = defaultdict(list)
    for s in records:
        out[s.name].append(s)
    return out


def _in_thread(fn):
    t = threading.Thread(target=fn, name="worker")
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()


def test_worker_spans_kept_only_under_a_profiler():
    def work(name):
        def run():
            with profiling.span(name):
                pass
            t0 = profiling.stamp()
            profiling.record_span(name + ".cross", t0, profiling.stamp())
        return run

    _in_thread(work("before"))
    assert profiling.spans() == []
    assert profiling.stamp() is None
    assert profiling.span("off") is profiling.span("off also")
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.stamp() is not None
        _in_thread(work("during"))
        opened = profiling.stamp()
    _in_thread(work("after"))
    profiling.record_span("straddles", opened, profiling.stamp())
    kept = profiling.spans()
    assert [s.name for s in kept] == ["during", "during.cross"]
    assert all(s.thread == "worker" and s.dur_ns >= 0 for s in kept)
    assert abs(kept[0].start_ns - time.time_ns()) < 60e9


def test_buffer_is_bounded_and_counts_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "_buffer", deque(maxlen=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(6):
            profiling.record_span(f"s{i}", i, i + 1)
    assert [s.name for s in profiling.spans()] == ["s2", "s3", "s4", "s5"]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_main_thread_span_on_the_profiler_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with profiling.span(f"probe{i}"):
                torch.ones(64).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for s in profiling.spans():
        ev = events[s.name]
        assert abs(s.start_ns - ev.start_ns()) < 1_000_000, s


def test_service_spans_tile_each_request():
    """Two clients, four requests of 128-384 rows on a CPU service: each
    request's queue, batch, select_wait and select spans add up to its
    ``ServeResult.latency_s`` within 1 ms."""
    model = SimNet(CFG, device="cpu")
    rng = np.random.default_rng(3)
    videos = [rng.normal(size=(n, CFG.in_features)).astype(np.float32)
              for n in (128, 200, 300, 384)]
    threads_before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ScoringService(model, CFG, device="cpu", attn_impl="dense",
                            max_batch=4, max_delay_ms=5.0) as svc:
            results = {}
            real_complete = svc._complete

            def complete(r, res):
                results[r.span_id] = res
                real_complete(r, res)

            svc._complete = complete

            def client(c):
                for v in videos[c::2]:
                    svc.submit(v).result(timeout=120)

            with profile(activities=[ProfilerActivity.CPU]):
                threads = [threading.Thread(target=client, args=(c,))
                           for c in range(2)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        torch.set_num_threads(threads_before)
    got = _by_name(profiling.spans())
    assert len(results) == 4 and None not in results
    batches = {s.id: s for s in got["serve.batch"]}
    assert got["serve.idle"]
    for rid, res in results.items():
        mine = {name: [s for s in got[name] if s.id == rid]
                for name in ("serve.stage", "serve.queue",
                             "serve.select_wait", "serve.select")}
        assert all(len(v) == 1 for v in mine.values()), mine
        queue = mine["serve.queue"][0]
        batch = batches[queue.parent]
        assert mine["serve.select"][0].parent == batch.id
        assert queue.start_ns + queue.dur_ns == batch.start_ns
        assert mine["serve.stage"][0].start_ns + mine["serve.stage"][0] \
            .dur_ns == queue.start_ns
        total = (queue.dur_ns + batch.dur_ns
                 + mine["serve.select_wait"][0].dur_ns
                 + mine["serve.select"][0].dur_ns)
        assert abs(total / 1e9 - res.latency_s) < 1e-3, (total, res)


def _tiles(step_spans):
    """One step whose transfer and compute follow each other inside it
    (what lies between them is the spans' own entry and exit)."""
    got = _by_name(step_spans)
    assert [len(got[n]) for n in ("train.step", "train.transfer",
                                  "train.compute")] == [1, 1, 1]
    step, = got["train.step"]
    move, = got["train.transfer"]
    comp, = got["train.compute"]
    assert move.parent == comp.parent == step.id == move.id == comp.id
    assert step.parent is None
    assert step.start_ns <= move.start_ns
    assert move.start_ns + move.dur_ns <= comp.start_ns
    assert comp.start_ns + comp.dur_ns <= step.start_ns + step.dur_ns


def test_training_steps_give_transfer_and_compute():
    rng = np.random.default_rng(0)
    B, N = 2, 128
    x = rng.normal(size=(B, N, CFG.in_features)).astype(np.float32)
    mask = np.zeros((B, N), bool)
    mask[1, 100:] = True
    model = SimNet(CFG, device="cpu")
    step = make_finetune_step(CFG, "dense", device="cpu")
    opt = make_optimizer(model, 1e-3)
    target = rng.random((B, N)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, opt, x, target, mask, torch.Generator().manual_seed(1))
    _tiles(profiling.spans())
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"train.step", "train.transfer", "train.compute"} <= names

    profiling.clear()
    pcfg = PretrainConfig(batch_size=B)
    pmodel = PretrainModel(CFG, pcfg, device="cpu")
    pstep = make_pretrain_step(CFG, pcfg, lambda n: 1e-3, "dense",
                               device="cpu")
    popt = make_optimizer([("encoder." + n, p) for n, p in
                           pmodel.encoder.named_parameters()], 1e-3)
    reps = rng.normal(size=(B, VIDEO_REP_DIM)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]):
        pstep(pmodel, popt, x, reps, mask, torch.Generator().manual_seed(2))
    _tiles(profiling.spans())


@pytest.mark.cuda
def test_span_on_the_card_clock_and_its_cost():
    """On the card: a main-thread span's start lies within 0.1 ms of its
    profiler event's; a span site costs at most 1 us with tracing off.
    Prints the cost of each kind of site, on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the profiler's CUDA trace")
    x = torch.ones(1 << 16, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(8):
            with profiling.span(f"card{i}"):
                x.sum()
        torch.cuda.synchronize()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    gaps = [abs(s.start_ns - events[s.name].start_ns())
            for s in profiling.spans()]
    assert len(gaps) == 8 and max(gaps) < 100_000, gaps

    def per_call(fn, n=200_000):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        return (time.perf_counter_ns() - t0) / n

    def span_site():
        with profiling.span("s"):
            pass

    def stamp_site():
        profiling.record_span("s", profiling.stamp(), profiling.stamp())

    off = {"span": per_call(span_site), "stamps": per_call(stamp_site)}
    on = {}
    with profile(activities=[ProfilerActivity.CPU]):
        on["span_main_thread"] = per_call(span_site, 20_000)
        profiling.clear()
        box = {}
        _in_thread(lambda: box.update(
            span=per_call(span_site, 20_000),
            stamps=per_call(stamp_site, 20_000)))
    on.update({k + "_worker": v for k, v in box.items()})
    print(f"span site ns, off: {off}; on: {on}")
    assert max(off.values()) <= 1000, off

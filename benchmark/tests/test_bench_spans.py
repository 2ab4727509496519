"""The per-layer metrics that read the program's own spans
(``benchmark/program_spans.py``): each reader gives the expected number
from planted spans, nothing on an untraced run, on a cell of the other
kind or with a program that has no span recorder; and a traced tiny run
of each cell on the CPU reports every one of its span metrics."""

import pytest

from benchmark import harness
from benchmark.tests.conftest import tiny_config, tiny_traffic
from vidsum_tpu_torch.utils import profiling

SERVE = {"stage_ms.serve": "serve.stage", "queue_ms.serve": "serve.queue",
         "batch_ms.serve": "serve.batch",
         "select_wait_ms.serve": "serve.select_wait",
         "select_ms.serve": "serve.select"}
TRAIN = {"transfer_host_ms.train": "train.transfer",
         "compute_host_ms.train": "train.compute"}
SPAN_METRICS = sorted(SERVE) + sorted(TRAIN) + ["dispatch_idle_pct.serve"]


class FakeRun:
    def __init__(self, kind, trace=True):
        self.record = {"kind": kind}
        self.trace = {"window_s": 4.0} if trace else None


def _planted(name, durations_ms):
    return [profiling.Span(name, i, None, "t", 10**18 + i, int(ms * 1e6))
            for i, ms in enumerate(durations_ms)]


@pytest.fixture
def plant(monkeypatch):
    def put(spans):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    return put


@pytest.mark.parametrize("metric", sorted({**SERVE, **TRAIN}))
def test_mean_ms_readers(metric, plant):
    span = {**SERVE, **TRAIN}[metric]
    kind = "serve" if metric in SERVE else "train"
    other = "train" if kind == "serve" else "serve"
    reader = harness.load_metric(metric)
    assert reader.UNIT == "ms"
    plant(_planted(span, [1.0, 2.0, 6.0]) + _planted("other.span", [50.0]))
    assert reader.read(FakeRun(kind)) == pytest.approx(3.0)
    assert reader.read(FakeRun(kind, trace=False)) is None
    assert reader.read(FakeRun(other)) is None
    plant(_planted("other.span", [50.0]))
    assert reader.read(FakeRun(kind)) is None


def test_dispatch_idle_pct_reader(plant):
    reader = harness.load_metric("dispatch_idle_pct.serve")
    assert reader.UNIT == "%"
    plant(_planted("serve.idle", [500.0, 1500.0, 0.0])
          + _planted("serve.queue", [900.0]))
    assert reader.read(FakeRun("serve")) == pytest.approx(50.0)
    assert reader.read(FakeRun("serve", trace=False)) is None
    assert reader.read(FakeRun("train")) is None
    plant([])
    assert reader.read(FakeRun("serve")) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_program_without_the_recorder_gives_nothing(metric, monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    kind = "train" if metric.endswith(".train") else "serve"
    assert harness.load_metric(metric).read(FakeRun(kind)) is None


@pytest.mark.parametrize("cell", ["serve-long", "pretrain-b256",
                                  "finetune-long"])
def test_traced_tiny_run_reports_its_span_metrics(cell):
    spec = harness.load_spec()
    entry = harness.find_cell(spec, cell)
    names = [m["name"] for m in harness.cell_metrics(spec, cell, True)]
    mine = [n for n in names if n in SPAN_METRICS]
    assert len(mine) == (6 if cell == "serve-long" else 2)
    profiling.clear()
    try:
        res = harness.run_cell(tiny_config(entry["config"]),
                               tiny_traffic(cell), mine, 13, 1.0, True,
                               "cpu", 0.0)
    finally:
        profiling.clear()
    assert res["correct"], res["checks"]
    assert sorted(res["metrics"]) == sorted(mine)
    assert all(m["value"] >= 0 for m in res["metrics"].values())

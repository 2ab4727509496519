"""The program's own spans in the traced part of a ``--trace 1`` run, for
the per-layer metrics that read them: the port's span recorder
(``vidsum_tpu_torch.utils.profiling``) keeps a span, from any thread, only
while the benchmark's profiler runs. A program without the recorder, an
untraced run and a cell of the other kind give nothing."""

from __future__ import annotations

from typing import List, Optional


def durations_ms(run, kind: str, name: str) -> Optional[List[float]]:
    """Milliseconds of every kept span called ``name`` in a traced run of a
    ``kind`` cell (``serve`` or ``train``); None where there is none."""
    if run.trace is None or run.record["kind"] != kind:
        return None
    try:
        from vidsum_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    ms = [s.dur_ns / 1e6 for s in read() if s.name == name]
    return ms or None


def mean_ms(run, kind: str, name: str) -> Optional[float]:
    ms = durations_ms(run, kind, name)
    return None if ms is None else sum(ms) / len(ms)

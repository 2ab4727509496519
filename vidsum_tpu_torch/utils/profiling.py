# ported from vidsum_tpu/utils/profiling.py
"""Tracing and step timing.

- :func:`trace` -- context manager around ``torch.profiler.profile`` (CPU
  activity, plus CUDA when a card is present) that writes a Chrome trace
  (``trace.json``, loadable in Perfetto or ``chrome://tracing``) into
  ``log_dir``; the JAX package's ``jax.profiler`` trace.
- :class:`StepTimer` -- per-step wall-clock accumulator with a percentile
  summary.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the enclosed block into ``log_dir/trace.json`` (no-op when
    ``log_dir`` is None or empty)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    def __init__(self) -> None:
        self.durations: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        assert self._t0 is not None
        self.durations.append(time.perf_counter() - self._t0)
        self._t0 = None

    def summary(self) -> Dict[str, float]:
        if not self.durations:
            return {}
        d = sorted(self.durations)
        n = len(d)
        return {
            "steps": n,
            "mean_s": sum(d) / n,
            "p50_s": d[n // 2],
            "p90_s": d[min(int(n * 0.9), n - 1)],
            "max_s": d[-1],
        }

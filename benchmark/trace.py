"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over the
first ``trace_seconds`` of the measured window (CPU and CUDA activity), and
its reduction to what the per-layer metrics read: device time by kernel
name, host-to-device copy time, the device's busy seconds, and the idle
gaps with what the host was doing in them.

The raw Kineto events are read directly; the profiler's own per-op
function-event tables are never built, which keeps a trace of a few
hundred thousand events cheap to reduce.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

# idle gaps shorter than this are launch spacing, not waiting
MIN_GAP_NS = 10_000


def kernel_name(raw: str) -> str:
    """A kernel's function name with its template arguments, without the
    return type and parameter list."""
    name = raw[5:] if raw.startswith("void ") else raw
    name = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut].strip()


def _ns(ev, what: str) -> int:
    fn = getattr(ev, what + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, what + "_us")() * 1000)


class Tracer:
    """Profiles from :meth:`start` until :meth:`stop` (which synchronises
    the device first) and keeps the reduced trace in :attr:`summary`."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.summary: Optional[dict] = None
        self._prof = None
        self._t0 = 0.0

    def prepare(self) -> None:
        """Start and stop the profiler once: its first start in a process
        initialises the device tracing (seconds), which must not fall into
        the window."""
        self.start()
        self._prof.__exit__(None, None, None)
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def due(self) -> bool:
        return (self._prof is not None
                and time.perf_counter() - self._t0 >= self.seconds)

    def stop(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        events = prof.profiler.kineto_results.events()
        self.summary = reduce_events(events, window_s)


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce_events(events, window_s: float) -> dict:
    """``{"window_s", "busy_s", "ops": {name: s}, "h2d_s", "idle_gaps":
    [(host activity, s), ...]}`` from raw Kineto events. Every event on the
    device (a kernel, a copy, a memset) is an operation; busy time is the
    union of their intervals. Host events are the CPU's ops, spans and
    runtime calls."""
    device: List[Tuple[int, int]] = []
    ops: Dict[str, float] = defaultdict(float)
    h2d_ns = 0
    host: List[Tuple[int, int, str]] = []
    on_device = []
    for ev in events:
        s = _ns(ev, "start")
        d = _ns(ev, "duration")
        name = ev.name()
        if str(ev.device_type()).endswith("CUDA"):
            on_device.append((ev, s, d, name))
        else:
            host.append((s, s + d, name))
    # a span recorded on the host (``record_function``) is mirrored on the
    # device's timeline over the kernels it launched: not an operation
    spans = {h[2] for h in host}
    for ev, s, d, name in on_device:
        annotation = getattr(ev, "is_user_annotation", None)
        if name in spans or (annotation is not None and annotation()):
            continue
        device.append((s, s + d))
        copy = name.startswith(("Memcpy", "Memset"))
        ops[name if copy else kernel_name(name)] += d / 1e9
        if copy and "HtoD" in name:
            h2d_ns += d
    busy = _merge(device)
    busy_ns = sum(e - s for s, e in busy)
    return {"window_s": window_s, "busy_s": busy_ns / 1e9, "ops": dict(ops),
            "h2d_s": h2d_ns / 1e9,
            "idle_gaps": _gaps_by_host(busy, host)}


def _gaps_by_host(busy: List[Tuple[int, int]],
                  host: List[Tuple[int, int, str]]) -> List[Tuple[str, float]]:
    """Idle gaps between device operations, summed by the innermost host
    activity (the latest-starting op or span of any thread) that covers
    each gap's middle."""
    host.sort()
    starts = [h[0] for h in host]
    by: Dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gap = s1 - e0
        if gap < MIN_GAP_NS:
            continue
        mid = e0 + gap // 2
        name = "(no host activity)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 256, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        by[name] += gap / 1e9
    return sorted(by.items(), key=lambda kv: -kv[1])


def kernel_seconds(summary: dict, patterns) -> float:
    """Device seconds of the kernels whose name matches any regex."""
    rx = [re.compile(p) for p in patterns]
    return sum(s for name, s in summary["ops"].items()
               if any(r.search(name) for r in rx))


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in summary["idle_gaps"][:top]]}

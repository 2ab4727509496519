# ported from vidsum_tpu/utils/profiling.py
"""Tracing: the profiler's trace and the program's own spans.

- :func:`trace` -- context manager around ``torch.profiler.profile`` (CPU
  activity, plus CUDA when a card is present) that writes a Chrome trace
  (``trace.json``, loadable in Perfetto or ``chrome://tracing``) into
  ``log_dir``; the JAX package's ``jax.profiler`` trace.
- The span recorder: :func:`span` (a context manager) and
  :func:`record_span` (a span that opens on one thread and closes on
  another, from two :func:`stamp` readings) keep :class:`Span` records in
  one bounded, thread-safe, process-wide buffer that :func:`spans` reads.

A span is kept only while a ``torch.profiler`` profile is active in any
thread of the process (``torch.autograd.profiler._is_profiler_enabled``),
both when it opens and when it closes. The profiler itself records ops
only on the thread that started it; the recorder sees every thread. Off,
a span site costs one read of that flag. Starts are Unix-epoch
nanoseconds, the clock of the profiler's host events; durations come
from ``time.perf_counter_ns``. Where the profiler also runs on the
current thread, :func:`span` opens a ``record_function`` range of its
name, so the span enters the profiler's own trace too.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

MAXLEN = 1 << 17

# the profiler's light ``record_function`` (a C++ range, no script object;
# its first call costs ~50 us where ``record_function``'s costs ~1 ms)
_Range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)

# perf_counter_ns + this = Unix-epoch ns: one monotonic clock for starts
# and durations, on the profiler's host clock
_EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


class Span(NamedTuple):
    name: str
    id: Optional[int]          # spans of one request or step share it
    parent: Optional[int]      # the id of the batch or step it belongs to
    thread: str
    start_ns: int              # Unix-epoch ns (the profiler's host clock)
    dur_ns: int


_lock = threading.Lock()
_buffer: deque = deque(maxlen=MAXLEN)
_dropped = 0
_ids = itertools.count(1)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the enclosed block into ``log_dir/trace.json`` (no-op when
    ``log_dir`` is None or empty)."""
    if not log_dir:
        yield
        return
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


# ------------------------------------------------------------ the recorder

def now_ns() -> int:
    """Unix-epoch nanoseconds, read from the monotonic clock."""
    return time.perf_counter_ns() + _EPOCH_OFFSET_NS


def stamp() -> Optional[int]:
    """:func:`now_ns` while spans are kept, else None: a boundary of a span
    that :func:`record_span` closes later, perhaps on another thread."""
    return now_ns() if _autograd_profiler._is_profiler_enabled else None


def new_id() -> int:
    return next(_ids)


def _keep(name, id, parent, start_ns, end_ns) -> None:
    global _dropped
    rec = Span(name, id, parent, threading.current_thread().name, start_ns,
               end_ns - start_ns)
    with _lock:
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1
        _buffer.append(rec)


def record_span(name: str, start_ns: Optional[int], end_ns: Optional[int],
                id: Optional[int] = None,
                parent: Optional[int] = None) -> None:
    """Keep a span between two :func:`stamp` readings; nothing when either
    is None (spans were not kept then) or when spans are not kept now."""
    if (start_ns is not None and end_ns is not None
            and _autograd_profiler._is_profiler_enabled):
        _keep(name, id, parent, start_ns, end_ns)


class _Open:
    __slots__ = ("name", "id", "parent", "_start", "_rf")

    def __init__(self, name, id, parent):
        self.name = name
        self.id = new_id() if id is None else id
        self.parent = parent

    def __enter__(self):
        self._rf = None
        if torch._C._autograd._profiler_enabled():
            # the profiler runs on this thread: enter its trace too
            self._rf = _Range(self.name)
            self._rf.__enter__()
        self._start = now_ns()
        return self

    def __exit__(self, *exc):
        end = now_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        record_span(self.name, self._start, end, self.id, self.parent)
        return False


class _Off:
    """What :func:`span` gives while spans are not kept."""
    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, id: Optional[int] = None, parent: Optional[int] = None):
    """Context manager: keep a span of ``name`` over the block. ``id``
    defaults to a fresh one, which the ``with`` target's ``id`` gives to
    child spans (None while spans are not kept)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, id, parent)


def spans() -> List[Span]:
    """The kept spans, oldest first."""
    with _lock:
        return list(_buffer)


def dropped() -> int:
    """Spans pushed out of the full buffer."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _buffer.clear()
        _dropped = 0

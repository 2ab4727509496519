# ported from vidsum_tpu/serve/admission.py
"""Admission control and request-slot lifecycle.

Every request passes through exactly one admission decision at
``submit()`` time (length caps, then the ``max_queue_depth`` bound — both
BEFORE any host-side padding or device transfer) and, if admitted,
through exactly one resolution (:func:`complete` / :func:`fail`), which
releases the admission slot. The slot count (``svc._inflight``) is the
device-HBM high-water mark ``max_queue_depth`` bounds: each admitted
request pins one padded feature row on device by design (the async
transfer overlaps earlier batches' compute)."""

from __future__ import annotations

import logging
import time
from concurrent.futures import InvalidStateError

from vidsum_tpu_torch.serve.types import (
    DeadlineExceeded, RequestTooLong, ServeResult, ServiceOverloaded,
    _Request,
)

logger = logging.getLogger(__name__)

_RSS_CACHE = {"t": 0.0, "mb": 0.0}
_RSS_MAX_AGE_S = 0.5
_last_watermark_log = [0.0]


def process_rss_mb(max_age_s: float = _RSS_MAX_AGE_S) -> float:
    """This process's resident set size in MB, cached for ``max_age_s`` so
    per-submit watermark checks don't re-read /proc on every request."""
    now = time.monotonic()
    if now - _RSS_CACHE["t"] > max_age_s:
        mb = 0.0
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        mb = int(line.split()[1]) / 1024.0
                        break
        except OSError:
            pass
        _RSS_CACHE["t"] = now
        _RSS_CACHE["mb"] = mb
    return _RSS_CACHE["mb"]


def _check_rss_watermark(svc) -> None:
    """Shed load when host RSS is past the operator watermark. The JAX
    package added this knob against a host leak of its TPU relay client;
    the port keeps it so an operator can bound host memory, and has not
    measured a leak on the GPU. Rejecting with 503 keeps the process alive
    for its load balancer to drain."""
    if svc.rss_watermark_mb is None:
        return
    rss = process_rss_mb()
    if rss <= svc.rss_watermark_mb:
        return
    with svc._lock:
        svc._stats["rejected"] += 1
    now = time.monotonic()
    if now - _last_watermark_log[0] > 10.0:   # loud but not per-request
        _last_watermark_log[0] = now
        logger.warning(
            "host RSS %.0f MB exceeds rss_watermark_mb=%.0f — shedding "
            "load until RSS falls or the worker is recycled", rss,
            svc.rss_watermark_mb)
    raise ServiceOverloaded(
        f"host RSS {rss:.0f} MB exceeds rss_watermark_mb="
        f"{svc.rss_watermark_mb:.0f}; load shed until the worker is "
        f"recycled or RSS falls")


def admit(svc, n: int, long: bool = False) -> None:
    """Gate one request: reject on length caps / overload, else reserve an
    admission slot (released by :func:`complete`/:func:`fail`, or by the
    caller if the submit-time transfer fails)."""
    cap = svc._long_cap if long else svc._short_cap
    if svc.max_request_len is not None and (
            cap is None or svc.max_request_len < cap):
        cap = svc.max_request_len
    if cap is not None and n > cap:
        with svc._lock:
            svc._stats["rejected"] += 1
        route = ("sequence-parallel ring" if long
                 else "single-chip kernel ladder")
        raise RequestTooLong(
            f"request has {n} feature rows but the {route} on this "
            f"service carries at most {cap}"
            + ("" if svc.max_request_len is None
               else f" (max_request_len={svc.max_request_len})"))
    _check_rss_watermark(svc)
    with svc._lock:
        if svc._closed:
            raise RuntimeError("service is closed")
        if svc._inflight >= svc.max_queue_depth:
            svc._stats["rejected"] += 1
            raise ServiceOverloaded(
                f"{svc._inflight} admitted requests are unresolved "
                f"(max_queue_depth={svc.max_queue_depth}); retry "
                f"after the backlog drains")
        svc._inflight += 1   # reserve the slot; released by
        svc._stats["requests"] += 1  # complete/fail on resolution


def release_failed_submit(svc) -> None:
    """Roll back :func:`admit`'s reservation when the submit-time padding
    or device transfer raised (the request never reached the queue)."""
    with svc._lock:
        svc._inflight -= 1
        svc._stats["requests"] -= 1


# ------------------------------------------------------ slot resolution
# Every admitted request resolves through exactly one of these: they
# release the admission slot and tolerate caller-cancelled futures
# (set_* on a CANCELLED future raises InvalidStateError; swallowing it
# keeps one cancelled rider from stranding the rest of its batch).

def complete(svc, r: _Request, res: ServeResult) -> None:
    with svc._lock:
        svc._stats["completed"] += 1
        svc._latencies.append(res.latency_s)
        svc._inflight -= 1
    try:
        r.future.set_result(res)
    except InvalidStateError:
        pass


def fail(svc, r: _Request, exc: BaseException, stat: str = "failed") -> None:
    with svc._lock:
        svc._stats[stat] += 1
        svc._inflight -= 1
    try:
        r.future.set_exception(exc)
    except InvalidStateError:
        pass


def expire_if_late(svc, r: _Request) -> bool:
    """Deadline check at dispatch time; True = dropped (never reaches
    the accelerator)."""
    if r.deadline is None or time.monotonic() <= r.deadline:
        return False
    fail(svc, r, DeadlineExceeded(
        f"deadline elapsed {time.monotonic() - r.deadline:.3f}s before "
        f"dispatch"), stat="expired")
    return True

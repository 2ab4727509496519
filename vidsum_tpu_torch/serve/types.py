# ported from vidsum_tpu/serve/types.py
"""Serving data types: request/result records, stats, admission errors.

Shared vocabulary of the serving package (``vidsum_tpu_torch/serve/``): the
public result/stats dataclasses and admission-control exceptions, plus the
internal queued-request record the dispatcher consumes. No accelerator
code lives here. The reference has no serving analogue (its closest path
is the offline val loop, ``src/train.py:134-152``)."""

from __future__ import annotations

import dataclasses
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np


class ServiceOverloaded(RuntimeError):
    """``submit()`` rejected: ``max_queue_depth`` requests are already
    admitted and unresolved. Retry after the backlog drains (HTTP 503)."""


class RequestTooLong(ValueError):
    """``submit()`` rejected: no compiled path on this service can carry a
    sequence this long (single-chip kernel envelope, and the sequence-
    parallel ring route is absent or disabled)."""


class DeadlineExceeded(TimeoutError):
    """The request's ``deadline_s`` elapsed before the dispatcher reached
    it; it was dropped without being sent to the accelerator."""


@dataclasses.dataclass
class ServeResult:
    """One request's outcome.

    ``scores`` is the sigmoid importance per input feature row (the
    reference's val-time ``Sigmoid()(output)``, train.py:144). ``summary``
    / ``change_points`` are present when shot selection ran (identical
    arithmetic to the offline eval pipeline)."""

    scores: np.ndarray                       # (n,) float32
    summary: Optional[np.ndarray]            # (n_frames,) int8 or None
    change_points: Optional[np.ndarray]      # (S, 2) inclusive bounds
    n_frames: int
    latency_s: float                         # enqueue -> result set


@dataclasses.dataclass
class ServeStats:
    requests: int             # admitted (excludes rejected)
    completed: int
    failed: int               # failed on/after the accelerator path
    rejected: int             # refused at submit() (overload / too long)
    expired: int              # deadline_s elapsed before dispatch
    batches: int
    rows_scored: int          # real request rows sent to the accelerator
    rows_padded: int          # repeated rows for power-of-two batches (they
                              # reuse device-resident arrays: zero wire cost)
    rows_moved: int           # mesh mode: rows re-committed to another
                              # replica to balance a shard (ICI, not wire)
    long_requests: int        # mesh mode: requests routed to the ring
    batch_hist: Dict[int, int]  # real-rows-per-batch -> count
    latency_mean_s: float
    latency_p50_s: float
    latency_p95_s: float
    latency_p99_s: float

    @staticmethod
    def zero_raw() -> dict:
        """A fresh mutable counter dict (the service's under-lock record;
        the dataclass above is its immutable aggregated snapshot)."""
        return dict(requests=0, completed=0, failed=0, rejected=0,
                    expired=0, batches=0, rows_scored=0, rows_padded=0,
                    rows_moved=0, long_requests=0)

    @classmethod
    def from_raw(cls, stats: dict, batch_hist: Dict[int, int],
                 latencies) -> "ServeStats":
        """Aggregate the service's raw counters + latency window into a
        snapshot (quantiles computed here, outside the service lock)."""
        lat = np.asarray(latencies, dtype=np.float64)

        def q(p):
            return float(np.quantile(lat, p)) if lat.size else 0.0

        return cls(batch_hist=dict(batch_hist),
                   latency_mean_s=float(lat.mean()) if lat.size else 0.0,
                   latency_p50_s=q(0.50), latency_p95_s=q(0.95),
                   latency_p99_s=q(0.99), **stats)


@dataclasses.dataclass
class _Request:
    feats: np.ndarray
    row_dev: object            # (n_bucket, D) tensor on the device, its
                               # host-to-device copy possibly in flight
                               # (coalesced wire: the host tensor; int8
                               # wire: an (int8 rows, f32 scales) pair)
    n_bucket: int
    picks: Optional[np.ndarray]
    n_frames: int
    change_points: Optional[np.ndarray]
    want_summary: bool
    budget_ratio: float
    future: Future
    t_enq: float
    deadline: Optional[float]  # absolute monotonic; None = no deadline
    row_host: object = None    # pinned host source of an in-flight copy,
                               # kept alive until the batch has run


_CLOSE = object()


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def normalize_request(feats, picks, n_frames, change_points,
                      in_features: int):
    """Validate + normalize one ``submit()``'s inputs (pure host logic).

    Returns ``(feats f32 (n, D), n, picks int64 (n,), n_frames int,
    change_points int64 (S, 2) | None)`` or raises ``ValueError`` with the
    same messages the service has always used (pinned by
    tests/test_serve.py::test_submit_validation)."""
    feats = np.asarray(feats, dtype=np.float32)
    if feats.ndim != 2 or feats.shape[1] != in_features:
        raise ValueError(
            f"features must be (n, {in_features}), got {feats.shape}")
    n = feats.shape[0]
    if n == 0:
        raise ValueError("empty feature sequence")
    if n_frames is None:
        n_frames = n
    n_frames = int(n_frames)
    if picks is None:
        if n_frames != n:
            raise ValueError(
                "picks is required when n_frames != len(features): the "
                "feature-row -> original-frame mapping is not inferable")
        picks = np.arange(n, dtype=np.int64)
    else:
        picks = np.asarray(picks, dtype=np.int64).reshape(-1)
        if picks.shape[0] != n:
            raise ValueError("picks must have one entry per feature row")
    if change_points is not None:
        change_points = np.asarray(change_points, dtype=np.int64)
        if change_points.ndim != 2 or change_points.shape[1] != 2:
            raise ValueError("change_points must be (S, 2)")
    return feats, n, picks, n_frames, change_points

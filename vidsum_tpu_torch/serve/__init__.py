# ported from vidsum_tpu/serve/__init__.py
"""Online serving: micro-batched GPU scoring behind a request queue.

Requests are padded to the 128-multiple length buckets, a dispatcher thread
micro-batches what arrives within a bounded window, groups it by bucket and
pads each group's batch dim to a power of two by repeating rows, and shot
selection (KTS + knapsack) runs on a worker pool. ``submit()`` is gated by
``max_queue_depth`` (:class:`ServiceOverloaded`), by the kernel ladder's
length envelope (:class:`RequestTooLong`), and by an optional per-request
deadline (:class:`DeadlineExceeded`).

Package layout: ``types.py`` (results/stats/errors), ``admission.py``
(admission and slot lifecycle), ``transport.py`` (wire bytes),
``dispatch.py`` (dispatcher loop and shot selection), ``service.py`` (the
:class:`ScoringService` orchestrator).
"""

from vidsum_tpu_torch.serve.service import ScoringService
from vidsum_tpu_torch.serve.types import (
    DeadlineExceeded, RequestTooLong, ServeResult, ServeStats,
    ServiceOverloaded,
)

__all__ = [
    "ScoringService", "ServeResult", "ServeStats",
    "ServiceOverloaded", "RequestTooLong", "DeadlineExceeded",
]

# ported from vidsum_tpu/serve/dispatch.py
"""The dispatcher side of the scoring service: windowing, batch runs,
long-route launches and host-side shot selection.

One dispatcher thread per service runs :func:`dispatcher_loop`: it pulls
admitted requests off the queue, collects a bounded batching window, groups
by length bucket and runs each group on the device (one device through
``serve/transport.py``, a mesh through ``serve/mesh.py``); a long request
takes the ring on its own. Results fan out to the
service's selection pool so the dispatcher is back on the device while the
CPU picks shots. All functions take the service as first argument and read
its attributes live."""

from __future__ import annotations

import queue
import time
from collections import defaultdict

import numpy as np

from vidsum_tpu_torch.ops.kts import change_points_from_cps, kts_segmentation
from vidsum_tpu_torch.ops.summary import generate_summary
from vidsum_tpu_torch.serve import mesh as mesh_mod
from vidsum_tpu_torch.serve import transport
from vidsum_tpu_torch.serve.types import (
    _CLOSE, ServeResult, _next_pow2, _Request,
)


def dispatcher_loop(svc) -> None:
    closing = False
    while not closing:
        req = svc._q.get()
        if req is _CLOSE:
            break
        if svc._expire_if_late(req):
            continue
        window = [req]
        deadline = time.monotonic() + svc.max_delay_s
        while len(window) < svc.max_batch:
            remaining = deadline - time.monotonic()
            try:
                nxt = (svc._q.get_nowait() if remaining <= 0
                       else svc._q.get(timeout=remaining))
            except queue.Empty:
                break
            if nxt is _CLOSE:
                closing = True
                break
            if not svc._expire_if_late(nxt):
                window.append(nxt)
        _dispatch_window(svc, window)
    # drain: a submit racing close() can land behind the sentinel
    leftover = []
    while True:
        try:
            r = svc._q.get_nowait()
        except queue.Empty:
            break
        if r is not _CLOSE and not svc._expire_if_late(r):
            leftover.append(r)
    if leftover:
        _dispatch_window(svc, leftover)


def _dispatch_window(svc, window: list) -> None:
    groups = defaultdict(list)
    for r in window:
        if r.long:
            _run_long(svc, r)
        else:
            groups[r.n_bucket].append(r)
    for n_bucket in sorted(groups):
        for start in range(0, len(groups[n_bucket]), svc.max_batch):
            _run_batch(svc, n_bucket,
                       groups[n_bucket][start:start + svc.max_batch])


def _run_batch(svc, n_bucket: int, items: list) -> None:
    if svc._rep_fwd is not None:
        return _run_batch_replica(svc, n_bucket, items)
    b_real = len(items)
    b = _next_pow2(b_real)
    mask = np.ones((b, n_bucket), dtype=bool)
    rows = []
    for i in range(b):
        r = items[i % b_real]   # pad rows reuse device-resident rows:
        rows.append(r.row_dev)  # the batch-dim pad costs zero wire bytes
        mask[i, : r.feats.shape[0]] = False
    try:
        out = transport.score_batch_single(svc._wire, svc._model, rows, mask)
    except Exception as e:  # noqa: BLE001 — fail every rider, keep serving
        for r in items:
            svc._fail(r, e)
        return
    for r in items:
        r.row_host = None   # the batch ran, so every copy has landed
    svc._account_batch(b_real, b)
    for i, r in enumerate(items):
        svc._pool.submit(finish_request, svc, r,
                         out[i, : r.feats.shape[0]].copy())


def _run_batch_replica(svc, n_bucket: int, items: list) -> None:
    """Mesh-mode batch: ``k`` rows per replica, k the next power of two of
    ceil(b_real / R) (``serve/mesh.py`` owns the balanced assembly and the
    straggler re-commits), each replica on the single-device forward."""
    R = len(svc._mesh_devices)
    b_real = len(items)
    k = _next_pow2(-(-b_real // R))
    try:
        xs, mask, real_slots, moved = mesh_mod.assemble_replica_batch(
            items, svc._mesh_devices, k, n_bucket)
        out = (svc._rep_fwd_i8 if svc._wire.int8 else svc._rep_fwd)(xs,
                                                                    mask)
    except Exception as e:  # noqa: BLE001 — fail every rider, keep serving
        for r in items:
            svc._fail(r, e)
        return
    for r in items:
        r.row_host = None
    svc._account_batch(b_real, R * k, moved)
    for i, r in real_slots:
        svc._pool.submit(finish_request, svc, r,
                         out[i, : r.feats.shape[0]].copy())


def _run_long(svc, r: _Request) -> None:
    """Mesh-mode long request: one ring pass over all entries, one request
    per call (a long video fills the mesh by itself). The dispatcher only
    launches the ring; the host fetch, which waits for the device, runs on
    the selection pool, so a long pass never holds up the short batches
    behind it on a card (on the CPU the launch computes)."""
    n = r.feats.shape[0]
    mask = np.ones((1, r.n_bucket), dtype=bool)
    mask[0, :n] = False
    try:
        outs = svc._long_fwd(r.row_dev, mask)
    except Exception as e:  # noqa: BLE001 — keep serving
        svc._fail(r, e)
        return
    with svc._lock:
        svc._stats["batches"] += 1
        svc._stats["rows_scored"] += 1
        svc._stats["long_requests"] += 1

    def fetch_and_finish():
        try:
            out = np.concatenate([o.float().cpu().numpy() for o in outs],
                                 axis=1)
        except Exception as e:  # noqa: BLE001 — device-side failure
            svc._fail(r, e)
            return
        r.row_host = None
        finish_request(svc, r, out[0, :n].copy())

    svc._pool.submit(fetch_and_finish)


# ------------------------------------------------------- shot selection

def finish_request(svc, r: _Request, scores: np.ndarray) -> None:
    """Host-side completion: optional shot selection (bit-parity pipeline)
    then future resolution. Runs on the selection pool."""
    try:
        summary = cps = None
        if r.want_summary:
            cps = r.change_points
            if cps is None:
                cps = auto_segments(r.feats, r.n_frames)
            [summary] = generate_summary([cps], [scores], [r.n_frames],
                                         [r.picks],
                                         budget_ratio=r.budget_ratio)
        res = ServeResult(scores=scores, summary=summary,
                          change_points=cps, n_frames=r.n_frames,
                          latency_s=time.monotonic() - r.t_enq)
        svc._complete(r, res)
    except Exception as e:  # noqa: BLE001 — propagate into the future
        svc._fail(r, e)


def auto_segments(feats: np.ndarray, n_frames: int) -> np.ndarray:
    """Auto-KTS shot bounds, arithmetic-identical to the JAX package's
    ``pipeline._finish_video`` (float64 gram, ncp = n//25, sampled-space
    bounds scaled to original frames)."""
    n = feats.shape[0]
    g = feats.astype(np.float64)
    cps, _ = kts_segmentation(g @ g.T, max(n // 25, 1), vmax=1.0)
    bounds = change_points_from_cps(cps, n)
    if n_frames == n:
        return bounds
    ratio = n_frames / n
    starts = np.round(bounds[:, 0] * ratio).astype(np.int64)
    ends = np.concatenate([starts[1:] - 1, [n_frames - 1]])
    return np.stack([starts, ends], axis=1)

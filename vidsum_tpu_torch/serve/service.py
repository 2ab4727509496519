# ported from vidsum_tpu/serve/service.py
"""The micro-batching scoring service: admission, dispatch, selection.

Requests enter through :meth:`ScoringService.submit` (admission control +
submit-time host-to-device copy), a dispatcher thread micro-batches them
onto the GPU (``serve/transport.py`` owns the wire bytes), and host-side
shot selection (the bit-parity KTS + knapsack pipeline of
``ops/{kts,summary,knapsack}``) runs on a worker pool so the dispatcher is
back on the device while the CPU picks shots.

Requests are padded to 128-multiple length buckets and each bucket's batch
dim to a power of two by repeating request rows; no op of the scorer mixes
batch rows, so a request's served scores equal its solo scores bit for bit.
With a ``mesh``, short requests run as replica batches and long ones over
the sequence-parallel ring (``serve/mesh.py``).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import defaultdict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.data.collate import bucket_length
from vidsum_tpu_torch.device import resolve_device
from vidsum_tpu_torch.serve import admission, dispatch, transport
from vidsum_tpu_torch.serve import mesh as mesh_mod
from vidsum_tpu_torch.serve.mesh import _single_chip_max_len
from vidsum_tpu_torch.serve.types import (
    _CLOSE, ServeResult, ServeStats, _Request, normalize_request,
)
from vidsum_tpu_torch.utils import profiling


class ScoringService:
    """Micro-batching scorer: ``submit()`` from any thread, results as
    futures. One dispatcher thread owns the device dispatch; a small pool
    runs host-side shot selection.

    :param model: the scorer ``cfg.arch`` names
        (:func:`~vidsum_tpu_torch.models.build_scorer`: ``SimNet`` or
        ``PGLSum``, which serves in float32 on one device); it is moved to
        ``device`` and put in eval mode.
    :param device: ``None`` (default) = the CUDA card, which must exist
        (with a ``mesh``: its first entry); pass ``"cpu"`` to serve on the
        plain PyTorch path.
    :param max_batch: upper bound on real rows per device batch (the batch
        dim is padded up to the next power of two).
    :param max_delay_ms: batching window — how long the dispatcher waits
        for more requests after the first one arrives.
    :param attn_impl: scorer attention impl; default ``"fused_block"`` on
        CUDA and ``"dense"`` on the CPU; ``"int8_block"`` / ``"int8_dense"``
        score on the lossy int8 route (``SimNet``).
    :param wire_dtype: ``"auto"`` (the compute dtype), ``"float32"``,
        ``"bfloat16"``, or ``"int8"`` (lossy: per-frame int8 rows and f32
        scales, quantised on the host and dequantised on the device).
    :param wire_mode: ``"rows"`` (submit-time copies) or ``"coalesced"``
        (one copy per micro-batch); bit-identical scores.
    :param max_queue_depth: maximum admitted-but-unresolved requests; past
        it ``submit()`` raises :class:`ServiceOverloaded` before any
        padding or device copy.
    :param max_request_len: optional operator cap on feature rows per
        request, on top of the kernel-envelope cap.
    :param rss_watermark_mb: optional host-RSS shed threshold.
    :param mesh: a :class:`~vidsum_tpu_torch.parallel.mesh.DeviceMesh`
        with more than one entry turns on mesh mode: requests past
        ``long_threshold`` run over the sequence-parallel ring, one shard
        per entry; where the entries name more than one device, short
        requests are committed round-robin to them and run as replica
        batches. Entries may repeat a device. On the int8 wire, replica
        batches dequantise on each replica's device
        (``serve.mesh.make_replica_forward_int8``); long requests ship on
        the lossless f32 wire.
    :param long_threshold: feature-row count above which a request takes
        the ring (mesh mode only); default the largest length the single-
        device kernel ladder carries.
    """

    def __init__(self, model, cfg: ModelConfig, *, device=None,
                 attn_impl: Optional[str] = None,
                 max_batch: int = 8, max_delay_ms: float = 3.0,
                 bucket: int = 128, pad_value: float = 1000.0,
                 budget_ratio: float = 0.15,
                 selection_workers: int = 2,
                 wire_dtype: str = "auto",
                 wire_mode: str = "rows",
                 latency_window: int = 4096,
                 max_queue_depth: int = 256,
                 max_request_len: Optional[int] = None,
                 rss_watermark_mb: Optional[float] = None,
                 mesh=None, long_threshold: Optional[int] = None) -> None:
        from vidsum_tpu_torch.train.steps import make_eval_forward

        if mesh is not None and mesh.size > 1:
            if device is not None and mesh.devices[0] != resolve_device(
                    device):
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"entry {mesh.devices[0]}")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        if attn_impl is None:
            attn_impl = "fused_block" if self.device.type == "cuda" else "dense"
        if cfg.arch == "pglsum" and (
                attn_impl.startswith("int8") or wire_dtype not in (
                    "auto", "float32") or (mesh is not None
                                           and mesh.size > 1)):
            raise ValueError("a PGL-SUM scorer serves in float32 on one "
                             "device: no int8 route, no bfloat16 or int8 "
                             "wire, no mesh")
        self._cfg = cfg
        self._model = model.to(self.device).eval()
        routing = mesh_mod.build_mesh_routing(cfg, mesh, self._model,
                                              attn_impl, bucket,
                                              long_threshold)
        # flattened onto the service so tests and tools can reach the routes
        # (None everywhere: a single-device service; _rep_fwd None: short
        # requests take the single-device batch path)
        self._mesh_devices = routing.devices if routing else None
        self._rep_fwd = routing.rep_fwd if routing else None
        self._fwd = (None if self._rep_fwd is not None else
                     make_eval_forward(cfg, attn_impl=attn_impl,
                                       device=self.device))
        self._long_fwd = routing.long_fwd if routing else None
        self._long_threshold = routing.long_threshold if routing else None
        self._rr = 0
        self._wire = transport.resolve_wire(cfg, wire_dtype, wire_mode,
                                            self.device, self._fwd,
                                            mesh_active=routing is not None)
        self._rep_fwd_i8 = (mesh_mod.make_replica_forward_int8(
            cfg, self._rep_fwd) if self._wire.int8
            and self._rep_fwd is not None else None)
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.bucket = int(bucket)
        self.pad_value = float(pad_value)
        self.budget_ratio = float(budget_ratio)
        self.max_queue_depth = int(max_queue_depth)
        self.max_request_len = (None if max_request_len is None
                                else int(max_request_len))
        self.rss_watermark_mb = (None if rss_watermark_mb is None
                                 else float(rss_watermark_mb))
        # submit-time length caps from the kernel ladder's envelope
        # arithmetic (flash_forward_supported); the dense impl has no kernel
        # envelope, so only max_request_len caps it (int8_dense is capped, as
        # in the JAX package). The ring's shards are N / P long, so its
        # envelope scales by the entry count.
        self._short_cap: Optional[int] = (
            None if attn_impl == "dense"
            else _single_chip_max_len(cfg, bucket))
        self._long_cap: Optional[int] = (
            self._short_cap * len(self._mesh_devices)
            if self._long_fwd is not None and self._short_cap is not None
            else None)

        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        self._inflight = 0   # admitted-but-unresolved requests
        self._stats = self._zero_stats()
        self._batch_hist: Dict[int, int] = defaultdict(int)
        self._latencies: deque = deque(maxlen=latency_window)
        self._pool = ThreadPoolExecutor(max_workers=selection_workers,
                                        thread_name_prefix="vidsum-select")
        self._dispatcher = threading.Thread(
            target=dispatch.dispatcher_loop, args=(self,), daemon=True,
            name="vidsum-dispatch")
        self._dispatcher.start()

    _zero_stats = staticmethod(ServeStats.zero_raw)

    # ------------------------------------------------------------------ API

    def submit(self, features: np.ndarray, *,
               picks: Optional[np.ndarray] = None,
               n_frames: Optional[int] = None,
               change_points: Optional[np.ndarray] = None,
               want_summary: bool = True,
               budget_ratio: Optional[float] = None,
               deadline_s: Optional[float] = None) -> Future:
        """Enqueue one video's features; returns a ``Future[ServeResult]``.

        :param features: (n, in_features) frame features.
        :param picks: original-frame index per feature row (defaults to
            ``arange(n)``; required whenever ``n_frames != n``).
        :param n_frames: original video frame count (defaults to ``n``).
        :param change_points: (S, 2) inclusive shot bounds in original
            frames. When absent and a summary is wanted, auto-KTS segments
            the features.
        :param deadline_s: optional dispatch deadline in seconds from now;
            a request the dispatcher reaches after it fails with
            :class:`DeadlineExceeded` and never runs on the device.

        :raises ServiceOverloaded: ``max_queue_depth`` admitted requests
            are already unresolved (checked before any device copy).
        :raises RequestTooLong: no path on this service carries a sequence
            this long.
        """
        t_stage = profiling.stamp()
        feats, n, picks, n_frames, change_points = normalize_request(
            features, picks, n_frames, change_points, self._cfg.in_features)
        long = self._long_fwd is not None and n > self._long_threshold
        admission.admit(self, n, long)
        try:
            return self._submit_admitted(
                feats, n, picks, n_frames, change_points, want_summary,
                budget_ratio, deadline_s, long, t_stage)
        except BaseException:
            admission.release_failed_submit(self)
            raise

    def _submit_admitted(self, feats, n, picks, n_frames, change_points,
                         want_summary, budget_ratio, deadline_s,
                         long, t_stage) -> Future:
        fut: Future = Future()
        # pad to the length bucket on the host and start the copy NOW, so
        # it runs under earlier batches' compute (an (int8 rows, scales) pair
        # on the int8 wire)
        dev_idx = -1
        if long:
            # the ring needs equal shards: pad to bucket x entries and ship
            # seq-sharded, on the lossless wire (f32 where the short
            # requests ride the int8 one)
            n_bucket = bucket_length(n, self.bucket * len(self._mesh_devices))
            row_dev, row_host = mesh_mod.build_long_row(
                feats, n_bucket, self._cfg.in_features, self.pad_value,
                torch.float32 if self._wire.int8 else self._wire.dtype,
                self._mesh_devices)
        else:
            n_bucket = bucket_length(n, self.bucket)
            row = transport.build_short_row(self._wire, feats, n_bucket,
                                            self._cfg.in_features,
                                            self.pad_value)
            if self._wire.coalesced:
                row_dev, row_host = row, None   # ships with its batch
            elif self._rep_fwd is None:
                row_dev, row_host = transport.ship_row(self._wire, row), row
            else:
                # commit rows round-robin over the replicas, so a batch
                # assembles from rows already in place
                with self._lock:
                    dev_idx = self._rr % len(self._mesh_devices)
                    self._rr += 1
                row_dev = mesh_mod.move_row(row,
                                            self._mesh_devices[dev_idx])
                row_host = row
        now = time.monotonic()
        t_enq = profiling.stamp()
        req = _Request(feats=feats, row_dev=row_dev, row_host=row_host,
                       n_bucket=n_bucket, picks=picks, n_frames=n_frames,
                       change_points=change_points,
                       want_summary=bool(want_summary),
                       budget_ratio=(self.budget_ratio if budget_ratio is None
                                     else float(budget_ratio)),
                       future=fut, t_enq=now,
                       deadline=(None if deadline_s is None
                                 else now + float(deadline_s)),
                       dev_idx=dev_idx, long=long, t_enq_ns=t_enq,
                       span_id=None if t_enq is None else profiling.new_id())
        # check-and-enqueue under the same lock close() uses, so a request
        # is either enqueued ahead of the sentinel or rejected
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            self._q.put(req)
        profiling.record_span("serve.stage", t_stage, t_enq, req.span_id)
        return fut

    def summarize(self, features: np.ndarray, **kw) -> ServeResult:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(features, **kw).result()

    def warmup(self, lengths: Sequence[int] = (128,),
               batch_sizes: Optional[Sequence[int]] = None) -> list:
        """Run the (batch, bucket) grid once through the real dispatch path
        (the first launch of each kernel builds it). Batch sizes are capped
        at ``max_batch`` and at the current admission headroom. Returns
        ``[(n_bucket, batch, seconds), ...]``."""
        if batch_sizes is None:
            batch_sizes = [1]
            while batch_sizes[-1] < self.max_batch:
                batch_sizes.append(batch_sizes[-1] * 2)
        warmed = []
        seen = set()
        for n in lengths:
            n_b = bucket_length(int(n), self.bucket)
            for b in batch_sizes:
                with self._lock:
                    headroom = max(1, self.max_queue_depth - self._inflight)
                b_eff = min(b, self.max_batch, headroom)
                if (n_b, b_eff) in seen:
                    continue
                seen.add((n_b, b_eff))
                t0 = time.monotonic()
                futs = [self.submit(
                    np.zeros((n_b, self._cfg.in_features), np.float32),
                    want_summary=False) for _ in range(b_eff)]
                for f in futs:
                    f.result()
                warmed.append((n_b, b_eff, time.monotonic() - t0))
        self.reset_stats()
        return warmed

    def reset_stats(self) -> None:
        with self._lock:
            self._stats = self._zero_stats()
            self._batch_hist = defaultdict(int)
            self._latencies.clear()

    def stats(self) -> ServeStats:
        with self._lock:
            s = dict(self._stats)
            hist = dict(self._batch_hist)
            lat = tuple(self._latencies)
        return ServeStats.from_raw(s, hist, lat)

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain the queue, stop the dispatcher, finish pending selection.
        With a ``timeout`` the worker pool stays up while the dispatcher is
        still running; call ``close()`` again to finish. Idempotent."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._q.put(_CLOSE)
        self._dispatcher.join(timeout=timeout)
        if self._dispatcher.is_alive():
            return
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------- future resolution

    def _complete(self, r: _Request, res: "ServeResult") -> None:
        admission.complete(self, r, res)

    def _fail(self, r: _Request, exc: BaseException,
              stat: str = "failed") -> None:
        admission.fail(self, r, exc, stat)

    def _expire_if_late(self, r: _Request) -> bool:
        return admission.expire_if_late(self, r)

    def _account_batch(self, b_real: int, b: int, moved: int = 0) -> None:
        with self._lock:
            self._stats["batches"] += 1
            self._stats["rows_scored"] += b_real
            self._stats["rows_padded"] += b - b_real
            self._stats["rows_moved"] += moved
            self._batch_hist[b_real] += 1

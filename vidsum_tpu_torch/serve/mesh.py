# ported from vidsum_tpu/serve/mesh.py
"""Mesh serving: replica batches for short requests and the sequence-
parallel ring for long ones.

Passing a :class:`~vidsum_tpu_torch.parallel.mesh.DeviceMesh` to
:class:`~vidsum_tpu_torch.serve.ScoringService` turns on two modes behind
the same ``submit()``, over the mesh's flattened entries (the grid's shape
is ignored; an entry may repeat a device):

- **replica batches**, where the entries name more than one device: rows
  are committed round-robin to the entries at submit time, and a batch of
  ``k`` rows per replica runs the single-device forward on each replica's
  rows, so a request's scores equal its solo scores bit for bit. Where every
  entry repeats one device, short requests take the single-device batch
  path (one batch there gives the same scores as R replica batches), and
  the entries only shard the ring. On the int8 wire each replica
  dequantises its own int8 rows and f32 scales on its device
  (:func:`make_replica_forward_int8`), so no dequantised row crosses a
  device;
- **long requests** (past ``long_threshold``, by default the single-device
  kernel ladder's envelope): the request is padded to ``bucket x entries``,
  shipped seq-sharded at submit time, always on the lossless wire, and
  scored by ``parallel/seq_forward.make_seq_sharded_forward`` over a
  (1, entries) mesh: activations are O(N / P) per shard and no N x N tensor
  exists.

This module owns the placement: the routes, the long row and the balanced
replica batch. Wire bytes live in ``serve/transport.py``."""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.device import dtype_of
from vidsum_tpu_torch.ops.attention import flash_forward_supported
from vidsum_tpu_torch.parallel.mesh import DeviceMesh, on
from vidsum_tpu_torch.parallel.seq_forward import (
    _replicas, make_seq_sharded_forward,
)
from vidsum_tpu_torch.train.steps import make_eval_forward


def _single_chip_max_len(cfg: ModelConfig, bucket: int) -> int:
    """Largest bucketed length the single-device kernel ladder carries: the
    default threshold of the long route."""
    dh = cfg.d_model // cfg.num_heads
    itemsize = dtype_of(cfg.compute_dtype).itemsize
    n = bucket
    while n < (1 << 21) and flash_forward_supported(n + bucket, dh,
                                                    itemsize):
        n += bucket
    return n


def _make_replica_forward(cfg: ModelConfig, model, devs: list,
                          attn_impl: str):
    """``fwd(xs, mask) -> (R * k, N)`` host scores: replica r runs the
    single-device eval forward on its rows ``xs[r]`` (k, N, D) on
    ``devs[r]``, with the model (or, on another card, a copy of it made
    now; serving does not change the weights)."""
    models = _replicas(model, devs, detach=True)
    fwds = {d: make_eval_forward(cfg, attn_impl, device=d) for d in models}

    def fwd(xs: list, mask: np.ndarray) -> np.ndarray:
        k = xs[0].shape[0]
        outs = []
        for r, (d, x) in enumerate(zip(devs, xs)):
            with on(d):
                outs.append(fwds[d](models[d], x, mask[r * k:(r + 1) * k]))
        return torch.cat([o.float().cpu() for o in outs]).numpy()

    return fwd


def make_replica_forward_int8(cfg: ModelConfig, rep_fwd):
    """The int8-wire replica forward: ``fwd(pairs, mask)`` takes each
    replica's ``(int8 rows (k, N, D), f32 scales (k, N))`` on its device,
    dequantises there (``x_i8 * scale``, the single-device int8 wire's
    arithmetic) and runs ``rep_fwd``'s scorer on the result."""

    def fwd(pairs: list, mask: np.ndarray) -> np.ndarray:
        xs = []
        for x_i8, scales in pairs:
            with on(x_i8.device):
                xs.append(x_i8.float() * scales[..., None])
        return rep_fwd(xs, mask)

    return fwd


def move_row(row, device: torch.device):
    """A request's row (or int8 ``(rows, scales)`` pair) copied to
    ``device`` (the tensor itself where it is there already)."""
    if isinstance(row, tuple):
        return tuple(t.to(device, non_blocking=True) for t in row)
    return row.to(device, non_blocking=True)


def _make_long_forward(cfg: ModelConfig, model, devs: list):
    """``fwd(shards, mask) -> per-shard (1, Nl) sigmoid scores`` on the
    devices: the ring forward over a (1, entries) mesh."""
    seq_fwd = make_seq_sharded_forward(cfg, DeviceMesh([devs]))

    def fwd(shards: list, mask: np.ndarray) -> list:
        Nl = shards[0].shape[1]
        with torch.inference_mode():
            masks = [torch.from_numpy(mask[:, s * Nl:(s + 1) * Nl]).to(d)
                     for s, d in enumerate(devs)]
            [row] = seq_fwd.sharded(model, [list(shards)], [masks])
            return [torch.sigmoid(scores[..., 0]) for scores, _ in row]

    return fwd


def _replica_devices(devs: list) -> Optional[list]:
    """The entries short requests spread over: all of them where they name
    more than one device, None where every entry repeats one."""
    return devs if len(set(devs)) > 1 else None


@dataclasses.dataclass
class MeshRouting:
    """Resolved mesh serving state (``rep_fwd`` None: short requests take
    the single-device path; ``long_fwd`` None: no long route)."""

    devices: list
    rep_fwd: Optional[object]
    long_fwd: Optional[object]
    long_threshold: Optional[int]


def build_mesh_routing(cfg: ModelConfig, mesh: Optional[DeviceMesh], model,
                       attn_impl: str, bucket: int,
                       long_threshold: Optional[int]
                       ) -> Optional[MeshRouting]:
    """The replica and ring routes over ``mesh``'s entries; None when there
    is no mesh or it has one entry."""
    if mesh is None or mesh.size <= 1:
        return None
    devs = mesh.devices
    rep_devs = _replica_devices(devs)
    rep_fwd = (None if rep_devs is None
               else _make_replica_forward(cfg, model, rep_devs, attn_impl))
    long_fwd = None
    if cfg.use_cls:
        # the ring cannot prepend per-shard CLS tokens, so the sequence-
        # parallel long route does not exist; requests past the single-
        # device envelope are rejected at submit()
        if long_threshold is not None:
            raise ValueError(
                "long_threshold was given but cfg.use_cls=True "
                "disables the sequence-parallel long route (the "
                "ring cannot prepend per-shard CLS tokens); drop "
                "long_threshold or serve a use_cls=False config")
        warnings.warn(
            "mesh serving with cfg.use_cls=True has no sequence-"
            "parallel long route; requests past the single-chip "
            "kernel envelope will be rejected at submit()",
            stacklevel=3)
    else:
        long_fwd = _make_long_forward(cfg, model, devs)
        if long_threshold is None:
            long_threshold = _single_chip_max_len(cfg, bucket)
        long_threshold = int(long_threshold)
    return MeshRouting(devices=devs, rep_fwd=rep_fwd, long_fwd=long_fwd,
                       long_threshold=long_threshold if long_fwd else None)


def build_long_row(feats: np.ndarray, n_bucket: int, in_features: int,
                   pad_value: float, dtype: torch.dtype, devs: list):
    """Pad a long request to ``n_bucket`` (a multiple of bucket x entries)
    and start its seq-sharded copies (the ring needs equal shards). Returns
    (device shards, host shards): the pinned host shards stay referenced
    until their copies have landed."""
    n, P = feats.shape[0], len(devs)
    row = torch.full((1, n_bucket, in_features), pad_value, dtype=dtype)
    row[0, :n] = torch.from_numpy(feats).to(dtype)
    host = [c.contiguous() for c in torch.chunk(row, P, dim=1)]
    host = [h.pin_memory() if d.type == "cuda" else h
            for h, d in zip(host, devs)]
    return [h.to(d, non_blocking=True) for h, d in zip(host, devs)], host


def assemble_replica_batch(items: list, devs: list, k: int, n_bucket: int):
    """A balanced batch of ``k`` rows per replica from device-resident
    rows (int8 ``(rows, scales)`` pairs on the int8 wire). Rows landed
    round-robin at submit, so a batch drawn from consecutive submits is
    near-balanced; stragglers are re-committed to a
    replica holding fewer (a copy between cards, a re-index on one card),
    which updates their ``row_dev``/``dev_idx``; an empty replica borrows a
    row. Returns ``(xs, mask, real_slots, moved)``: the per-replica (k,
    n_bucket, D) batches, the (R * k, n_bucket) bool pad mask, the
    ``(batch_index, request)`` pairs of real rows, and the re-commit
    count. On the int8 wire a replica's batch is a ``(rows, scales)``
    pair."""
    R = len(devs)
    by_dev: list = [[] for _ in range(R)]
    for r in items:
        by_dev[r.dev_idx].append(r)
    moved = 0
    overflow = [r for g in by_dev for r in g[k:]]
    for g in by_dev:
        del g[k:]
    for d in range(R):
        while len(by_dev[d]) < k and overflow:
            r = overflow.pop()
            r.row_dev = move_row(r.row_dev, devs[d])
            r.dev_idx = d
            by_dev[d].append(r)
            moved += 1
    donor = next(g[0] for g in by_dev if g)
    mask = np.ones((R * k, n_bucket), dtype=bool)
    xs, real_slots = [], []
    for d in range(R):
        g, rows, borrowed = by_dev[d], [], None
        for j in range(k):
            i = d * k + j
            if j < len(g):
                r = g[j]
                rows.append(r.row_dev)
                real_slots.append((i, r))
            elif g:  # pad by repeating a row already on this replica
                r = g[j % len(g)]
                rows.append(r.row_dev)
            else:    # empty replica: borrow one row
                if borrowed is None:
                    borrowed = move_row(donor.row_dev, devs[d])
                    moved += 1
                r = donor
                rows.append(borrowed)
            mask[i, : r.feats.shape[0]] = False
        xs.append(tuple(torch.stack(p) for p in zip(*rows))
                  if isinstance(rows[0], tuple) else torch.stack(rows))
    return xs, mask, real_slots, moved

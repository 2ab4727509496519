# ported from vidsum_tpu/serve/transport.py (single-device wires; the mesh
# placements arrive with the multi-GPU slice)
"""Serving wire transports: how request bytes reach the device.

- ``rows`` (default): each request's padded feature row is built in pinned
  host memory and its host-to-device copy starts at submit time
  (``non_blocking``), so transfers overlap earlier batches' compute; the
  batch is assembled on the device with ``torch.stack`` and batch-dim
  padding costs zero wire bytes.
- ``coalesced``: rows stay on the host and one stacked tensor moves per
  micro-batch (one transfer per batch instead of one per request). Scores
  are bit-identical to ``rows``.

Wire dtypes: ``"auto"`` (the model's compute dtype, lossless for the
scorer, which casts to it first), ``"float32"``, ``"bfloat16"``, or
``"int8"`` (opt-in, lossy): per-frame symmetric quantisation on the host,
an f32 scale per frame riding along (+0.4 % bytes at D = 1024), dequantised
on the device before the same forward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.device import dtype_of


@dataclasses.dataclass
class Wire:
    """Resolved wire policy: dtype, transport, device and the forward
    ``fwd(model, x, pad_mask) -> scores``; ``fwd_i8(model, x_i8, scales,
    pad_mask)`` (int8 wire only) dequantises on the device first."""

    dtype: torch.dtype
    coalesced: bool
    device: torch.device
    fwd: object
    int8: bool = False
    fwd_i8: Optional[object] = None

    @property
    def pinned(self) -> bool:
        return self.device.type == "cuda"


def quantize_frames(row: np.ndarray):
    """Per-frame symmetric int8 quantization of a padded f32 feature row
    block ``(n_bucket, D)`` → ``(int8 rows, f32 scales)``. The (n_bucket,)
    scales ride along on the wire (+0.4% bytes at D=1024)."""
    absmax = np.abs(row).max(axis=1)
    scale = np.where(absmax > 0.0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(row / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def resolve_wire(cfg: ModelConfig, wire_dtype: str, wire_mode: str,
                 device: torch.device, fwd) -> Wire:
    """Validate the (wire_dtype, wire_mode) combination and build the
    transport policy. Raises ``ValueError`` on unsupported combinations."""
    if wire_mode not in ("rows", "coalesced"):
        raise ValueError(f"wire_mode must be 'rows' or 'coalesced', "
                         f"got {wire_mode!r}")
    if wire_dtype not in ("auto", "float32", "bfloat16", "int8"):
        raise ValueError(f"wire_dtype must be 'auto', 'float32', "
                         f"'bfloat16' or 'int8', got {wire_dtype!r}")
    coalesced = wire_mode == "coalesced"
    if wire_dtype == "int8":
        def fwd_i8(model, x_i8, scales, pad_mask):
            return fwd(model, x_i8.float() * scales[..., None], pad_mask)

        return Wire(dtype=torch.int8, coalesced=coalesced, device=device,
                    fwd=fwd, int8=True, fwd_i8=fwd_i8)
    dtype = dtype_of(cfg.compute_dtype if wire_dtype == "auto"
                     else wire_dtype)
    return Wire(dtype=dtype, coalesced=coalesced, device=device, fwd=fwd)


def build_short_row(wire: Wire, feats: np.ndarray, n_bucket: int,
                    in_features: int, pad_value: float):
    """Pad one request's features to its length bucket in the wire dtype:
    a host ``(n_bucket, D)`` tensor, or on the int8 wire an ``(int8 rows,
    f32 scales)`` pair (the row built in f32 and padded before it is
    quantised), pinned when the device is a GPU."""
    n = feats.shape[0]
    if wire.int8:
        row = np.full((n_bucket, in_features), pad_value, dtype=np.float32)
        row[:n] = feats
        q, scale = quantize_frames(row)
        out = (torch.from_numpy(q), torch.from_numpy(scale))
        return tuple(t.pin_memory() for t in out) if wire.pinned else out
    row = torch.full((n_bucket, in_features), pad_value, dtype=wire.dtype,
                     pin_memory=wire.pinned)
    row[:n] = torch.from_numpy(feats).to(wire.dtype)
    return row


def ship_row(wire: Wire, row):
    """Start the row's host-to-device copy (asynchronous from pinned memory
    on the current stream, which the dispatcher's forward also runs on); a
    pair on the int8 wire."""
    if wire.int8:
        return tuple(t.to(wire.device, non_blocking=True) for t in row)
    return row.to(wire.device, non_blocking=True)


def score_batch_single(wire: Wire, model, rows: list, mask: np.ndarray
                       ) -> np.ndarray:
    """Single-device batch scoring: assemble the batch per transport and run
    the forward. ``rows`` holds one payload per batch slot (repeats
    included); returns the ``(B, n_bucket)`` sigmoid scores on the host."""
    mask_t = torch.from_numpy(mask)
    if wire.int8:
        x = torch.stack([r[0] for r in rows])
        s = torch.stack([r[1] for r in rows])
        if wire.coalesced:          # one transfer for the whole batch
            x = x.to(wire.device, non_blocking=wire.pinned)
            s = s.to(wire.device, non_blocking=wire.pinned)
        out = wire.fwd_i8(model, x, s, mask_t)
    else:
        x = torch.stack(rows)
        if wire.coalesced:
            x = x.to(wire.device, non_blocking=wire.pinned)
        out = wire.fwd(model, x, mask_t)
    return out.float().cpu().numpy()

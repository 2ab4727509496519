# ported from vidsum_tpu/serve/transport.py (the rows and coalesced wires;
# the int8 wire arrives with the int8 slice)
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
scorer, which casts to it first), ``"float32"`` or ``"bfloat16"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.device import dtype_of


@dataclasses.dataclass
class Wire:
    """Resolved wire policy: dtype, transport, device and the forward
    ``fwd(model, x, pad_mask) -> scores``."""

    dtype: torch.dtype
    coalesced: bool
    device: torch.device
    fwd: object

    @property
    def pinned(self) -> bool:
        return self.device.type == "cuda"


def resolve_wire(cfg: ModelConfig, wire_dtype: str, wire_mode: str,
                 device: torch.device, fwd) -> Wire:
    """Validate the (wire_dtype, wire_mode) combination and build the
    transport policy. Raises ``ValueError`` on unsupported combinations."""
    if wire_mode not in ("rows", "coalesced"):
        raise ValueError(f"wire_mode must be 'rows' or 'coalesced', "
                         f"got {wire_mode!r}")
    if wire_dtype == "int8":
        raise NotImplementedError("the int8 wire arrives with the int8 slice")
    if wire_dtype not in ("auto", "float32", "bfloat16"):
        raise ValueError(f"wire_dtype must be 'auto', 'float32' or "
                         f"'bfloat16', got {wire_dtype!r}")
    dtype = dtype_of(cfg.compute_dtype if wire_dtype == "auto"
                     else wire_dtype)
    return Wire(dtype=dtype, coalesced=wire_mode == "coalesced",
                device=device, fwd=fwd)


def build_short_row(wire: Wire, feats: np.ndarray, n_bucket: int,
                    in_features: int, pad_value: float) -> torch.Tensor:
    """Pad one request's features to its length bucket in the wire dtype:
    a host ``(n_bucket, D)`` tensor, pinned when the device is a GPU."""
    n = feats.shape[0]
    row = torch.full((n_bucket, in_features), pad_value, dtype=wire.dtype,
                     pin_memory=wire.pinned)
    row[:n] = torch.from_numpy(feats).to(wire.dtype)
    return row


def ship_row(wire: Wire, row: torch.Tensor) -> torch.Tensor:
    """Start the row's host-to-device copy (asynchronous from pinned memory
    on the current stream, which the dispatcher's forward also runs on)."""
    return row.to(wire.device, non_blocking=True)


def score_batch_single(wire: Wire, model, rows: list, mask: np.ndarray
                       ) -> np.ndarray:
    """Single-device batch scoring: assemble the batch per transport and run
    the forward. ``rows`` holds one row per batch slot (repeats included);
    returns the ``(B, n_bucket)`` sigmoid scores on the host."""
    if wire.coalesced:
        x = torch.stack(rows).to(wire.device, non_blocking=wire.pinned)
    else:
        x = torch.stack(rows)
    out = wire.fwd(model, x, torch.from_numpy(mask))
    return out.float().cpu().numpy()

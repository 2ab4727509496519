# ported from vidsum_tpu/ops/losses.py (the finetune loss; the pretrain
# losses arrive with the pretrain slice)
"""The finetune objective: masked MSE over raw logits (reference
``src/utils/utils.py:45-56``). Padded positions are zeroed in both prediction
and target, and the mean divides by ``B * reference_pad_len``: the max true
length in the batch, which is what the reference's max-in-batch padding
divides by, not the 128-bucket width this package pads to, so the loss does
not depend on how far a bucket pads."""

from __future__ import annotations

import torch


def reference_pad_len(pad_mask: torch.Tensor) -> torch.Tensor:
    """The length the reference's ``pad_sequence`` would have padded this
    batch to: the max true length over the batch."""
    return (~pad_mask).sum(dim=1).max().float()


def mse_with_mask_loss(output: torch.Tensor, targets: torch.Tensor,
                       pad_mask: torch.Tensor, reduction: str = "avg"
                       ) -> torch.Tensor:
    """Masked MSE. ``output`` (B, N, 1), ``targets`` (B, N), ``pad_mask``
    (B, N) True at padded frames. ``reduction="avg"`` divides the sum by
    ``B * reference_pad_len``; ``"sum"`` returns the sum, which the
    sequence-parallel step divides by the global batch and length. (The JAX
    package's ``item_weight`` and ``denom_len``, for batches padded to a
    static size on a device mesh, arrive with the multi-GPU slice.)"""
    if reduction not in ("avg", "sum"):
        raise ValueError(f"reduction must be 'avg' or 'sum', got "
                         f"{reduction!r}")
    output = output.squeeze(-1)
    keep = torch.where(pad_mask, 0.0, 1.0).to(output.dtype)
    diff = output * keep - targets * keep
    loss = diff * diff
    if reduction == "sum":
        return loss.sum()
    denom_len = reference_pad_len(pad_mask).to(loss.dtype)
    return loss.sum() / (loss.shape[0] * denom_len)

# ported from vidsum_tpu/ops/losses.py
"""Training objectives.

- :func:`mse_with_mask_loss`, the finetune loss (reference
  ``src/utils/utils.py:45-56``): masked MSE over raw logits; padded positions
  are zeroed in both prediction and target.
- The pretrain losses (reference ``src/model/simnet_pretrain.py:35-69``):
  soft cross-entropy between the score-weighted frame-feature mixture and the
  frozen video embedding, the entropy of the sharpened scores, and the mean
  off-diagonal cosine similarity between frame features.

Every mean over padded length divides by ``reference_pad_len``: the max true
length in the batch, which is what the reference's max-in-batch padding
divides by, not the 128-bucket width this package pads to, so a loss does
not depend on how far a bucket pads.
"""

from __future__ import annotations

from typing import Optional

import torch


def reference_pad_len(pad_mask: Optional[torch.Tensor],
                      n: Optional[int] = None) -> torch.Tensor:
    """The length the reference's ``pad_sequence`` would have padded this
    batch to: the max true length over the batch (dataset.py:139-143). With
    no mask, the padded width ``n``."""
    if pad_mask is None:
        return torch.tensor(float(n), dtype=torch.float32)
    return (~pad_mask).sum(dim=1).max().float()


def mse_with_mask_loss(output: torch.Tensor, targets: torch.Tensor,
                       pad_mask: torch.Tensor, reduction: str = "avg",
                       item_weight: Optional[torch.Tensor] = None,
                       denom_len: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Masked MSE. ``output`` (B, N, 1), ``targets`` (B, N), ``pad_mask``
    (B, N) True at padded frames. ``reduction="avg"`` divides the sum by
    ``B * denom_len``; ``"sum"`` returns the sum. ``denom_len`` defaults to
    ``reference_pad_len``; a step that sees one shard of the batch passes
    the global batch's (the max over the shards).

    ``item_weight`` (B,): per-video weights of a batch padded to a static
    size by repeating videos (``collate.make_batches(pad_to_batch=True)``):
    repeats weigh 0 and the mean divides by ``sum(weight) * denom_len``, so
    the loss and its gradient equal the reference's smaller final batch's
    (``src/train.py:58-64``, ``src/utils/utils.py:45-56``)."""
    if reduction not in ("avg", "sum"):
        raise ValueError(f"reduction must be 'avg' or 'sum', got "
                         f"{reduction!r}")
    output = output.squeeze(-1)
    keep = torch.where(pad_mask, 0.0, 1.0).to(output.dtype)
    diff = output * keep - targets * keep
    loss = diff * diff
    if denom_len is None:
        denom_len = reference_pad_len(pad_mask, loss.shape[1])
    denom_len = torch.as_tensor(denom_len).to(device=loss.device,
                                              dtype=loss.dtype)
    if item_weight is not None:
        item_weight = torch.as_tensor(item_weight).to(device=loss.device,
                                                      dtype=loss.dtype)
        loss = loss * item_weight[:, None]
        if reduction == "avg":
            return loss.sum() / (item_weight.sum() * denom_len)
        return loss.sum()
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / (loss.shape[0] * denom_len)


def soft_cross_entropy(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """-softmax(x2) . log(softmax(x1)), the mean over all elements
    (simnet_pretrain.py:35-41)."""
    p1 = torch.softmax(x1, dim=1)
    p2 = torch.softmax(x2, dim=1)
    return (-p2 * torch.log(p1)).mean()


def _denom(denom_len, pad_mask, n: int, like: torch.Tensor) -> torch.Tensor:
    if denom_len is None:
        denom_len = reference_pad_len(pad_mask, n)
    return torch.as_tensor(denom_len).to(device=like.device, dtype=like.dtype)


def entropy_centering(mixture: torch.Tensor,
                      pad_mask: Optional[torch.Tensor],
                      denom_len: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The entropy term of the sharpened frame-score distribution, padded
    frames zeroed (simnet_pretrain.py:43-47). ``mixture`` (B, N, 1), already
    shifted by +1e-9. The reference's ``x.mean(dim=1).mean()`` divides by
    ``B * N_padded``; here by ``B * denom_len`` (default
    ``reference_pad_len``)."""
    x = mixture * torch.log(mixture)
    if pad_mask is not None:
        x = torch.where(pad_mask[..., None], 0.0, x)
    denom = _denom(denom_len, pad_mask, x.shape[1], x)
    return x.sum() / (x.shape[0] * x.shape[2] * denom)


def repelling_loss(x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                   denom_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean off-diagonal cosine similarity between frame features
    (simnet_pretrain.py:49-69). ``x`` (B, N, D). Padded rows and columns add
    0, so the reference's ``sim.mean(dim=1).mean()`` over ``B * N_padded^2``
    becomes a sum over ``B * denom_len^2`` (default ``reference_pad_len``).

    The norm is safe at all-zero (padded) rows: d||x||/dx = x/||x|| is 0/0
    there, so those rows go round the sqrt and their gradients stay finite;
    the forward value equals the reference's ``x / (norm + 1e-9)``."""
    n_frames = x.shape[1]
    if pad_mask is not None:
        x = x * (~pad_mask)[..., None].to(x.dtype)
    sq = (x * x).sum(dim=2, keepdim=True)
    zero = sq == 0.0
    norm = torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, sq)))
    x = x / (norm + 1e-9)
    sim = torch.einsum("bnd,bmd->bnm", x, x)
    off_diag = ~torch.eye(n_frames, dtype=torch.bool, device=x.device)
    sim = sim * off_diag.to(sim.dtype)[None]
    denom = _denom(denom_len, pad_mask, n_frames, sim)
    return sim.sum() / (sim.shape[0] * denom * denom)

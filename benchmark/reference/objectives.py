"""Plain training objectives and optimizer, written from the published
recipes (BerserkerMother/Video-Summarization ``src/utils/utils.py``,
``src/model/simnet_pretrain.py``, ``src/pretrain.py``, ``src/schedular.py``).

Every mean over the padded length divides by the longest true length of
the batch, which is what the published max-in-batch padding divides by, so
a loss does not depend on how far a length bucket pads.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def true_len(pad_mask: torch.Tensor) -> torch.Tensor:
    return (~pad_mask).sum(dim=1).max().float()


def masked_mse(scores, target, pad_mask) -> torch.Tensor:
    """Finetuning: the squared error of the logits at unpadded frames, summed
    and divided by batch x longest true length."""
    keep = (~pad_mask).to(scores.dtype)
    diff = scores * keep - target * keep
    return (diff * diff).sum() / (scores.shape[0] * true_len(pad_mask))


def pretrain_losses(scores, hidden, video_rep, pad_mask, vt_weight, vt_bias,
                    sharpening_t: float) -> Tuple[torch.Tensor, ...]:
    """(main, center, repel) of the self-supervised objective: soft
    cross-entropy between the sharpened-score mixture of the transformed
    frame features and the video embedding; the entropy of the sharpened
    scores; the mean off-diagonal cosine similarity of the transformed
    frames."""
    feats = torch.matmul(hidden, vt_weight.t()) + vt_bias
    n = true_len(pad_mask)
    B, N, _ = feats.shape

    x = feats * (~pad_mask)[..., None].to(feats.dtype)
    sq = (x * x).sum(dim=2, keepdim=True)
    zero = sq == 0.0
    norm = torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, sq)))
    x = x / (norm + 1e-9)
    sim = torch.einsum("bnd,bmd->bnm", x, x)
    sim = sim * (~torch.eye(N, dtype=torch.bool, device=x.device))[None]
    repel = sim.sum() / (B * n * n)

    s = scores[..., None].masked_fill(pad_mask[..., None], float("-inf"))
    mixture = torch.softmax(s / sharpening_t, dim=1)
    m = mixture + 1e-9
    ent = torch.where(pad_mask[..., None], 0.0, m * torch.log(m))
    center = ent.sum() / (B * n)

    pred = torch.einsum("bnc,bnd->bcd", mixture, feats)[:, 0]
    p1 = torch.softmax(pred, dim=1)
    p2 = torch.softmax(video_rep, dim=1)
    main = (-p2 * torch.log(p1)).mean()
    return main, center, repel


def pretrain_lr(count: int, base_lr: float, steps_per_epoch: int,
                warmup_epochs: int, epochs: int) -> float:
    """Learning rate of update ``count`` (updates taken before it) in the
    published pretraining: the scheduler scales the rate after each step,
    starting at step 0, so the first update takes ``base_lr``, the second
    ``base_lr * scale(0) = 0``, then linear warm-up and cosine decay."""
    if count == 0:
        return base_lr
    prev = count - 1
    warmup = warmup_epochs * steps_per_epoch
    decay = max(steps_per_epoch * epochs - warmup, 1)
    if prev < warmup:
        return base_lr * prev / warmup
    return base_lr * 0.5 * (1 + math.cos((prev - warmup) / decay * math.pi))


class Adam:
    """Adam with coupled weight decay (the gradient takes ``wd * param``
    before the moments), betas (0.9, 0.999), eps 1e-8."""

    def __init__(self, params: Dict[str, torch.Tensor], weight_decay: float):
        self.wd = weight_decay
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        bc1 = 1 - 0.9 ** self.t
        bc2 = 1 - 0.999 ** self.t
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] + self.wd * p
                self.m[k].mul_(0.9).add_(g, alpha=0.1)
                self.v[k].mul_(0.999).add_(g * g, alpha=0.001)
                denom = self.v[k].sqrt() / math.sqrt(bc2) + 1e-8
                p.sub_(lr / bc1 * self.m[k] / denom)

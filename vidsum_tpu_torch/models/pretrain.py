# ported from vidsum_tpu/models/pretrain.py
"""The self-supervised pretraining model and its three-loss objective.

Behaviour (reference: ``src/model/simnet_pretrain.py:12-100``): a SimNet
scorer (``encoder``) and a Linear ``d_model -> 512`` (``video_transform``)
that maps its frame features to the space of the frozen R3D-18 video
embedding. :meth:`PretrainModel.forward` returns the three losses of
``ops/losses.py``:

(a) *main*: soft cross-entropy between the score-weighted mixture of the
    transformed frame features and the video embedding (:95-99, 35-41);
(b) *center*: the entropy of the sharpened score distribution
    (``sharpening_t`` 0.4, :43-47, 84-94);
(c) *repel*: the mean off-diagonal cosine similarity between transformed
    frame features (:49-69).

The step combines them as ``main + 0.5 center + 1.0 repel``
(``src/pretrain.py:63``, the weights in ``PretrainConfig``). The state-dict
keys are the reference ``PretrainModel``'s (``encoder.*``,
``video_transform.*``), so a reference ``pretrain.pth`` loads once its
positional-encoding buffer is dropped (``models.convert.
load_torch_checkpoint``), and the encoder's own ``state_dict`` is a scorer
checkpoint that ``SimNet`` loads.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from vidsum_tpu_torch.config import ModelConfig, PretrainConfig
from vidsum_tpu_torch.device import resolve_device
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.ops.losses import (
    entropy_centering, reference_pad_len, repelling_loss, soft_cross_entropy,
)

VIDEO_REP_DIM = 512  # R3D-18 embedding dim (simnet_pretrain.py:33)


class PretrainModel(nn.Module):
    """``encoder`` (a :class:`SimNet`) and ``video_transform`` (Linear
    d_model -> 512), both initialised from ``generator`` (default: seed 0)
    as ``SimNet`` initialises its Linears, the encoder first.
    ``pretrain_cfg`` (default ``PretrainConfig()``) gives ``sharpening_t``."""

    def __init__(self, cfg: ModelConfig,
                 pretrain_cfg: Optional[PretrainConfig] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.pretrain_cfg = pretrain_cfg or PretrainConfig()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.encoder = SimNet(cfg, device=dev, generator=generator)
        self.video_transform = nn.Linear(cfg.d_model, VIDEO_REP_DIM)
        with torch.no_grad():
            bound = 1.0 / math.sqrt(cfg.d_model)
            for p in (self.video_transform.weight, self.video_transform.bias):
                p.uniform_(-bound, bound, generator=generator)
        self.video_transform.to(dev)

    def forward(self, x: torch.Tensor, video_rep: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None, *,
                attn_impl: Optional[str] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                block_seeds: Optional[Sequence[int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(main, center, repel)`` for frame features x (B, N, 1024),
        video reps (B, 512) and pad_mask (B, N) bool, True at padded frames
        (the JAX ``pretrain_apply``). ``attn_impl``, ``deterministic``,
        ``generator`` and ``block_seeds`` go to the encoder
        (``SimNet.forward``)."""
        scores, hidden = self.encoder(
            x, pad_mask, attn_impl=attn_impl, deterministic=deterministic,
            generator=generator, block_seeds=block_seeds)
        return self.objective(scores, hidden, video_rep, pad_mask)

    def objective(self, scores: torch.Tensor, hidden: torch.Tensor,
                  video_rep: torch.Tensor,
                  pad_mask: Optional[torch.Tensor] = None,
                  denom_len: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The three losses from the encoder's scores (B, N, 1) and hidden
        states (B, N, d): ``video_transform`` on the hidden states (cast to
        its dtype), the sharpened softmax of the scores with -inf at pads,
        and the reference pad length as the denominator (``denom_len``: the
        global batch's, which a step over one shard of the batch passes)."""
        vt = self.video_transform
        dev = hidden.device
        feats = (torch.matmul(hidden.to(vt.weight.dtype),
                              vt.weight.to(dev).t()) + vt.bias.to(dev))

        # center and repel divide by the reference pad length (the max true
        # length in the batch), not the bucket width: ops/losses.py
        ref_len = (reference_pad_len(pad_mask, hidden.shape[1])
                   if denom_len is None else denom_len).to(feats.device)
        repel = repelling_loss(feats, pad_mask, denom_len=ref_len)

        if pad_mask is not None:
            scores = scores.masked_fill(pad_mask[..., None], float("-inf"))
        mixture = torch.softmax(scores / self.pretrain_cfg.sharpening_t,
                                dim=1)
        center = entropy_centering(mixture + 1e-9, pad_mask,
                                   denom_len=ref_len)

        # (B, 1, N) @ (B, N, 512) -> (B, 512): the score-weighted mixture
        pred = torch.einsum("bnc,bnd->bcd", mixture, feats).squeeze(1)
        main = soft_cross_entropy(pred, video_rep.to(pred.dtype))
        return main, center, repel

# ported from vidsum_tpu/train/steps.py (make_eval_forward only; the train
# steps arrive with the training slice)
"""The eval forward: padded features -> sigmoid frame scores."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.device import resolve_device


def make_eval_forward(cfg: ModelConfig, attn_impl: Optional[str] = None, *,
                      device=None) -> Callable:
    """Returns ``fwd(model, x, pad_mask) -> sigmoid scores (B, N)`` (f32, on
    ``device``), the reference's val-time ``Sigmoid()(output)``
    (train.py:144). ``x`` and ``pad_mask`` may be numpy arrays or tensors;
    they move to ``device`` (default: the CUDA card, which must exist).
    ``attn_impl`` defaults to ``"fused_block"`` on CUDA and ``"dense"`` on
    the CPU."""
    dev = resolve_device(device)
    if attn_impl is None:
        attn_impl = "fused_block" if dev.type == "cuda" else "dense"

    def fwd(model, x, pad_mask):
        with torch.inference_mode():
            x = torch.as_tensor(x).to(dev)
            if pad_mask is not None:
                pad_mask = torch.as_tensor(pad_mask).to(dev)
            scores, _ = model(x, pad_mask, attn_impl=attn_impl)
            return torch.sigmoid(scores[..., 0])

    fwd.attn_impl = attn_impl
    return fwd

# ported from vidsum_tpu/train/steps.py (make_optimizer, make_finetune_step
# and make_eval_forward; the pretrain step arrives with the pretrain slice)
"""The finetune step and the eval forward.

- finetune step (reference ``src/train.py:111-131``): masked MSE over raw
  logits, Adam with torch-style coupled weight decay (``train.py:35-36``).
  The JAX step is one jitted program that donates params and optimizer
  state; here the step updates the model's parameters and the optimizer's
  state in place, which is what donation buys there.
- eval forward (reference ``src/train.py:134-152``): sigmoid scores.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.device import resolve_device
from vidsum_tpu_torch.ops.losses import mse_with_mask_loss


def make_optimizer(model: torch.nn.Module, lr: float,
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam with coupled weight decay (grad += wd * param before the moment
    updates): the JAX package's ``optax.add_decayed_weights`` + ``adam``."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)


def make_finetune_step(cfg: ModelConfig, attn_impl: Optional[str] = None, *,
                       device=None) -> Callable:
    """Returns ``step(model, optimizer, x, target, pad_mask, generator,
    block_seeds=None) -> loss`` (a 0-d tensor on ``device``, not
    synchronised). Inputs may be numpy arrays or tensors and move to
    ``device`` (default: the CUDA card, which must exist). ``attn_impl``
    ``None`` or ``"auto"`` (``TrainConfig.attn_impl``) means
    ``"fused_block"`` on CUDA and ``"dense"`` on the CPU. ``"fused_block"``
    demotes to ``"flash"`` past ``fused_block_train_supported`` (long
    videos), and ``"flash"`` trains through
    ``ops/attention_train.flash_attention_dropout`` at every length up to
    that route's envelope (``flash_train_supported``), past which it raises
    ``ValueError``. ``generator`` draws the dropout (see ``SimNet.forward``
    for ``block_seeds``). The step leaves the gradients in ``.grad``."""
    dev = resolve_device(device)
    if attn_impl in (None, "auto"):
        attn_impl = "fused_block" if dev.type == "cuda" else "dense"

    def step(model, optimizer, x, target, pad_mask, generator,
             block_seeds: Optional[Sequence[int]] = None):
        x, target, pad_mask = (torch.as_tensor(a).to(dev)
                               for a in (x, target, pad_mask))
        optimizer.zero_grad(set_to_none=True)
        scores, _ = model(x, pad_mask, attn_impl=attn_impl,
                          deterministic=False, generator=generator,
                          block_seeds=block_seeds)
        loss = mse_with_mask_loss(scores, target, pad_mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    step.attn_impl = attn_impl
    return step


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

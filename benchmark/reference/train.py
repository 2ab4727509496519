"""The reference's first three training steps from the same weights,
batches and dropout generator seed that the system under test was handed.

It returns the readings :func:`benchmark.reference.compare.training`
compares: each step's loss, the norm of every leaf's first gradient as
Adam takes it (with the coupled weight decay), the norm of each leaf's raw
first gradient, and the norm of each leaf's change over the three steps.
``tf32`` runs the products in TF32 (the control: the precision below the
configuration's float32); ``half`` trains on the first half of each batch
only (the planted fault "half of the batch left out").
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from benchmark.reference.objectives import (
    Adam, masked_mse, pretrain_losses, pretrain_lr,
)
from benchmark.reference.simnet import DropoutPlan, forward, param_shapes


def follow(config: dict, traffic: dict, weights: Dict[str, torch.Tensor],
           batches: Sequence[tuple], gen_seed: int, device, *,
           tf32: bool = False, half: bool = False) -> dict:
    pretrain = traffic["step"] == "pretrain"
    hp = config["pretrain"] if pretrain else config["train"]
    params = {k: weights[k].detach().clone() for k in param_shapes(config)}
    frozen = {k: v for k, v in weights.items() if k not in params}
    start = {k: v.clone() for k, v in params.items()}
    opt = Adam(params, hp["weight_decay"])
    gen = torch.Generator().manual_seed(gen_seed)
    losses: List[float] = []
    grad = grad_raw = None
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for step, (x, y, mask) in enumerate(batches):
            if half:
                keep = x.shape[0] // 2
                x, y, mask = x[:keep], y[:keep], mask[:keep]
            x, y, mask = (torch.as_tensor(a).to(device) for a in (x, y, mask))
            for v in params.values():
                v.requires_grad_(True)
            plan = DropoutPlan(traffic["route"], config["dropout"], gen,
                               device)
            scores, hidden = forward({**params, **frozen}, config, x, mask,
                                     plan)
            if pretrain:
                main, center, repel = pretrain_losses(
                    scores, hidden, y, mask, frozen["video_transform.weight"],
                    frozen["video_transform.bias"], hp["sharpening_t"])
                loss = (main + hp["center_weight"] * center
                        + hp["repel_weight"] * repel)
            else:
                loss = masked_mse(scores, y, mask)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            del scores, hidden
            for v in params.values():
                v.requires_grad_(False)
            if step == 0:
                wd = hp["weight_decay"]
                grad = {k: float((grads[k] + wd * params[k]).norm())
                        for k in params}
                grad_raw = {k: float(g.norm()) for k, g in grads.items()}
            lr = (pretrain_lr(step, hp["lr"],
                              max(hp["scheduler_samples"]
                                  // hp["batch_size"], 1),
                              hp["warmup_epochs"], hp["epochs"])
                  if pretrain else hp["lr"])
            opt.step(params, grads, lr)
            losses.append(float(loss.detach()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    delta = {k: float((params[k] - start[k]).norm()) for k in params}
    return {"losses": losses, "grad": grad, "grad_raw": grad_raw,
            "delta": delta}

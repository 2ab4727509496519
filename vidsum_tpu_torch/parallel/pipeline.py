# ported from vidsum_tpu/parallel/pipeline.py
"""Pipeline parallelism over the encoder's layers by weight streaming.

The layers' memory shards over a ``stage`` mesh axis: stage s owns layers
``[s * L / S, (s + 1) * L / S)``, whose parameters (and, in training, Adam
moments) live on its entry. The batch is data-parallel over the same
entries, and for each layer in order the owner's block is streamed to every
entry (``.to``: the JAX all-gather; the tensor itself where the entries
share a device) and applied there to that entry's rows. A block's weights
are far smaller than a shard's activations at SimNet's sizes, so streaming
weights moves fewer bytes than passing activations, there is no pipeline
bubble, and each entry's parameter memory drops by the stage count.

Training: the gradient of a streamed block flows back through the copy to
the owner's parameters, so each entry's contribution sums there (the JAX
all-gather's VJP, a psum-scatter); embed and head, replicated, get every
entry's gradient too. Each entry's gradients are taken on their own and
summed in a fixed tree, then divided by S: the JAX step's pmean of embed and
head and its block grads over S. The attention is the dense route (the
JAX package's ``"xla"``), dropout the sharded steps' global-coordinate
hashes (``parallel/train_parallel.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.ops.losses import mse_with_mask_loss
from vidsum_tpu_torch.parallel.distributed import (
    all_reduce, axis_entries, process_count, process_index, put_batch,
)
from vidsum_tpu_torch.parallel.dp_shardmap import (
    apply_grads, draw_seeds, global_denominators, shard_grads, sum_shards,
    trained_params,
)
from vidsum_tpu_torch.parallel.mesh import DeviceMesh, on
from vidsum_tpu_torch.parallel.train_parallel import sharded_forward


def stack_blocks(model) -> Dict[str, torch.Tensor]:
    """The encoder blocks' parameters stacked on a leading layer axis, by
    block-relative key (``"sa.q.weight"`` -> (L, d, d)); detached."""
    blocks = [b.state_dict() for b in model.encoder.module_list]
    return {k: torch.stack([b[k].to(blocks[0][k].device) for b in blocks])
            for k in blocks[0]}


def owner(layer: int, per_stage: int) -> tuple:
    """``(stage, index there)`` of the stage that owns ``layer``."""
    return divmod(layer, per_stage)


def _stages(cfg: ModelConfig, mesh: DeviceMesh, stage_axis: str,
            what: str) -> tuple:
    n_stages = mesh.shape[stage_axis]
    if mesh.size != n_stages:
        raise ValueError(f"the pipeline shards {stage_axis!r} only; mesh "
                         f"{mesh.shape} has other axes past size 1")
    if cfg.num_layers % n_stages:
        raise ValueError(f"{cfg.num_layers} layers not divisible by "
                         f"{n_stages} stages")
    if cfg.use_cls:
        raise ValueError(f"pipeline {what} does not support CLS tokens")
    return axis_entries(mesh, stage_axis), cfg.num_layers // n_stages


def _streamed(model, per_stage: int):
    """``blocks(layer)``: the owner stage's block for ``layer``."""
    layers = model.encoder.module_list

    def blocks(layer: int):
        stage, local = owner(layer, per_stage)
        return layers[stage * per_stage + local]

    return blocks


def make_pp_forward(cfg: ModelConfig, mesh: DeviceMesh,
                    stage_axis: str = "stage"):
    """``fwd(model, x, pad_mask) -> scores`` (B, N, 1) on the first entry:
    the deterministic scorer with the encoder's blocks streamed from their
    owner stages and the batch data-parallel over ``stage_axis``."""
    devs, per_stage = _stages(cfg, mesh, stage_axis, "forward")

    def fwd(model, x, pad_mask):
        with torch.inference_mode():
            xs, ms = put_batch(mesh, x,
                               torch.as_tensor(pad_mask, dtype=torch.bool),
                               batch_axis=stage_axis)
            blocks = _streamed(model, per_stage)
            outs = []
            for j, dev in enumerate(devs):
                [scores], _, _ = sharded_forward(
                    model, cfg, [[dev]], xs[j], ms[j],
                    [0] * cfg.num_layers, 0.0, 0, blocks)
                outs.append(scores.to(devs[0]))
            return torch.cat(outs)

    return fwd


def make_pp_train_step(cfg: ModelConfig, mesh: DeviceMesh,
                       stage_axis: str = "stage"):
    """Weight-streaming pipeline training: ``(init_fn, step_fn)``.

    ``init_fn(model)`` moves each encoder block to its owner stage's entry
    (in place; nothing moves where the entries repeat a device) and returns
    the model; make the optimizer after it, so its moments live beside
    their parameters. ``step_fn(model, optimizer, x, target, pad_mask,
    generator=None, seeds=None) -> loss`` takes one step with the batch
    data-parallel over the stages. ``model.state_dict()`` keeps the
    reference's keys: ``model.to(device)`` gathers it onto one device."""
    devs, per_stage = _stages(cfg, mesh, stage_axis, "training")

    def init_fn(model):
        for layer, block in enumerate(model.encoder.module_list):
            block.to(devs[owner(layer, per_stage)[0]])
        return model

    def step_fn(model, optimizer, x, target, pad_mask,
                generator: Optional[torch.Generator] = None, seeds=None):
        [seeds] = draw_seeds(generator, 1, cfg.num_layers,
                             None if seeds is None else [seeds])
        S, rank = len(devs), process_index()
        Sg = S * process_count()
        xs, ts, ms = put_batch(mesh, x, target,
                               torch.as_tensor(pad_mask, dtype=torch.bool),
                               batch_axis=stage_axis)
        denom, _ = global_denominators(ms, devs[0])
        params = trained_params(optimizer)
        blocks = _streamed(model, per_stage)
        per_entry, losses = [], []
        for j, dev in enumerate(devs):
            Bl = ms[j].shape[0]
            [scores], _, _ = sharded_forward(
                model, cfg, [[dev]], xs[j], ms[j], seeds, cfg.dropout,
                (rank * S + j) * Bl, blocks)
            with on(dev):
                loss = mse_with_mask_loss(scores, ts[j], ms[j],
                                          denom_len=denom.to(dev))
            per_entry.append(shard_grads(loss, params))
            losses.append([loss.detach().to(devs[0])])
        apply_grads(optimizer, params, sum_shards(per_entry), 1.0 / Sg)
        [loss] = all_reduce(sum_shards(losses))
        return loss / Sg

    return init_fn, step_fn

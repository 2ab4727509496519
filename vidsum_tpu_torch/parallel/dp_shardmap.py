# ported from vidsum_tpu/parallel/dp_shardmap.py
"""Data-parallel finetuning that keeps the hand-written kernels.

The JAX package runs one program per device under ``shard_map``: every
device trains on its rows of the batch with the fused Pallas kernels, and
the gradients are averaged over the ``data`` axis (the one collective the
reference's semantics need). Here one process runs the same program per
mesh entry: each data shard's forward and backward is the port's
single-device training forward (``SimNet`` on ``"fused_block"`` on CUDA:
``ops/block_train.fused_block_train``, TPU kernels 9-12, demoting to the
flash route, kernels 5-8, past ``fused_block_train_supported``) on its rows,
on its entry. The JAX collectives become explicit sums:

- ``pmean`` / ``psum`` of the gradients: each shard's gradients are taken
  by their own ``torch.autograd.grad`` into buffers of their own and summed
  in a fixed tree (:func:`sum_shards`), then all-reduced over the processes
  of a multi-process run (``parallel/distributed.py``). Where the entries
  repeat one card the replicas are one module, and leaving the sum to
  ``.grad`` accumulation would add the shards in whatever order autograd
  reaches them: the fixed order makes two runs give the same bits;
- ``pmax`` of each shard's reference pad length: the loss's denominator is
  the global batch's longest video, not the shard's.

Parameters and Adam state stay whole on the mesh's first entry (shards on
other cards run a ``torch.nn.parallel.replicate`` copy, whose parameter
gradients come back to it), so checkpoints are those of one device.
"""

from __future__ import annotations

import operator
from typing import List, Optional, Sequence

import torch

from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.ops.losses import mse_with_mask_loss, reference_pad_len
from vidsum_tpu_torch.parallel.distributed import (
    all_reduce, axis_entries, process_count, process_index, put_batch,
)
from vidsum_tpu_torch.parallel.mesh import DeviceMesh, on
from vidsum_tpu_torch.parallel.seq_forward import _replicas


def sum_shards(per_shard: Sequence[List[torch.Tensor]]
               ) -> List[torch.Tensor]:
    """The shards' gradient lists summed tensor by tensor as a pairwise tree
    in shard order, ((g0 + g1) + (g2 + g3)) + ..., on the first shard's
    device: the order is fixed whatever device each lies on, and a
    multi-process run continues the tree (each process's over its shards,
    then the all-reduce over the processes), so with a power-of-two count
    of shards a process, D shards give the same bits in one process as
    over several."""
    level = [list(g) for g in per_shard]
    while len(level) > 1:
        pairs = [[a + b.to(a.device)
                  for a, b in zip(level[i], level[i + 1])]
                 for i in range(0, len(level) - 1, 2)]
        level = pairs + level[len(pairs) * 2:]
    return level[0]


def trained_params(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """The parameters ``optimizer`` updates, in its order."""
    return [p for group in optimizer.param_groups for p in group["params"]]


def shard_grads(loss: torch.Tensor, params: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """d loss / d params into buffers of their own (zeros for a parameter
    the loss does not reach, as JAX's gradient gives)."""
    grads = torch.autograd.grad(loss, list(params), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def apply_grads(optimizer: torch.optim.Optimizer,
                params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], scale: float) -> None:
    """All-reduce ``grads`` over the processes, multiply them by ``scale``
    (1 / the global shard count for a mean), set them as the parameters'
    ``.grad`` and take one optimizer step."""
    grads = all_reduce(grads)
    for p, g in zip(params, grads):
        p.grad = (g * scale).to(p.device)
    optimizer.step()


def global_denominators(masks: Sequence[torch.Tensor], home: torch.device,
                        weights: Optional[Sequence[torch.Tensor]] = None):
    """``(denom_len, weight sum)`` of the global batch: the max over the
    shards (and the processes) of ``reference_pad_len``, the JAX step's
    ``pmax``, and the sum of the item weights (its ``psum``; None without
    weights)."""
    denom = torch.stack([reference_pad_len(m).to(home) for m in masks]).max()
    [denom] = all_reduce([denom], op="max")
    if weights is None:
        return denom, None
    wsum = sum_shards([[w.float().sum().to(home)] for w in weights])[0]
    [wsum] = all_reduce([wsum])
    return denom, wsum


def shard_modules(model, devs: Sequence[torch.device],
                  params: Sequence[torch.Tensor]):
    """``{device: (module there, the tensors that stand for params in
    it)}``: the model and its own parameters on its device, a
    ``torch.nn.parallel.replicate`` copy and its parameter copies (which
    autograd reaches without passing back to the model) on every other
    card."""
    names = {id(p): n for n, p in model.named_parameters()}
    mods = _replicas(model, devs, detach=False)
    return {d: (m, [operator.attrgetter(names[id(p)])(m) for p in params])
            for d, m in mods.items()}


def draw_seeds(generator: Optional[torch.Generator], rows: int, cols: int,
               seeds=None) -> List[List[int]]:
    """A (rows, cols) table of dropout seeds: ``seeds`` as given, or
    ``torch.randint(0, 2**31 - 1)`` draws from ``generator``."""
    if seeds is None:
        if generator is None:
            raise ValueError("the step draws its dropout seeds from "
                             "generator; pass one, or seeds")
        seeds = torch.randint(0, 2**31 - 1, (rows, cols),
                              generator=generator,
                              device=generator.device).tolist()
    seeds = [[int(s) for s in row] for row in seeds]
    if len(seeds) != rows or any(len(r) != cols for r in seeds):
        raise ValueError(f"seeds must be a ({rows}, {cols}) table")
    return seeds


def shard_generator(seeds: Sequence[int]) -> torch.Generator:
    """The generator a shard's plain dropout sites draw from (the flash and
    dense routes' residual and MLP dropout): seeded with the shard's first
    layer seed, so a replay of the shard's single-device step with the
    same seeds draws the same masks."""
    return torch.Generator().manual_seed(int(seeds[0]))


def make_dp_shardmap_finetune_step(cfg: ModelConfig, mesh: DeviceMesh,
                                   attn_impl: Optional[str] = None,
                                   data_axis: str = "data"):
    """``step(model, optimizer, x, target, pad_mask, generator=None,
    item_weight=None, seeds=None) -> loss`` (a 0-d tensor on the mesh's
    first entry, not synchronised) with the batch split over ``data_axis``
    and each shard trained by the single-device forward on its entry
    (``attn_impl`` None: ``"fused_block"`` on CUDA, ``"dense"`` on the
    CPU). The mesh's other axes must have size 1.

    - Dropout: shard i of the run's D shards runs ``SimNet`` with
      ``block_seeds=seeds[i]`` (the kernels' per-layer seeds) and
      :func:`shard_generator` of them: the JAX step's ``fold_in(rng,
      axis_index)``. ``seeds`` (D, num_layers) gives them, else they are
      drawn from ``generator``.
    - Loss: each shard's masked MSE over its rows divided by ``rows *
      denom_len`` (the global pmax), averaged over the shards; with
      ``item_weight`` (a padded final batch) each shard's weighted sum over
      ``sum(w) * denom_len`` of the global batch, summed (the JAX step's
      psum), which is the smaller batch's mean.
    - One optimizer step on the gradients summed in a fixed tree
      (:func:`sum_shards`) and scaled alike.
    """
    if mesh.size != mesh.shape[data_axis]:
        raise ValueError(f"the data-parallel step shards {data_axis!r} only; "
                         f"mesh {mesh.shape} has other axes past size 1")
    devs = axis_entries(mesh, data_axis)
    home = devs[0]
    if attn_impl is None:
        attn_impl = "fused_block" if home.type == "cuda" else "dense"
    L = cfg.num_layers

    def step(model, optimizer, x, target, pad_mask,
             generator: Optional[torch.Generator] = None, item_weight=None,
             seeds=None):
        D, rank = len(devs), process_index()
        Dg = D * process_count()
        seeds = draw_seeds(generator, Dg, L, seeds)
        xs, ts, ms, ws = put_batch(mesh, x, target,
                                   torch.as_tensor(pad_mask, dtype=torch.bool),
                                   item_weight, batch_axis=data_axis)
        denom, wsum = global_denominators(ms, home, ws)
        params = trained_params(optimizer)
        mods = shard_modules(model, devs, params)
        per_shard, losses = [], []
        for i, dev in enumerate(devs):
            module, tensors = mods[dev]
            row = seeds[rank * D + i]
            with on(dev):
                scores, _ = module(xs[i], ms[i], attn_impl=attn_impl,
                                   deterministic=False,
                                   generator=shard_generator(row),
                                   block_seeds=row)
                if ws is None:
                    loss = mse_with_mask_loss(scores, ts[i], ms[i],
                                              denom_len=denom.to(dev))
                else:
                    loss = mse_with_mask_loss(
                        scores, ts[i], ms[i], reduction="sum",
                        item_weight=ws[i]) / (wsum * denom).to(dev)
                per_shard.append(shard_grads(loss, tensors))
            losses.append([loss.detach()])
        scale = 1.0 if ws is not None else 1.0 / Dg
        apply_grads(optimizer, params, sum_shards(per_shard), scale)
        [loss] = all_reduce(sum_shards(losses))
        return loss * scale

    step.attn_impl = attn_impl
    return step

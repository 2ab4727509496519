# ported from vidsum_tpu/parallel/seq_forward.py
"""Sequence-parallel SimNet: the scorer forward and the finetune step over a
(data, seq) :class:`~vidsum_tpu_torch.parallel.mesh.DeviceMesh`, for videos
too long for one device's attention.

Every position-wise op (embedding, LayerNorm, MLP, head) runs on its own
shard, the positional encoding is indexed at the shard's global offset, and
attention runs as the exact ring of ``parallel/ring_attention.py``, so
activations scale as O(N / P) and no N x N tensor exists. The JAX package
runs one program per device under ``shard_map``; here one process runs one
``SimNet.forward_steps`` generator per shard and advances them in lockstep,
running the ring over a mesh row's shards at every layer's attention.

Parameters: the model lives on one device. Shards on that device use it;
shards on other cards use a copy from ``torch.nn.parallel.replicate``, which
is differentiable, so in training every shard's gradient sums into the one
parameter set (the JAX step's psum over both mesh axes).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.ops.block_train import (
    MAX_HASH_HEADS, S_MLP, S_RES1, S_RES2,
)
from vidsum_tpu_torch.ops.losses import mse_with_mask_loss, reference_pad_len
from vidsum_tpu_torch.parallel.mesh import DeviceMesh, on, place
from vidsum_tpu_torch.parallel.ring_attention import (
    KEY_TILE, hash_keep3d, ring_attention, ring_attention_train,
)

__all__ = ["hash_keep3d", "make_seq_sharded_finetune_step",
           "make_seq_sharded_forward"]


def _replicas(model, devices: Sequence[torch.device], detach: bool) -> dict:
    """``{device: model there}``: the model itself on its own device, a
    ``torch.nn.parallel.replicate`` copy on every other card of the mesh."""
    home = next(model.parameters()).device
    others = sorted({d for d in devices if d != home}, key=str)
    models = {home: model}
    if others:
        if home.type != "cuda" or any(d.type != "cuda" for d in others):
            raise ValueError(f"the model lives on {home}; a mesh over several "
                             f"devices must consist of CUDA cards, the "
                             f"model's among them, got "
                             f"{sorted(set(map(str, devices)))}")
        copies = torch.nn.parallel.replicate(model, [home] + others,
                                             detach=detach)
        models.update(zip(others, copies[1:]))
    return models


def _pad_shards(P: int, pad_mask, *tensors):
    """``(pad_mask, *tensors)`` with the global length padded at its end to a
    multiple of ``KEY_TILE * P`` where a shard of N / P frames is not a
    multiple of the ring kernels' 64-key tile (and unchanged where it is).
    Padded frames are masked keys with zero inputs; real frames keep their
    global positions and dropout coordinates (both follow ``s * Nl``), so
    outputs on them are unchanged up to f32 summation order."""
    B, N = pad_mask.shape
    if (N // P) % KEY_TILE == 0:
        return (pad_mask, *tensors)
    extra = -(-N // (KEY_TILE * P)) * KEY_TILE * P - N

    def grow(t, fill):
        tail = t.new_full((B, extra, *t.shape[2:]), fill)
        return torch.cat([t, tail], dim=1)

    return (grow(pad_mask, True), *(grow(t, 0) for t in tensors))


def _lockstep(mesh: DeviceMesh, gens: list, attend) -> list:
    """Advance a (data, seq) grid of ``forward_steps`` generators together,
    each with its mesh entry as the current device. At every attention,
    ``attend(row, requests)`` takes the row's ``(q, k, v, pad_mask)``
    requests and returns its outputs. Returns the grid of the generators'
    results."""
    sends = [[None] * len(row) for row in gens]
    while True:
        requests, results = [], []
        for row, row_sends, devs in zip(gens, sends, mesh.grid):
            reqs, done = [], []
            for g, x, dev in zip(row, row_sends, devs):
                try:
                    with on(dev):
                        reqs.append(g.send(x))
                except StopIteration as stop:
                    done.append(stop.value)
            if reqs and done:
                raise RuntimeError("the shards of a ring left the layer loop "
                                   "at different layers")
            requests.append(reqs)
            results.append(done)
        if all(results):
            return results
        sends = [attend(i, reqs) for i, reqs in enumerate(requests)]


def make_seq_sharded_forward(cfg: ModelConfig, mesh: DeviceMesh,
                             block_impl: str = "auto"):
    """``fwd(model, x, pad_mask) -> (scores, hidden)``: the deterministic
    scorer with x (B, N, D) split over (data, seq) and the outputs gathered
    on the mesh's first device. ``fwd.sharded(model, xs, masks)`` takes and
    returns (data, seq) grids of shards already on their mesh entries (the
    serving long route ships rows that way). Requires ``use_cls=False`` (the
    flagship config)."""
    if cfg.use_cls:
        raise ValueError("sequence-parallel forward does not support CLS "
                         "tokens (per-shard prepend would corrupt the ring)")
    P = mesh.shape["seq"]

    def sharded(model, xs: list, masks: list) -> list:
        Nl = xs[0][0].shape[1]
        models = _replicas(model, mesh.devices, detach=True)
        gens = [[models[x.device].forward_steps(
            x, m, deterministic=True, yield_attention=True,
            pos_offset=s * Nl, pe_len=P * Nl)
            for s, (x, m) in enumerate(zip(xr, mr))]
            for xr, mr in zip(xs, masks)]

        def attend(_, reqs):
            q, k, v, pm = zip(*reqs)
            return ring_attention(q, k, v, pm, cfg.attn_scale, block_impl)

        return _lockstep(mesh, gens, attend)

    def fwd(model, x, pad_mask):
        with torch.inference_mode():
            x = torch.as_tensor(x)
            pad_mask = torch.as_tensor(pad_mask, dtype=torch.bool)
            N = pad_mask.shape[1]
            if N % P:
                raise ValueError(f"length {N} must split over {P} shards")
            pad_mask, x = _pad_shards(P, pad_mask, x)
            out = sharded(model, place(mesh, x), place(mesh, pad_mask))
            home = mesh.grid[0][0]
            return tuple(torch.cat([torch.cat([o[j].to(home) for o in row],
                                              dim=1) for row in out],
                                   dim=0)[:, :N]
                         for j in range(2))

    fwd.sharded = sharded
    return fwd


def make_seq_sharded_finetune_step(cfg: ModelConfig, mesh: DeviceMesh,
                                   block_impl: str = "auto"):
    """Sequence-parallel training: ``step(model, optimizer, x, target,
    pad_mask, generator=None, seeds=None) -> loss`` (a 0-d tensor, not
    synchronised) with the batch over ``data`` and the sequence over
    ``seq``: masked-MSE finetuning of videos past one device's attention,
    then one step of ``optimizer`` (``train.steps.make_optimizer``).

    - Attention is :func:`ring_attention_train`: on CUDA the fused ring
      (TPU kernels 16/17, P x P launches per layer each way) at every
      length; on the CPU the plain ring with per-step recompute.
    - Every dropout site draws coordinate-absolute hash masks: the attention
      weights inside the ring, residual and MLP sites from
      :func:`hash_keep3d` at the shard's (b0, row0), so loss and gradients
      do not depend on the mesh shape and equal a dense replay with the
      same masks.
    - Per-layer seeds are ``torch.randint(0, 2**31 - 1)`` draws from
      ``generator``; ``seeds`` gives them instead (the JAX step's seeds in
      the tests).
    - The loss is each shard's masked-MSE sum over the global ``B * L``
      (``L`` the longest video of the batch), summed over the shards: the
      global batch-mean loss; autograd over the shards sums every gradient
      into the model's parameters.
    - Where N / P is not a multiple of the ring kernels' 64-key tile, the
      global length is padded at its end to a multiple of 64 P
      (:func:`_pad_shards`): the padded frames are masked, so the loss and
      every gradient are those of the unpadded batch.
    """
    if cfg.use_cls:
        raise ValueError("sequence-parallel training does not support CLS "
                         "tokens")
    if cfg.pos_dropout:
        raise ValueError("pos_dropout > 0 is not wired for the seq-sharded "
                         "step (0.0 in every reference recipe)")
    if cfg.num_heads > MAX_HASH_HEADS:
        # the ring's attention sites are the raw head indices; heads >= 32
        # would collide with S_RES1/S_MLP/S_RES2
        raise ValueError(f"num_heads {cfg.num_heads} > {MAX_HASH_HEADS} "
                         "collides with the residual/MLP dropout sites")
    D, P = mesh.shape["data"], mesh.shape["seq"]
    L, d, rate = cfg.num_layers, cfg.d_model, cfg.dropout
    hid = d * cfg.mlp_scale

    def step(model, optimizer, x, target, pad_mask,
             generator: Optional[torch.Generator] = None,
             seeds: Optional[Sequence[int]] = None):
        if seeds is None:
            if generator is None:
                raise ValueError("the step draws its dropout seeds from "
                                 "generator; pass one, or seeds")
            seeds = torch.randint(0, 2**31 - 1, (L,), generator=generator,
                                  device=generator.device).tolist()
        seeds = [int(s) for s in seeds]
        x, target = torch.as_tensor(x), torch.as_tensor(target)
        pad_mask = torch.as_tensor(pad_mask, dtype=torch.bool)
        B, N = pad_mask.shape
        if B % D or N % P:
            raise ValueError(f"batch {B} and length {N} must split over the "
                             f"({D}, {P}) mesh")
        home = mesh.grid[0][0]
        denom = B * reference_pad_len(pad_mask).to(home)
        pad_mask, x, target = _pad_shards(P, pad_mask, x, target)
        N = pad_mask.shape[1]
        Bl, Nl = B // D, N // P
        optimizer.zero_grad(set_to_none=True)
        models = _replicas(model, mesh.devices, detach=False)
        xs, ts, ms = (place(mesh, t) for t in (x, target, pad_mask))
        gens = []
        for i in range(D):
            row = []
            for s in range(P):
                dev = mesh.grid[i][s]
                masks = [{"attn": None, **{
                    key: hash_keep3d(seeds[li], site, i * Bl, s * Nl,
                                     (Bl, Nl, width), rate, dev)
                    for key, site, width in (("res1", S_RES1, d),
                                             ("mlp", S_MLP, hid),
                                             ("res2", S_RES2, d))}}
                    for li in range(L)]
                row.append(models[dev].forward_steps(
                    xs[i][s], ms[i][s], deterministic=False,
                    yield_attention=True, pos_offset=s * Nl, pe_len=N,
                    dropout_masks=masks))
            gens.append(row)
        layer = [0] * D

        def attend(i, reqs):
            q, k, v, pm = zip(*reqs)
            li, layer[i] = layer[i], layer[i] + 1
            return ring_attention_train(q, k, v, pm, cfg.attn_scale,
                                        seeds[li], rate, b0=i * Bl,
                                        block_impl=block_impl)

        results = _lockstep(mesh, gens, attend)
        loss = sum(
            (mse_with_mask_loss(scores, ts[i][s], ms[i][s], reduction="sum")
             .to(home) / denom)
            for i, row in enumerate(results)
            for s, (scores, _) in enumerate(row))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step

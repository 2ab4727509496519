# ported from vidsum_tpu/parallel/train_parallel.py
"""Sharded training steps: data x tensor parallelism over a ``("data",
"model")`` mesh, with an optional sequence axis (``("data", "seq",
"model")``), for finetuning and pretraining.

The JAX package writes these steps as one ``jax.jit`` with sharding
annotations and lets GSPMD insert the collectives. GSPMD cannot partition a
``pallas_call``, so the JAX step runs ``attn_impl="xla"``; the routes map
one to one, so this step runs the port's counterpart, SimNet's dense route
(plain PyTorch attention with dropout on the weights), on the card too. It
is the JAX package's own route for this mode, not a fallback. (Pure data
parallelism keeps the kernels: ``parallel/dp_shardmap.py``.)

One process runs every shard: data row i of the mesh trains on its rows of
the batch; within it, each ``model`` entry holds whole heads and a block of
MLP channels (``parallel/sharding.py``), each ``seq`` entry a contiguous
block of frames. Position-wise ops run on each seq shard's first entry; the
attention of a seq shard's queries reads every shard's keys and values
(``.to`` of the blocks: the JAX all-gather); the row-parallel products'
partial sums are summed over ``model`` in shard order before the bias and
the residual (:func:`sum_partials`, the JAX psum). Gradients flow back
through the parameter slices into the whole parameters on the mesh's first
entry; each data row's are taken on their own and summed in a fixed tree
(``dp_shardmap.sum_shards``), then all-reduced over the processes of a
multi-process run.

Dropout draws counter hashes at global coordinates, the family the
sequence-parallel step draws: the attention weights from
``ring_hash_keep`` (site = the global head), the residual and MLP sites from
``hash_keep3d`` (the MLP's at the shard's global channel offset). The masks
therefore do not depend on the mesh shape: a step equals the dense
single-device step run with :func:`dropout_masks` of the same seeds. JAX's
threefry bits cannot be reproduced here, so against the JAX package the
steps compare at dropout 0, as the JAX tests do.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from vidsum_tpu_torch.config import ModelConfig, PretrainConfig
from vidsum_tpu_torch.device import dtype_of
from vidsum_tpu_torch.models.simnet import _affine, _apply_keep, _layernorm
from vidsum_tpu_torch.ops.block_train import S_MLP, S_RES1, S_RES2
from vidsum_tpu_torch.ops.losses import mse_with_mask_loss
from vidsum_tpu_torch.parallel.distributed import (
    all_reduce, process_count, process_index, put_batch,
)
from vidsum_tpu_torch.parallel.dp_shardmap import (
    apply_grads, draw_seeds, global_denominators, shard_grads, sum_shards,
    trained_params,
)
from vidsum_tpu_torch.parallel.mesh import DeviceMesh, on
from vidsum_tpu_torch.parallel.ring_attention import (
    hash_keep3d, ring_hash_keep,
)
from vidsum_tpu_torch.parallel.sharding import block_shard
from vidsum_tpu_torch.train.steps import update_count


def dropout_masks(cfg: ModelConfig, seeds: Sequence[int], B: int, N: int,
                  device=None) -> list:
    """Per-layer keep masks of a whole (B, N) batch (N with the CLS token),
    in ``SimNet.forward(dropout_masks=)``'s form: the masks the sharded
    steps draw, so a dense single-device step with them replays a sharded
    step."""
    d, H = cfg.d_model, cfg.num_heads
    hid, rate = d * cfg.mlp_scale, cfg.dropout
    return [{"attn": ring_hash_keep(s, 0, 0, 0, (B, H, N, N), rate, device),
             "res1": hash_keep3d(s, S_RES1, 0, 0, (B, N, d), rate, device),
             "mlp": hash_keep3d(s, S_MLP, 0, 0, (B, N, hid), rate, device),
             "res2": hash_keep3d(s, S_RES2, 0, 0, (B, N, d), rate, device)}
            for s in seeds]


def sum_partials(parts: List[torch.Tensor],
                 device: torch.device) -> torch.Tensor:
    """The ``model`` shards' partial sums of a row-parallel product, summed
    in shard order on ``device`` (the JAX psum over ``model``)."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def sharded_block(block, cfg: ModelConfig, hs: list, grid: list, key_mask,
                  seed: int, rate: float, b0: int, row0: list) -> list:
    """One encoder block (dense route) over a (seq, model) grid of entries:
    ``hs[s]`` (B, Ns, d) on ``grid[s][0]`` in, the block's outputs there
    out. ``key_mask(device)`` is the row's whole (B, N) pad mask on a
    device; ``row0[s]`` the global position of seq shard s's first row,
    ``b0`` of the batch's first element."""
    S, M = len(grid), len(grid[0])
    H = cfg.num_heads
    Hl, Dh = H // M, cfg.head_dim
    hid = cfg.d_model * cfg.mlp_scale
    shards = [block_shard(block, m, M, H) for m in range(M)]

    def drop(t, site, s, c0=0):
        if rate == 0.0:
            return t
        return _apply_keep(t, hash_keep3d(seed, site, b0, row0[s], t.shape,
                                          rate, t.device, c0), rate)

    x_in = [_layernorm(block.norm1, h) if cfg.norm_first else h for h in hs]
    qkv = [[{} for _ in range(M)] for _ in range(S)]
    for s in range(S):
        for m in range(M):
            e = grid[s][m]
            with on(e):
                xe = x_in[s].to(e)
                for n in ("q", "k", "v"):
                    t = _affine(shards[m][f"sa.{n}.weight"],
                                shards[m][f"sa.{n}.bias"], xe)
                    B, Ns = t.shape[:2]
                    qkv[s][m][n] = t.view(B, Ns, Hl, Dh).transpose(1, 2)
    out = []
    for s in range(S):
        home = grid[s][0]
        parts = []
        for m in range(M):
            e = grid[s][m]
            with on(e):
                k = torch.cat([qkv[t][m]["k"].to(e) for t in range(S)], 2)
                v = torch.cat([qkv[t][m]["v"].to(e) for t in range(S)], 2)
                q = qkv[s][m]["q"]
                sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
                    * cfg.attn_scale
                sc = sc.masked_fill(key_mask(e)[:, None, None, :],
                                    float("-inf"))
                w = torch.softmax(sc, dim=-1).to(q.dtype)
                if rate > 0.0:
                    w = _apply_keep(w, ring_hash_keep(
                        seed, b0, row0[s], 0, w.shape, rate, e, h0=m * Hl),
                        rate)
                o = torch.matmul(w.float(), v.float()).to(q.dtype)
                B, _, Ns, _ = o.shape
                o = o.transpose(1, 2).reshape(B, Ns, Hl * Dh)
                parts.append(_affine(
                    shards[m]["sa.feature_projection.weight"], None, o))
        sa = sum_partials(parts, home) \
            + block.sa.feature_projection.bias.to(home, hs[s].dtype)
        if cfg.norm_first:
            h = hs[s] + drop(sa, S_RES1, s)
            x2 = _layernorm(block.norm2, h)
        else:
            h = _layernorm(block.norm1, drop(sa, S_RES1, s) + hs[s])
            x2 = h
        parts = []
        for m in range(M):
            e = grid[s][m]
            with on(e):
                a = torch.relu(_affine(shards[m]["mlp.fc1.weight"],
                                       shards[m]["mlp.fc1.bias"], x2.to(e)))
                a = drop(a, S_MLP, s, c0=m * (hid // M))
                parts.append(_affine(shards[m]["mlp.fc2.weight"], None, a))
        ff = sum_partials(parts, home) \
            + block.mlp.fc2.bias.to(home, hs[s].dtype)
        if cfg.norm_first:
            out.append(h + drop(ff, S_RES2, s))
        else:
            out.append(_layernorm(block.norm2, drop(ff, S_RES2, s) + h))
    return out


def sharded_forward(net, cfg: ModelConfig, grid: list, x: torch.Tensor,
                    pad_mask: torch.Tensor, seeds: Sequence[int],
                    rate: float, b0: int, blocks=None):
    """SimNet's dense forward for one data row over a (seq, model) grid of
    entries: ``x`` (B, N, D) and ``pad_mask`` (B, N) of the row's videos.
    Returns ``(scores, hidden, masks)``, lists over the seq shards (on each
    shard's first entry). ``blocks(layer)`` gives each layer's block
    (default: ``net``'s own), which the pipeline streams from its owner."""
    S = len(grid)
    B, N = pad_mask.shape
    if N % S:
        raise ValueError(f"length {N} must split over {S} seq shards")
    if cfg.use_cls and S > 1:
        raise ValueError("the sequence axis does not support CLS tokens")
    if rate > 0.0 and cfg.pos_dropout:
        raise ValueError("pos_dropout > 0 is not wired for the sharded "
                         "steps (0.0 in every reference recipe)")
    Ns = N // S
    dt = dtype_of(cfg.compute_dtype)
    emb = net.embedding_layer.feature_transform
    hs, masks = [], []
    for s in range(S):
        dev = grid[s][0]
        with on(dev):
            h = _affine(emb.weight, emb.bias,
                        x[:, s * Ns:(s + 1) * Ns].to(dev).to(dt))
            if cfg.use_pos:
                pe = net._pe(max(cfg.max_len, N), dev)
                h = h + pe[None, s * Ns:(s + 1) * Ns].to(dt)
            m = pad_mask[:, s * Ns:(s + 1) * Ns].to(dev)
            if cfg.use_cls:
                cls = net.embedding_layer.cls_token.to(dev, dt)
                h = torch.cat([cls.expand(B, 1, cfg.d_model), h], dim=1)
            hs.append(h)
            masks.append(m)
    full = pad_mask
    if cfg.use_cls:
        full = torch.cat([torch.zeros((B, 1), dtype=torch.bool,
                                      device=full.device), full], dim=1)
    cache = {}

    def key_mask(dev):
        if dev not in cache:
            cache[dev] = full.to(dev)
        return cache[dev]

    row0 = [s * Ns for s in range(S)]
    layers = net.encoder.module_list
    for li in range(cfg.num_layers):
        block = blocks(li) if blocks is not None else layers[li]
        hs = sharded_block(block, cfg, hs, grid, key_mask, seeds[li], rate,
                           b0, row0)
    head = net.final_layer
    scores = [_affine(head.weight, head.bias, h).float() for h in hs]
    return scores, hs, masks


def mesh_rows(mesh: DeviceMesh, seq_axis: Optional[str] = None,
              model_axis: str = "model", data_axis: str = "data") -> list:
    """The mesh as data rows of (seq, model) grids: ``rows[i][s][m]``."""
    names = [data_axis] + ([seq_axis] if seq_axis else []) + (
        [model_axis] if model_axis in mesh.axis_names else [])
    if sorted(names) != sorted(mesh.axis_names):
        raise ValueError(f"mesh axes {mesh.axis_names} are not {names}")
    arr = mesh.array.transpose([mesh.axis_names.index(n) for n in names])
    D = arr.shape[0]
    arr = arr.reshape(D, arr.shape[1] if seq_axis else 1, -1)
    return arr.tolist()


def _check(cfg: ModelConfig, rows: list) -> None:
    M = len(rows[0][0])
    if cfg.num_heads % M or (cfg.d_model * cfg.mlp_scale) % M:
        raise ValueError(f"{cfg.num_heads} heads and "
                         f"{cfg.d_model * cfg.mlp_scale} MLP channels must "
                         f"split over model={M}")


def make_sharded_finetune_step(cfg: ModelConfig, mesh: DeviceMesh,
                               seq_axis: Optional[str] = None):
    """``step(model, optimizer, x, target, pad_mask, generator=None,
    item_weight=None, seeds=None) -> loss`` (a 0-d tensor on the mesh's
    first entry, not synchronised): one finetune step of ``model`` (a
    ``SimNet`` on that entry) with the batch over ``data``, the heads and
    MLP channels over ``model`` and, with ``seq_axis``, the frames over it.
    ``seeds`` (num_layers,) are the layers' dropout seeds, else drawn from
    ``generator``. The loss is the global batch's masked-MSE mean (with
    ``item_weight``, the padded batch's weighted mean), with the global
    batch's longest video as its length."""
    rows = mesh_rows(mesh, seq_axis)
    _check(cfg, rows)
    home = rows[0][0][0]

    def step(model, optimizer, x, target, pad_mask,
             generator: Optional[torch.Generator] = None, item_weight=None,
             seeds=None):
        [seeds] = draw_seeds(generator, 1, cfg.num_layers,
                             None if seeds is None else [seeds])
        D, rank = len(rows), process_index()
        Dg = D * process_count()
        xs, ts, ms, ws = put_batch(mesh, x, target,
                                   torch.as_tensor(pad_mask, dtype=torch.bool),
                                   item_weight,
                                   batch_axis=mesh.axis_names[0])
        denom, wsum = global_denominators(ms, home, ws)
        params = trained_params(optimizer)
        per_row, losses = [], []
        for i, grid in enumerate(rows):
            Bl = ms[i].shape[0]
            scores, _, masks = sharded_forward(
                model, cfg, grid, xs[i], ms[i], seeds, cfg.dropout,
                (rank * D + i) * Bl)
            dev = grid[0][0]
            Ns = masks[0].shape[1]
            with on(dev):
                sums = [mse_with_mask_loss(
                    sc, ts[i][:, s * Ns:(s + 1) * Ns].to(sc.device),
                    masks[s], reduction="sum",
                    item_weight=None if ws is None else ws[i]).to(dev)
                    for s, sc in enumerate(scores)]
                total = sums[0]
                for t in sums[1:]:
                    total = total + t
                if ws is None:
                    loss = total / (Bl * denom.to(dev))
                else:
                    loss = total / (wsum * denom).to(dev)
            per_row.append(shard_grads(loss, params))
            losses.append([loss.detach()])
        scale = 1.0 if ws is not None else 1.0 / Dg
        apply_grads(optimizer, params, sum_shards(per_row), scale)
        [loss] = all_reduce(sum_shards(losses))
        return loss * scale

    step.attn_impl = "dense"
    return step


def make_sharded_pretrain_step(model_cfg: ModelConfig,
                               pretrain_cfg: PretrainConfig, schedule,
                               mesh: DeviceMesh):
    """The dp x tp pretrain step: ``step(model, optimizer, x, video_rep,
    pad_mask, generator=None, seeds=None) -> tensor([total, main, center,
    repel])`` for a ``PretrainModel`` on the mesh's first entry. Each data
    row runs the encoder sharded over ``model`` (dense route) and the
    three-loss objective on its rows with the global batch's longest video
    as its length; the losses and gradients are averaged over the rows.
    The learning rate of the update is ``schedule(update_count)``, and the
    optimizer holds only the parameters that train, so a frozen
    ``video_transform`` keeps its bits (``train.steps.make_pretrain_step``).
    ``batch_size`` must split over ``data``."""
    rows = mesh_rows(mesh)
    _check(model_cfg, rows)
    home = rows[0][0][0]
    cw, rw = pretrain_cfg.center_weight, pretrain_cfg.repel_weight

    def step(model, optimizer, x, video_rep, pad_mask,
             generator: Optional[torch.Generator] = None, seeds=None):
        [seeds] = draw_seeds(generator, 1, model_cfg.num_layers,
                             None if seeds is None else [seeds])
        D, rank = len(rows), process_index()
        Dg = D * process_count()
        xs, vs, ms = put_batch(mesh, x, video_rep,
                               torch.as_tensor(pad_mask, dtype=torch.bool),
                               batch_axis=mesh.axis_names[0])
        denom, _ = global_denominators(ms, home)
        params = trained_params(optimizer)
        per_row, losses = [], []
        for i, grid in enumerate(rows):
            Bl = ms[i].shape[0]
            [scores], [hidden], _ = sharded_forward(
                model.encoder, model_cfg, grid, xs[i], ms[i], seeds,
                model_cfg.dropout, (rank * D + i) * Bl)
            dev = grid[0][0]
            with on(dev):
                main, center, repel = model.objective(
                    scores, hidden, vs[i], ms[i], denom_len=denom.to(dev))
                total = main + cw * center + rw * repel
            per_row.append(shard_grads(total, params))
            losses.append([torch.stack([total, main, center, repel])
                           .detach()])
        lr = schedule(update_count(optimizer))
        for group in optimizer.param_groups:
            group["lr"] = lr
        apply_grads(optimizer, params, sum_shards(per_row), 1.0 / Dg)
        [out] = all_reduce(sum_shards(losses))
        return out / Dg

    step.attn_impl = "dense"
    return step

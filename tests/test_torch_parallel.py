"""The port's multi-device modes (``vidsum_tpu_torch/parallel/``) on the CPU,
against the JAX package's on its 8 forced CPU devices, from one JAX init
(``params_from_jax``) and the same numpy inputs. Meshes repeat the
``"cpu"`` device.

- meshes: ``MeshConfig`` shapes and errors, axes of any rank;
- the tensor-parallel slices against ``shard_params``'s;
- the finetune loss's ``item_weight`` / ``denom_len``, ``make_batches(
  pad_to_batch=)`` and ``item_weights``;
- the dp x tp forward and step on (8, 1) and (2, 4), the composed
  (data, seq, model) step, the sharded pretrain step, the kernels' data-
  parallel step (the plain versions of TPU kernels 9-12 against JAX's
  Pallas kernels in interpret mode), the padded final batch, and the
  pipeline forward and step on 2 and 4 stages, at the JAX tests' bounds
  (tests/test_parallel.py, tests/test_pipeline_parallel.py);
- at dropout > 0 each step against its replay: the data-parallel step
  against each shard's single-device forward on the same seeds, the
  sharded and pipeline steps against the dense step with the same hash
  masks (``train_parallel.dropout_masks``);
- ``finetune(mesh=)`` against the JAX loop, ``pretrain(mesh=)``,
  ``cli.train --dp``;
- serving: ``make_replica_forward_int8`` against JAX's, the int8 wire on a
  mesh, and a slow long-route fetch never holding up short batches."""

import copy
import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from vidsum_tpu.config import Config as JaxConfig
from vidsum_tpu.config import DataConfig as JaxDataConfig
from vidsum_tpu.config import MeshConfig as JaxMeshConfig
from vidsum_tpu.config import ModelConfig as JaxModelConfig
from vidsum_tpu.config import PretrainConfig as JaxPretrainConfig
from vidsum_tpu.config import TrainConfig as JaxTrainConfig
from vidsum_tpu.data.collate import item_weights as jax_item_weights
from vidsum_tpu.data.collate import make_batches as jax_make_batches
from vidsum_tpu.data.paths import PATH as JAX_PATH
from vidsum_tpu.data.synthetic import make_synthetic_h5
from vidsum_tpu.models import init_simnet, simnet_apply
from vidsum_tpu.models.pretrain import init_pretrain_model
from vidsum_tpu.ops.losses import mse_with_mask_loss as jax_mse
from vidsum_tpu.parallel import batch_sharding, shard_params
from vidsum_tpu.parallel import make_mesh as jax_make_mesh
from vidsum_tpu.parallel import make_sharded_finetune_step as jax_sharded
from vidsum_tpu.parallel.dp_shardmap import (
    make_dp_shardmap_finetune_step as jax_dp_step,
)
from vidsum_tpu.parallel.pipeline import make_pp_forward as jax_pp_forward
from vidsum_tpu.parallel.pipeline import make_pp_train_step as jax_pp_step
from vidsum_tpu.parallel.train_parallel import (
    make_sharded_pretrain_step as jax_sharded_pretrain,
)
from vidsum_tpu.serve.mesh import _make_replica_forward as jax_rep_fwd
from vidsum_tpu.serve.mesh import (
    make_replica_forward_int8 as jax_rep_fwd_int8,
)
from vidsum_tpu.train import finetune as jax_finetune
from vidsum_tpu.train import save_checkpoint as jax_save_checkpoint
from vidsum_tpu.train.steps import make_finetune_step as jax_finetune_step
from vidsum_tpu.train.steps import make_optimizer as jax_optimizer
from vidsum_tpu_torch.cli import train as train_cli
from vidsum_tpu_torch.config import (
    Config, DataConfig, MeshConfig, ModelConfig, PretrainConfig,
    TrainConfig,
)
from vidsum_tpu_torch.data.collate import item_weights, make_batches, pad_batch
from vidsum_tpu_torch.models.convert import (
    params_from_jax, pretrain_params_from_jax,
)
from vidsum_tpu_torch.models.pretrain import PretrainModel
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.ops.losses import mse_with_mask_loss
from vidsum_tpu_torch.parallel import (
    make_dp_shardmap_finetune_step, make_mesh, make_pp_forward,
    make_pp_train_step, make_sharded_finetune_step,
    make_sharded_pretrain_step, stack_blocks,
)
from vidsum_tpu_torch.parallel import dp_shardmap, train_parallel
from vidsum_tpu_torch.serve import ScoringService
from vidsum_tpu_torch.serve import mesh as serve_mesh
from vidsum_tpu_torch.serve.transport import quantize_frames
from vidsum_tpu_torch.train import finetune as ft
from vidsum_tpu_torch.train.pretraining import pretrain
from vidsum_tpu_torch.train.steps import make_optimizer

LR, WD = 1e-3, 1e-4
KW = dict(d_model=64, num_heads=4, num_layers=2, dropout=0.0, max_len=128)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs six workers on a few cores: torch's default of one
    thread a core per worker oversubscribes them, and the steps' many small
    products (one per shard and batch element) ran up to a hundredfold
    slower there. Two threads a worker while this module's tests run,
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(seed=0, **kw):
    kw = {**KW, **kw}
    jcfg = JaxModelConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, init_simnet(jax.random.PRNGKey(seed), jcfg))
    model = SimNet(ModelConfig(**kw), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return jcfg, params, ModelConfig(**kw), model


def _batch(seed=0, B=8, N=32, pad_from=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, 1024)).astype(np.float32)
    t = rng.random((B, N)).astype(np.float32)
    mask = np.zeros((B, N), bool)
    mask[:, pad_from:] = True
    # the shards' longest videos differ: a per-shard denominator shows
    mask[B // 2:, pad_from - 7:] = True
    return x, t, mask


def _cpu_mesh(data, model=1):
    return make_mesh(MeshConfig(data=data, model=model),
                     ["cpu"] * (data * model))


def _close_params(state, jax_tree, rtol, atol, convert=params_from_jax):
    want = convert(jax.tree_util.tree_map(np.asarray, jax_tree))
    for k, v in want.items():
        np.testing.assert_allclose(state[k].detach().numpy(), v.numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def _jax_step(jcfg, params, x, t, mask, mesh=None, **kw):
    opt = jax_optimizer(LR, WD)
    fresh = jax.tree_util.tree_map(jnp.array, params)
    if mesh is None:
        p, _, loss = jax_finetune_step(jcfg, opt)(
            fresh, opt.init(fresh), jnp.asarray(x), jnp.asarray(t),
            jnp.asarray(mask), jax.random.PRNGKey(7))
        return p, float(loss)
    init_fn, step_fn = jax_sharded(jcfg, opt, mesh, **kw)
    sp, so = init_fn(fresh)
    p, _, loss = step_fn(sp, so, jnp.asarray(x), jnp.asarray(t),
                         jnp.asarray(mask), jax.random.PRNGKey(7))
    return p, float(loss)


def _port_step(make, model, *args, **kw):
    m = copy.deepcopy(model)
    opt = make_optimizer(m, LR, WD)
    loss = make(m, opt, *args, **kw)
    return m, float(loss)


# ------------------------------------------------------------------- meshes

def test_make_mesh_matches_jax():
    for cfg in ((-1, 2), (8, 1), (2, 4)):
        got = make_mesh(MeshConfig(*cfg), ["cpu"] * 8)
        want = jax_make_mesh(JaxMeshConfig(*cfg))
        assert got.shape == dict(want.shape)
        assert got.axis_names == tuple(want.axis_names)
    for cfg in ((3, 2), (-1, 3)):
        with pytest.raises(ValueError) as got:
            make_mesh(MeshConfig(*cfg), ["cpu"] * 8)
        with pytest.raises(ValueError) as want:
            jax_make_mesh(JaxMeshConfig(*cfg))
        assert str(got.value) == str(want.value)


def test_mesh_axes_of_any_rank():
    mesh = make_mesh((2, 2, 2), "cpu", ("data", "seq", "model"))
    assert mesh.shape == {"data": 2, "seq": 2, "model": 2}
    assert mesh.size == 8 and len(mesh.grid[1][0]) == 2
    assert make_mesh((4,), "cpu", ("stage",)).shape == {"stage": 4}
    # the sequence-parallel form is unchanged
    ring = make_mesh((1, 4), "cpu")
    assert ring.shape == {"data": 1, "seq": 4} and len(ring.grid[0]) == 4
    rows = train_parallel.mesh_rows(mesh, "seq")
    assert len(rows) == 2 and len(rows[0]) == 2 and len(rows[0][0]) == 2
    with pytest.raises(ValueError, match="one size per axis"):
        make_mesh((2, 2), "cpu", ("stage",))
    with pytest.raises(ValueError, match="differ"):
        make_mesh((2, 2), "cpu", ("data", "data"))


def test_block_shard_matches_jax_shardings():
    """Model shard m's slices (``sharding.block_shard``) are the blocks of
    each sharded parameter that JAX's ``shard_params`` puts on the devices
    of model index m of a (2, 4) mesh (torch's (out, in) layout: a JAX
    column shard is a block of weight rows), and every parameter the JAX
    layout replicates is left whole."""
    _, params, cfg, model = _pair()
    mesh = jax_make_mesh(JaxMeshConfig(data=2, model=4))
    placed = shard_params(params, mesh)
    model_of = {d: m for row in mesh.devices for m, d in enumerate(row)}
    names = {"q": "sa.q", "k": "sa.k", "v": "sa.v",
             "proj": "sa.feature_projection", "fc1": "mlp.fc1",
             "fc2": "mlp.fc2"}
    for li, block in enumerate(model.encoder.module_list):
        jblock = placed["blocks"][li]
        got = [train_parallel.block_shard(block, m, 4, cfg.num_heads)
               for m in range(4)]
        sharded = set()
        for group in ("attn", "mlp"):
            for jname, leaves in jblock[group].items():
                for leaf, arr in leaves.items():
                    kind = "weight" if leaf == "w" else "bias"
                    key = f"{names[jname]}.{kind}"
                    shards = {model_of[sh.device]: np.asarray(sh.data)
                              for sh in arr.addressable_shards}
                    if shards[0].shape == arr.shape:
                        assert all(key not in g for g in got), key
                        continue
                    sharded.add(key)
                    for m in range(4):
                        want = shards[m].T if leaf == "w" else shards[m]
                        np.testing.assert_array_equal(
                            got[m][key].detach().numpy(), want, err_msg=key)
        assert set(got[0]) == sharded
        for g in got:
            assert all(t._base is not None for t in g.values())


# --------------------------------------------------- loss weights, batches

@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("weighted", [False, True])
def test_item_weight_and_denom_len_match_jax(reduction, weighted):
    rng = np.random.default_rng(3)
    out = rng.normal(size=(4, 32, 1)).astype(np.float32)
    tgt = rng.random((4, 32)).astype(np.float32)
    mask = np.arange(32)[None] >= np.array([[30], [20], [12], [25]])
    w = np.array([1, 1, 0, 1], np.float32) if weighted else None
    for denom in (None, 31.0):
        got = mse_with_mask_loss(torch.from_numpy(out), torch.from_numpy(tgt),
                                 torch.from_numpy(mask), reduction,
                                 item_weight=w, denom_len=denom)
        want = jax_mse(jnp.asarray(out), jnp.asarray(tgt), jnp.asarray(mask),
                       reduction, None if w is None else jnp.asarray(w),
                       denom)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_make_batches_pad_to_batch_and_item_weights_match_jax():
    for n, b in ((10, 4), (9, 3), (7, 8), (3, 2)):
        for drop in (False, True):
            got = list(make_batches(n, b, shuffle=True, drop_last=drop,
                                    pad_to_batch=True,
                                    rng=np.random.default_rng(n)))
            want = list(jax_make_batches(n, b, shuffle=True, drop_last=drop,
                                         pad_to_batch=True,
                                         rng=np.random.default_rng(n)))
            assert got == want
            for chunk in got:
                assert len(chunk) == b
                np.testing.assert_array_equal(item_weights(chunk),
                                              jax_item_weights(chunk))
    assert list(make_batches(10, 4, shuffle=False, pad_to_batch=True))[-1] \
        == [8, 9, 8, 9]


# --------------------------------------------------------- dp x tp, seq

def test_tp_sharded_forward_matches_jax():
    jcfg, params, cfg, model = _pair()
    x, _, mask = _batch()
    jmesh = jax_make_mesh(JaxMeshConfig(data=2, model=4))
    want, _ = jax.jit(lambda p, xx, mm: simnet_apply(p, jcfg, xx, mm))(
        shard_params(params, jmesh),
        jax.device_put(jnp.asarray(x), batch_sharding(jmesh, 3)),
        jax.device_put(jnp.asarray(mask), batch_sharding(jmesh, 2)))
    rows = train_parallel.mesh_rows(_cpu_mesh(2, 4))
    got = []
    with torch.no_grad():
        for i, grid in enumerate(rows):
            [s], _, _ = train_parallel.sharded_forward(
                model, cfg, grid, torch.from_numpy(x[4 * i:4 * i + 4]),
                torch.from_numpy(mask[4 * i:4 * i + 4]), [0, 0], 0.0, 4 * i)
            got.append(s.numpy())
    np.testing.assert_allclose(np.concatenate(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape", [(8, 1), (2, 4)])
def test_sharded_train_step_matches_jax(shape):
    """One dp(/tp) step: loss rtol 1e-5, every parameter rtol/atol 5e-4 of
    JAX's ``make_sharded_finetune_step`` (tests/test_parallel.py)."""
    jcfg, params, cfg, model = _pair(seed=1)
    x, t, mask = _batch(1)
    want_p, want_loss = _jax_step(jcfg, params, x, t, mask,
                                  jax_make_mesh(JaxMeshConfig(*shape)))
    m, loss = _port_step(make_sharded_finetune_step(cfg, _cpu_mesh(*shape)),
                         model, x, t, mask, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _close_params(m.state_dict(), want_p, 5e-4, 5e-4)


def test_grad_sync_across_data_axis():
    """Identical shards: the step equals one element's step, so the data
    axis averages (not sums) its gradients."""
    jcfg, params, cfg, model = _pair(seed=3)
    x1, t1, m1 = _batch(4, B=1)
    want_p, _ = _jax_step(jcfg, params, x1, t1, m1)
    for make in (make_sharded_finetune_step(cfg, _cpu_mesh(8)),
                 make_dp_shardmap_finetune_step(cfg, _cpu_mesh(8))):
        m, _ = _port_step(make, model, np.repeat(x1, 8, 0),
                          np.repeat(t1, 8, 0), np.repeat(m1, 8, 0),
                          torch.Generator().manual_seed(0))
        _close_params(m.state_dict(), want_p, 5e-4, 5e-4)


def test_composed_3axis_train_step_matches_jax():
    """One step over (data, seq, model) = (2, 2, 2): at dropout 0 against
    JAX's composed step; at dropout 0.2 against the dense step with the same
    hash masks, and the same on every mesh shape."""
    jcfg, params, cfg, model = _pair(seed=31)
    x, t, mask = _batch(31, B=4, N=64, pad_from=50)
    jmesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2),
                 ("data", "seq", "model"))
    want_p, want_loss = _jax_step(jcfg, params, x, t, mask, jmesh,
                                  seq_axis="seq")
    mesh = make_mesh((2, 2, 2), "cpu", ("data", "seq", "model"))
    m, loss = _port_step(make_sharded_finetune_step(cfg, mesh, "seq"), model,
                         x, t, mask, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _close_params(m.state_dict(), want_p, 5e-4, 5e-4)

    cfg2 = dataclasses.replace(cfg, dropout=0.2)
    seeds = [5, 6]
    model = SimNet(cfg2, device="cpu")
    model.load_state_dict(params_from_jax(params))
    ref = copy.deepcopy(model)
    opt = make_optimizer(ref, LR, WD)
    scores, _ = ref(torch.from_numpy(x), torch.from_numpy(mask),
                    attn_impl="dense", deterministic=False,
                    dropout_masks=train_parallel.dropout_masks(
                        cfg2, seeds, 4, 64))
    ref_loss = mse_with_mask_loss(scores, torch.from_numpy(t),
                                  torch.from_numpy(mask))
    ref_loss.backward()
    opt.step()
    for m_shape in ((2, 2, 2), (1, 4, 2), (4, 1, 1)):
        mesh = make_mesh(m_shape, "cpu", ("data", "seq", "model"))
        m, loss = _port_step(make_sharded_finetune_step(cfg2, mesh, "seq"),
                             model, x, t, mask, seeds=seeds)
        np.testing.assert_allclose(loss, float(ref_loss.detach()), rtol=1e-5)
        for k, v in ref.state_dict().items():
            np.testing.assert_allclose(m.state_dict()[k].numpy(), v.numpy(),
                                       rtol=5e-4, atol=5e-4, err_msg=k)


def _pretrain_pair(seed, dropout):
    kw = {**KW, "dropout": dropout}
    params = jax.tree_util.tree_map(
        np.asarray, init_pretrain_model(jax.random.PRNGKey(seed),
                                        JaxModelConfig(**kw)))
    model = PretrainModel(ModelConfig(**kw), device="cpu")
    model.load_state_dict(pretrain_params_from_jax(params))
    return params, ModelConfig(**kw), model


def test_sharded_pretrain_step_matches_jax():
    """The dp x tp pretrain step on (2, 4) at dropout 0: losses rtol 1e-4,
    parameters rtol/atol 7e-4 of JAX's (tests/test_parallel.py); the frozen
    ``video_transform`` keeps its bits."""
    params, cfg, model = _pretrain_pair(9, 0.0)
    x, _, mask = _batch(9)
    v = np.random.default_rng(10).normal(size=(8, 512)).astype(np.float32)
    jopt = jax_optimizer(1e-3, 5e-4)
    init_fn, jstep = jax_sharded_pretrain(
        JaxModelConfig(**{**KW, "dropout": 0.0}), JaxPretrainConfig(), jopt,
        jax_make_mesh(JaxMeshConfig(data=2, model=4)))
    sp, so = init_fn(jax.tree_util.tree_map(jnp.array, params))
    want_p, _, want = jstep(sp, so, jnp.asarray(x), jnp.asarray(v),
                            jnp.asarray(mask), jax.random.PRNGKey(3))
    m = copy.deepcopy(model)
    opt = make_optimizer([("encoder." + n, p)
                          for n, p in m.encoder.named_parameters()],
                         1e-3, 5e-4)
    step = make_sharded_pretrain_step(cfg, PretrainConfig(), lambda _: 1e-3,
                                      _cpu_mesh(2, 4))
    got = step(m, opt, x, v, mask, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), [float(a) for a in want],
                               rtol=1e-4)
    _close_params(m.state_dict(), want_p, 7e-4, 7e-4,
                  pretrain_params_from_jax)
    for k, val in model.video_transform.state_dict().items():
        assert torch.equal(m.video_transform.state_dict()[k], val)


def test_sharded_pretrain_step_with_dropout_equals_its_replay():
    """At dropout 0.1 the sharded pretrain step equals the single-device
    dense objective with the same hash masks (tests/test_parallel.py's
    dropout run, held to a replay instead of finiteness)."""
    _, cfg, model = _pretrain_pair(2, 0.1)
    x, _, mask = _batch(2)
    v = np.random.default_rng(3).normal(size=(8, 512)).astype(np.float32)
    seeds = [17, 18]
    ref = copy.deepcopy(model)
    ropt = make_optimizer([("encoder." + n, p)
                           for n, p in ref.encoder.named_parameters()],
                          1e-3, 5e-4)
    scores, hidden = ref.encoder(
        torch.from_numpy(x), torch.from_numpy(mask), attn_impl="dense",
        deterministic=False,
        dropout_masks=train_parallel.dropout_masks(cfg, seeds, 8, 32))
    parts = ref.objective(scores, hidden, torch.from_numpy(v),
                          torch.from_numpy(mask))
    total = parts[0] + 0.5 * parts[1] + 1.0 * parts[2]
    total.backward()
    ropt.step()
    m = copy.deepcopy(model)
    opt = make_optimizer([("encoder." + n, p)
                          for n, p in m.encoder.named_parameters()],
                         1e-3, 5e-4)
    step = make_sharded_pretrain_step(cfg, PretrainConfig(), lambda _: 1e-3,
                                      _cpu_mesh(2, 2))
    got = step(m, opt, x, v, mask, seeds=seeds)
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(float(got[0]), float(total.detach()),
                               rtol=1e-5)
    for k, val in ref.state_dict().items():
        np.testing.assert_allclose(m.state_dict()[k].numpy(), val.numpy(),
                                   rtol=7e-4, atol=7e-4, err_msg=k)


# ------------------------------------------------- data parallel, kernels

def test_dp_shardmap_step_matches_jax():
    """The kernels' data-parallel step on 4 entries (each shard on the
    fused block's route: the plain versions of TPU kernels 9-12 here)
    against JAX's shard_map step with its Pallas kernels in interpret mode,
    dropout 0: loss rtol 1e-4, parameters rtol/atol 5e-4."""
    jcfg, params, cfg, model = _pair(seed=21)
    x, t, mask = _batch(21, B=4, N=128, pad_from=120)
    opt = jax_optimizer(LR, WD)
    fresh = jax.tree_util.tree_map(jnp.array, params)
    want_p, _, want_loss = jax_dp_step(
        jcfg, opt, Mesh(np.asarray(jax.devices()[:4]), ("data",)),
        attn_impl="pallas")(fresh, opt.init(fresh), jnp.asarray(x),
                            jnp.asarray(t), jnp.asarray(mask),
                            jax.random.PRNGKey(5))
    step = make_dp_shardmap_finetune_step(
        cfg, make_mesh((4,), "cpu", ("data",)), attn_impl="fused_block")
    m, loss = _port_step(step, model, x, t, mask,
                         torch.Generator().manual_seed(0))
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-4)
    _close_params(m.state_dict(), want_p, 5e-4, 5e-4)


def _shard_replay(model, cfg, x, t, mask, seeds, D, impl):
    """Each shard's single-device training forward on its rows with its
    seeds, the loss over the global denominator, gradients averaged: what
    the data-parallel step computes."""
    ref = copy.deepcopy(model)
    opt = make_optimizer(ref, LR, WD)
    Bl = x.shape[0] // D
    denom = max(float((~mask[i * Bl:(i + 1) * Bl]).sum(1).max())
                for i in range(D))
    total = 0.0
    for i in range(D):
        rows = slice(i * Bl, (i + 1) * Bl)
        scores, _ = ref(torch.from_numpy(x[rows]),
                        torch.from_numpy(mask[rows]), attn_impl=impl,
                        deterministic=False,
                        generator=dp_shardmap.shard_generator(seeds[i]),
                        block_seeds=seeds[i])
        loss = mse_with_mask_loss(scores, torch.from_numpy(t[rows]),
                                  torch.from_numpy(mask[rows]),
                                  denom_len=denom) / D
        loss.backward()
        total += float(loss.detach())
    opt.step()
    return ref, total


@pytest.mark.parametrize("impl", ["fused_block", "dense"])
def test_dp_step_with_dropout_equals_the_shard_replay(impl):
    """At dropout 0.3 the data-parallel step equals a replay of each
    shard's single-device step on the same seeds, gives the same bits
    twice, and takes the global batch's denominator (the shards' longest
    videos differ here)."""
    _, _, cfg, model = _pair(seed=22, dropout=0.3)
    x, t, mask = _batch(22, B=8, N=128, pad_from=120)
    seeds = [[11 * i + 1, 11 * i + 2] for i in range(4)]
    step = make_dp_shardmap_finetune_step(cfg, _cpu_mesh(4), attn_impl=impl)
    m1, loss1 = _port_step(step, model, x, t, mask, seeds=seeds)
    m2, loss2 = _port_step(step, model, x, t, mask, seeds=seeds)
    assert loss1 == loss2
    for k, v in m1.state_dict().items():
        assert torch.equal(v, m2.state_dict()[k]), k
    ref, ref_loss = _shard_replay(model, cfg, x, t, mask, seeds, 4, impl)
    np.testing.assert_allclose(loss1, ref_loss, rtol=1e-5)
    for k, v in ref.state_dict().items():
        np.testing.assert_allclose(m1.state_dict()[k].numpy(), v.numpy(),
                                   rtol=5e-4, atol=5e-6, err_msg=k)
    # the generator's draws give the same seeds
    gen = torch.Generator().manual_seed(4)
    drawn = torch.randint(0, 2**31 - 1, (4, 2),
                          generator=torch.Generator().manual_seed(4)).tolist()
    m3, loss3 = _port_step(step, model, x, t, mask, gen)
    m4, loss4 = _port_step(step, model, x, t, mask, seeds=drawn)
    assert loss3 == loss4


def test_padded_final_batch_matches_smaller_batch():
    """A final chunk cycled to the batch size with its repeats weighed 0
    (``make_batches(pad_to_batch=True)``, ``item_weights``): the data-
    parallel step (4 entries) and the dp x tp step (4, 2) on the padded
    batch equal the single-device step on the smaller batch (JAX's) -- loss
    rtol 1e-5, parameters 5e-4."""
    chunk = list(make_batches(10, 4, shuffle=False, pad_to_batch=True))[-1]
    w = item_weights(chunk)
    rng = np.random.default_rng(77)
    feats = [rng.normal(size=(n, 1024)).astype(np.float32) for n in (30, 20)]
    tgts = [rng.random(n).astype(np.float32) for n in (30, 20)]
    x2, t2, m2 = pad_batch(feats, tgts, bucket=32)
    x4, t4, m4 = pad_batch([feats[i - 8] for i in chunk],
                           [tgts[i - 8] for i in chunk], bucket=32)
    jcfg, params, cfg, model = _pair(seed=3)
    want_p, want_loss = _jax_step(jcfg, params, x2, t2, m2)
    for step in (make_dp_shardmap_finetune_step(cfg, _cpu_mesh(4),
                                                attn_impl="fused_block"),
                 make_sharded_finetune_step(cfg, _cpu_mesh(4, 2))):
        m, loss = _port_step(step, model, x4, t4, m4,
                             torch.Generator().manual_seed(0), item_weight=w)
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        _close_params(m.state_dict(), want_p, 5e-4, 5e-4)


# ----------------------------------------------------------------- pipeline

PP_KW = dict(num_layers=4)


@pytest.mark.parametrize("stages", [2, 4])
def test_pp_forward_matches_jax(stages):
    jcfg, params, cfg, model = _pair(**PP_KW)
    x, _, mask = _batch(0, B=8, N=64, pad_from=50)
    want = jax_pp_forward(jcfg, Mesh(np.asarray(jax.devices()[:stages]),
                                     ("stage",)))(params, jnp.asarray(x),
                                                  jnp.asarray(mask))
    got = make_pp_forward(cfg, make_mesh((stages,), "cpu", ("stage",)))(
        model, x, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_pp_rejects_indivisible_stages_and_cls():
    _, _, cfg, _ = _pair(**PP_KW)
    mesh3 = make_mesh((3,), "cpu", ("stage",))
    with pytest.raises(ValueError, match="not divisible by 3 stages"):
        make_pp_forward(cfg, mesh3)
    with pytest.raises(ValueError, match="not divisible by 3 stages"):
        make_pp_train_step(cfg, mesh3)
    cls_cfg = dataclasses.replace(cfg, use_cls=True)
    with pytest.raises(ValueError, match="CLS"):
        make_pp_train_step(cls_cfg, make_mesh((2,), "cpu", ("stage",)))


@pytest.mark.parametrize("stages", [2, 4])
def test_pp_train_step_matches_jax(stages):
    """Loss rtol 1e-5, every parameter rtol 2e-4 / atol 1e-5 of JAX's
    pipeline step (tests/test_pipeline_parallel.py), and the stacked blocks
    are JAX's stacked blocks."""
    jcfg, params, cfg, model = _pair(seed=1, **PP_KW)
    x, t, mask = _batch(3, B=8, N=64, pad_from=50)
    opt = jax_optimizer(LR, WD)
    init_fn, jstep = jax_pp_step(jcfg, opt, Mesh(
        np.asarray(jax.devices()[:stages]), ("stage",)))
    pp_p, pp_o = init_fn(jax.tree_util.tree_map(jnp.array, params))
    pp_p, _, want_loss = jstep(pp_p, pp_o, jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(mask), jax.random.PRNGKey(0))
    init, step = make_pp_train_step(cfg, make_mesh((stages,), "cpu",
                                                   ("stage",)))
    m = init(copy.deepcopy(model))
    opt_t = make_optimizer(m, LR, WD)
    loss = step(m, opt_t, x, t, mask, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = jax.tree_util.tree_map(np.asarray, pp_p)
    blocks = [jax.tree_util.tree_map(lambda a: a[i], want["blocks"])
              for i in range(cfg.num_layers)]
    _close_params(m.state_dict(), {"embed": want["embed"], "blocks": blocks,
                                   "head": want["head"]}, 2e-4, 1e-5)
    stacked = stack_blocks(m)
    np.testing.assert_allclose(
        stacked["sa.q.weight"].numpy(),
        np.transpose(want["blocks"]["attn"]["q"]["w"], (0, 2, 1)),
        rtol=2e-4, atol=1e-5)


def test_pp_train_step_dropout_equals_its_replay():
    """At dropout 0.3 the pipeline step equals the dense step with the
    same hash masks, and the parameters move."""
    _, _, cfg, model = _pair(seed=2, dropout=0.3, **PP_KW)
    x, t, mask = _batch(4, B=8, N=64, pad_from=64)
    seeds = [3, 4, 5, 6]
    init, step = make_pp_train_step(cfg, make_mesh((4,), "cpu", ("stage",)))
    m = init(copy.deepcopy(model))
    loss = step(m, make_optimizer(m, LR, WD), x, t, mask, seeds=seeds)
    ref = copy.deepcopy(model)
    opt = make_optimizer(ref, LR, WD)
    scores, _ = ref(torch.from_numpy(x), torch.from_numpy(mask),
                    attn_impl="dense", deterministic=False,
                    dropout_masks=train_parallel.dropout_masks(
                        cfg, seeds, 8, 64))
    ref_loss = mse_with_mask_loss(scores, torch.from_numpy(t),
                                  torch.from_numpy(mask))
    ref_loss.backward()
    opt.step()
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(ref_loss.detach()),
                               rtol=1e-5)
    moved = 0.0
    for k, v in ref.state_dict().items():
        np.testing.assert_allclose(m.state_dict()[k].numpy(), v.numpy(),
                                   rtol=2e-4, atol=1e-5, err_msg=k)
        moved = max(moved, float((v - model.state_dict()[k]).abs().max()))
    assert moved > 0


# ------------------------------------------- finetune / pretrain / CLIs

FT_KW = dict(d_model=32, num_heads=4, num_layers=1)
SPLITS = [{"train_keys": [f"x.h5/video_{i}" for i in range(5)],
           "test_keys": ["x.h5/video_5", "x.h5/video_6"]}]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("pardata")
    make_synthetic_h5(str(root / JAX_PATH["tvsum"]), n_videos=7, seed=13)
    return str(root)


def _ft_configs(data_root, **train):
    tr = dict(lr=1e-3, weight_decay=1e-4, batch_size=4, max_epoch=2,
              use_pretrained=True, **train)
    return (JaxConfig(model=JaxModelConfig(dropout=0.0, **FT_KW),
                      data=JaxDataConfig(root=data_root),
                      train=JaxTrainConfig(**tr)),
            Config(model=ModelConfig(dropout=0.0, **FT_KW),
                   data=DataConfig(root=data_root), train=TrainConfig(**tr)))


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "ts"}
                for line in f if line.strip()]


def test_finetune_with_a_mesh_matches_jax(data_root, tmp_path):
    """``finetune(mesh=)`` on a (2, 2) mesh (5 train videos at batch 4: a
    padded final batch) against the JAX loop on its (2, 2) mesh, from the
    same JAX-written pretrain.ckpt at dropout 0: every record within 1e-5;
    a batch size the data axis does not split raises the JAX error."""
    jconf, conf = _ft_configs(data_root)
    params = jax.tree_util.tree_map(
        np.asarray, init_simnet(jax.random.PRNGKey(8),
                                JaxModelConfig(dropout=0.0, **FT_KW)))
    out = {}
    for side in ("jax", "port"):
        d = str(tmp_path / side)
        os.makedirs(d)
        jax_save_checkpoint(os.path.join(d, "pretrain.ckpt"), params)
        out[side] = d
    jax_finetune(jconf, SPLITS, workdir=out["jax"], export_summary=False,
                 metrics_path=os.path.join(out["jax"], "m.jsonl"),
                 mesh=jax_make_mesh(JaxMeshConfig(data=2, model=2),
                                    jax.devices()[:4]))
    ft.finetune(conf, SPLITS, workdir=out["port"], export_summary=False,
                metrics_path=os.path.join(out["port"], "m.jsonl"),
                mesh=_cpu_mesh(2, 2))
    got, want = (_records(os.path.join(out[s], "m.jsonl"))
                 for s in ("port", "jax"))
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(list(g.values()),
                                   [w[k] for k in g], rtol=1e-5, atol=1e-5)
    bad = dataclasses.replace(conf, train=dataclasses.replace(
        conf.train, batch_size=3))
    with pytest.raises(ValueError, match=r"batch_size 3 not divisible by "
                                         r"the data axis \(2\)"):
        ft.finetune(bad, SPLITS, workdir=str(tmp_path / "bad"),
                    mesh=_cpu_mesh(2, 2))


def test_cli_train_dp(data_root, tmp_path, capsys):
    """``cli.train --dp`` on the plain path: a (1, 1) mesh whose result
    equals the run without ``--dp`` (dropout 0), and ``--tp 2`` raising the
    JAX divisibility error there."""
    split_file = tmp_path / "splits.json"
    split_file.write_text(json.dumps(SPLITS))
    argv = ["--data", data_root, "--split_path", str(split_file),
            "--d_model", "32", "--num_layers", "1", "--dropout", "0",
            "--max_epoch", "1", "--batch_size", "4"]
    printed = []
    for extra in ([], ["--dp"]):
        wd = tmp_path / ("dp" if extra else "plain")
        train_cli.main(argv + ["--workdir", str(wd)] + extra, device="cpu")
        printed.append(json.loads(capsys.readouterr().out.strip()
                                  .splitlines()[-1]))
    np.testing.assert_allclose(list(printed[1].values()),
                               list(printed[0].values()), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="1 devices not divisible by "
                                         "model=2"):
        train_cli.main(argv + ["--workdir", str(tmp_path / "tp"), "--dp",
                               "--tp", "2"], device="cpu")


def test_pretrain_with_a_mesh(tmp_path):
    """``pretrain(mesh=)`` on (2, 2) at dropout 0 equals the run without a
    mesh (history and parameters), keeps ``video_transform``'s bits, and
    refuses a batch the data axis does not split."""
    rng = np.random.default_rng(5)
    data = [(rng.normal(size=(n, 1024)).astype(np.float32),
             rng.normal(size=512).astype(np.float32))
            for n in (40, 70, 55, 90, 30, 64, 81, 20)]
    conf = Config(model=ModelConfig(dropout=0.0, **FT_KW),
                  pretrain=PretrainConfig(batch_size=4, epochs=2))
    runs = [pretrain(conf, data, workdir=str(tmp_path / name), mesh=mesh,
                     device=None if mesh else "cpu")
            for name, mesh in (("plain", None), ("mesh", _cpu_mesh(2, 2)))]
    np.testing.assert_allclose(runs[1]["history"], runs[0]["history"],
                               rtol=1e-5)
    for k, v in runs[0]["params"].items():
        np.testing.assert_allclose(runs[1]["params"][k].numpy(), v.numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=k)
        if k.startswith("video_transform"):
            assert torch.equal(runs[1]["params"][k], v)
    bad = dataclasses.replace(conf, pretrain=dataclasses.replace(
        conf.pretrain, batch_size=3))
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        pretrain(bad, data, workdir=str(tmp_path / "bad"),
                 mesh=_cpu_mesh(2, 2))


# ------------------------------------------------------------------ serving

def test_replica_forward_int8_matches_jax():
    """Per-replica dequantise-then-score over 8 entries against JAX's
    ``make_replica_forward_int8`` on 8 devices, and equal bit for bit to
    dequantising first."""
    jcfg, params, cfg, model = _pair(seed=6, dropout=0.0, in_features=48)
    rng = np.random.default_rng(6)
    pairs = [quantize_frames(rng.normal(size=(128, 48)).astype(np.float32))
             for _ in range(8)]
    q = np.stack([p[0] for p in pairs])
    s = np.stack([p[1] for p in pairs])
    mask = np.zeros((8, 128), bool)
    mask[:, 100:] = True
    rep_mesh = Mesh(np.asarray(jax.devices()), ("data",))
    want = jax_rep_fwd_int8(jcfg, jax_rep_fwd(jcfg, rep_mesh, "xla"))(
        params, jnp.asarray(q), jnp.asarray(s), jnp.asarray(mask))
    devs = [torch.device("cpu")] * 8
    rep = serve_mesh._make_replica_forward(cfg, model, devs, "dense")
    fwd = serve_mesh.make_replica_forward_int8(cfg, rep)
    got = fwd([(torch.from_numpy(q[i:i + 1]), torch.from_numpy(s[i:i + 1]))
               for i in range(8)], mask)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    deq = [torch.from_numpy(q[i:i + 1]).float()
           * torch.from_numpy(s[i:i + 1])[..., None] for i in range(8)]
    np.testing.assert_array_equal(got, rep(deq, mask))


def test_mesh_service_int8_wire(monkeypatch):
    """``ScoringService(mesh=, wire_dtype="int8")`` scores: on a mesh that
    repeats one device short requests take the single-device int8 route and
    equal the single-device int8 service bit for bit; as replica batches
    (the route of several cards, forced) too; a long request takes the
    ring on the lossless wire and equals the lossless mesh service's."""
    _, _, cfg, model = _pair(seed=7, in_features=32, max_len=4096)
    rng = np.random.default_rng(8)
    shorts = [rng.normal(size=(n, 32)).astype(np.float32)
              for n in (60, 90, 128, 200, 250)]
    long = rng.normal(size=(700, 32)).astype(np.float32)

    def serve(feats_list, **kw):
        with ScoringService(model, cfg, device="cpu", max_delay_ms=1.0,
                            **kw) as svc:
            futs = [svc.submit(f, want_summary=False) for f in feats_list]
            return [f.result(timeout=120).scores for f in futs], svc

    solo, _ = serve(shorts, wire_dtype="int8")
    mesh = make_mesh((1, 4), "cpu")
    for replicas in (False, True):
        if replicas:
            monkeypatch.setattr(serve_mesh, "_replica_devices",
                                lambda devs: devs)
        got, svc = serve(shorts + [long], wire_dtype="int8", mesh=mesh,
                         long_threshold=512)
        assert (svc._rep_fwd_i8 is not None) == replicas
        for a, b in zip(got, solo):
            np.testing.assert_array_equal(a, b)
        lossless, _ = serve([long], mesh=mesh, long_threshold=512)
        np.testing.assert_array_equal(got[-1], lossless[0])


def test_long_route_never_head_of_line_blocks():
    """The dispatcher only launches the ring; the host fetch runs on the
    selection pool, so shorts submitted behind a long request whose fetch
    takes 2 s complete while it is still in flight
    (tests/test_serve.py::test_long_route_never_head_of_line_blocks)."""
    _, _, cfg, model = _pair(seed=40, in_features=32, num_layers=1,
                             max_len=4096)
    rng = np.random.default_rng(41)
    long_feats = rng.normal(size=(1500, 32)).astype(np.float32)
    shorts = [rng.normal(size=(60 + i, 32)).astype(np.float32)
              for i in range(6)]
    FETCH_SLEEP = 2.0

    class SlowFetch:
        def __init__(self, t):
            self._t = t

        def float(self):
            return self

        def cpu(self):
            time.sleep(FETCH_SLEEP)   # a slow device-to-host copy
            return self._t.float().cpu()

    with ScoringService(model, cfg, device="cpu", mesh=make_mesh((1, 8),
                                                                 "cpu"),
                        long_threshold=256, max_delay_ms=5.0) as svc:
        svc.submit(long_feats, want_summary=False).result(timeout=120)
        svc.reset_stats()
        real = svc._long_fwd
        svc._long_fwd = lambda *a: [SlowFetch(o) if j == 0 else o
                                    for j, o in enumerate(real(*a))]
        done_at = {}
        t0 = time.monotonic()
        f_long = svc.submit(long_feats, want_summary=False)
        f_long.add_done_callback(
            lambda f: done_at.__setitem__("long", time.monotonic()))
        futs = []
        for i, s in enumerate(shorts):
            f = svc.submit(s, want_summary=False)
            f.add_done_callback(
                lambda f, i=i: done_at.__setitem__(i, time.monotonic()))
            futs.append(f)
        for f in futs:
            f.result(timeout=120)
        assert not f_long.done(), "the long request finished first"
        r_long = f_long.result(timeout=120)
        st = svc.stats()
    last_short = max(done_at[i] for i in range(len(shorts)))
    assert last_short - t0 < FETCH_SLEEP
    assert done_at["long"] > last_short
    assert st.long_requests == 1 and st.failed == 0
    assert st.completed == len(shorts) + 1
    assert r_long.scores.shape == (1500,)
    assert np.all((r_long.scores > 0) & (r_long.scores < 1))

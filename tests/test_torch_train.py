"""The port's finetune step, loss, collate, metrics and epoch loop against
the JAX package's, on the CPU: one step on the fused-block route against the
Pallas kernels in interpret mode (dropout 0, and 0.3 with the JAX per-layer
seeds), the dense route with injected dropout masks, the flash training
route (injected residual and MLP masks with the JAX attention seeds, a step,
and the fused block's demotion to it), Adam against the optax chain, and two
epochs of train + val."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vidsum_tpu.ops.block_train as jbt
import vidsum_tpu_torch.models.simnet as simnet_mod
from vidsum_tpu.config import Config as JaxConfig
from vidsum_tpu.config import ModelConfig as JaxModelConfig
from vidsum_tpu.config import TrainConfig as JaxTrainConfig
from vidsum_tpu.data import collate as jcollate
from vidsum_tpu.models import init_simnet, simnet_apply
from vidsum_tpu.ops.losses import mse_with_mask_loss as jax_mse
from vidsum_tpu.ops.metrics import eval_metrics as jax_eval_metrics
from vidsum_tpu.train import steps as jsteps
from vidsum_tpu_torch.config import Config, ModelConfig, TrainConfig
from vidsum_tpu_torch.data import collate
from vidsum_tpu_torch.data.datasets import UserSummaries
from vidsum_tpu_torch.models.convert import params_from_jax, params_to_jax
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.ops.losses import mse_with_mask_loss
from vidsum_tpu_torch.ops.metrics import eval_metrics
from vidsum_tpu_torch.train import finetune as ft
from vidsum_tpu_torch.train.steps import (
    StagingRing, make_eval_forward, make_finetune_step, make_optimizer,
    move_batch,
)

KW = dict(in_features=48, d_model=64, num_heads=4, num_layers=2, max_len=256)
LR, WD = 1e-3, 1e-4
# vidsum_tpu.train exports a function named finetune over its module
jft = importlib.import_module("vidsum_tpu.train.finetune")


def _pair(dropout: float, seed: int = 0, **kw):
    cfg_kw = {**KW, **kw}
    jcfg = JaxModelConfig(dropout=dropout, **cfg_kw)
    params = jax.tree_util.tree_map(
        np.asarray, init_simnet(jax.random.PRNGKey(seed), jcfg))
    cfg = ModelConfig(dropout=dropout, **cfg_kw)
    model = SimNet(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return jcfg, params, cfg, model


def _batch(B, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, KW["in_features"])).astype(np.float32)
    t = rng.random((B, N)).astype(np.float32)
    mask = np.zeros((B, N), bool)
    mask[-1, N - 41:] = True
    x[mask] = 1000.0
    t[mask] = 1000.0
    return x, t, mask


def _grads_jax_layout(model):
    return params_to_jax({k: p.grad for k, p in model.named_parameters()})


def _assert_trees_close(got, want, rtol, atol):
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(flat_w[path]),
                                   rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("padded", [False, True])
def test_mse_with_mask_loss_matches_jax(padded):
    """With no padding the mean divides by the bucket width; with ragged
    padding by the longest true length, not the bucket width."""
    rng = np.random.default_rng(1)
    out = rng.normal(size=(3, 256, 1)).astype(np.float32)
    t = rng.random((3, 256)).astype(np.float32)
    mask = np.zeros((3, 256), bool)
    if padded:
        mask[0, 200:] = mask[1, 150:] = mask[2, 90:] = True
    want = jax_mse(jnp.asarray(out), jnp.asarray(t), jnp.asarray(mask))
    got = mse_with_mask_loss(torch.from_numpy(out), torch.from_numpy(t),
                             torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_collate_matches_jax():
    rng = np.random.default_rng(2)
    feats = [rng.normal(size=(n, 8)).astype(np.float32) for n in (5, 130, 77)]
    tgts = [rng.random(f.shape[0]).astype(np.float32) for f in feats]
    for got, want in zip(collate.pad_batch(feats, tgts),
                         jcollate.pad_batch(feats, tgts)):
        np.testing.assert_array_equal(got, want)
    # a long video lands in the bucket the flash training route expects
    x, _, mask = collate.pad_batch([np.zeros((8100, 1), np.float32)],
                                   [np.zeros(8100, np.float32)])
    assert x.shape[1] == 8192 and int((~mask).sum()) == 8100
    for shuffle in (False, True):
        got = list(collate.make_batches(11, 4, shuffle=shuffle,
                                        rng=np.random.default_rng((1, 2, 3))))
        want = list(jcollate.make_batches(
            11, 4, shuffle=shuffle, rng=np.random.default_rng((1, 2, 3))))
        assert got == want


def _jax_layer_seeds(key, n_layers):
    """The per-layer seeds ``simnet_apply`` draws on the fused-block train
    route (``simnet.py:346-349``)."""
    seeds = []
    for _ in range(n_layers):
        key, sub = jax.random.split(key)
        seeds.append(int(jax.random.randint(sub, (1, 1), 0, 2**31 - 1,
                                            jnp.int32)[0, 0]))
    return seeds


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_fused_block_step_matches_jax(dropout):
    """One step on the port's fused-block route (plain versions on the CPU)
    against the JAX step on ``pallas_block`` (interpret): the loss and the
    parameters after Adam. The JAX per-layer seeds go in as ``block_seeds``
    (at dropout 0 both use the layer index)."""
    jcfg, params, cfg, model = _pair(dropout)
    x, t, mask = _batch(2, 128, 3)
    key = jax.random.PRNGKey(5)
    opt = jsteps.make_optimizer(LR, WD)
    jstep = jsteps.make_finetune_step(jcfg, opt, attn_impl="pallas_block")
    new_params, _, jloss = jstep(
        jax.tree_util.tree_map(jnp.asarray, params),
        opt.init(jax.tree_util.tree_map(jnp.asarray, params)),
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask), key)
    seeds = (_jax_layer_seeds(key, cfg.num_layers) if dropout > 0
             else None)
    step = make_finetune_step(cfg, "fused_block", device="cpu")
    loss = step(model, make_optimizer(model, LR, WD), x, t, mask,
                torch.Generator().manual_seed(0), block_seeds=seeds)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    # Adam's first step moves a parameter by lr * g / (|g| + eps): where a
    # gradient is near zero, its f32 summation-order difference moves the
    # update by a fraction of lr (measured: 1 of 16,384 entries, 0.03 lr), so
    # the bound is 0.1 lr; a wrong gradient moves many entries by up to 2 lr
    _assert_trees_close(params_to_jax(model.state_dict()),
                        jax.tree_util.tree_map(np.asarray, new_params),
                        rtol=1e-5, atol=0.1 * LR)


def test_dense_route_with_injected_masks_matches_jax():
    """Dropout 0.3 on the dense route with the same keep masks in both
    packages: loss and every gradient."""
    jcfg, params, cfg, model = _pair(0.3)
    x, t, mask = _batch(2, 128, 4)
    B, N, d = 2, 128, KW["d_model"]
    rng = np.random.default_rng(6)
    masks = [{"attn": rng.random((B, KW["num_heads"], N, N)) < 0.7,
              "res1": rng.random((B, N, d)) < 0.7,
              "mlp": rng.random((B, N, 4 * d)) < 0.7,
              "res2": rng.random((B, N, d)) < 0.7}
             for _ in range(KW["num_layers"])]

    def jloss_fn(p):
        s, _ = simnet_apply(p, jcfg, jnp.asarray(x), jnp.asarray(mask),
                            deterministic=False, attn_impl="xla",
                            dropout_masks=[{k: jnp.asarray(v)
                                            for k, v in m.items()}
                                           for m in masks])
        return jax_mse(s, jnp.asarray(t), jnp.asarray(mask))

    jloss, jgrads = jax.value_and_grad(jloss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params))
    scores, _ = model(torch.from_numpy(x), torch.from_numpy(mask),
                      attn_impl="dense", deterministic=False,
                      dropout_masks=masks)
    loss = mse_with_mask_loss(scores, torch.from_numpy(t),
                              torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_trees_close(_grads_jax_layout(model),
                        jax.tree_util.tree_map(np.asarray, jgrads),
                        rtol=1e-3, atol=1e-6)


def _jax_flash_seeds(key, n_layers):
    """The per-layer attention seeds ``simnet_apply`` draws on the pallas
    training route: ``r_attn`` of each layer's five-way split
    (``simnet.py:360``), then ``randint`` (``simnet.py:154-155``)."""
    seeds = []
    for _ in range(n_layers):
        key, r_attn, _, _, _ = jax.random.split(key, 5)
        seeds.append(int(jax.random.randint(r_attn, (1, 1), 0, 2**31 - 1,
                                            jnp.int32)[0, 0]))
    return seeds


@pytest.mark.parametrize("norm_first", [False, True])
def test_flash_route_with_injected_masks_matches_jax(norm_first):
    """Dropout 0.3 on the port's ``"flash"`` route against JAX's
    ``"pallas"`` route (the Pallas training kernels in interpret mode): the
    same residual and MLP keep masks in both, the JAX per-layer attention
    seeds handed to the port as ``block_seeds``; loss and every gradient.
    The ``"attn"`` masks are not read on this route in either package."""
    jcfg, params, cfg, model = _pair(0.3, norm_first=norm_first)
    B, N, d = 2, 256, KW["d_model"]
    x, t, mask = _batch(B, N, 13)
    rng = np.random.default_rng(14)
    masks = [{"attn": rng.random((B, KW["num_heads"], N, N)) < 0.7,
              "res1": rng.random((B, N, d)) < 0.7,
              "mlp": rng.random((B, N, 4 * d)) < 0.7,
              "res2": rng.random((B, N, d)) < 0.7}
             for _ in range(KW["num_layers"])]
    key = jax.random.PRNGKey(21)

    def jloss_fn(p):
        s, _ = simnet_apply(p, jcfg, jnp.asarray(x), jnp.asarray(mask),
                            rng=key, deterministic=False, attn_impl="pallas",
                            dropout_masks=[{k: jnp.asarray(v)
                                            for k, v in m.items()}
                                           for m in masks])
        return jax_mse(s, jnp.asarray(t), jnp.asarray(mask))

    # jitted: run eagerly, JAX dispatches further ops while the interpret
    # mode's callbacks dispatch their own, and under load the two can block
    # each other
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(
        jax.tree_util.tree_map(jnp.asarray, params))
    scores, _ = model(torch.from_numpy(x), torch.from_numpy(mask),
                      attn_impl="flash", deterministic=False,
                      dropout_masks=masks,
                      block_seeds=_jax_flash_seeds(key, KW["num_layers"]))
    loss = mse_with_mask_loss(scores, torch.from_numpy(t),
                              torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_trees_close(_grads_jax_layout(model),
                        jax.tree_util.tree_map(np.asarray, jgrads),
                        rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("route", ["flash", "demoted"])
def test_flash_route_step_matches_jax(route, monkeypatch, request):
    """One step at dropout 0 on ``"flash"`` against JAX's ``"pallas"``, and
    on ``"fused_block"`` against ``"pallas_block"`` with
    ``fused_block_train_supported`` patched to False in both packages (the
    demotion past the block envelope): loss and parameters after Adam
    (bounds as in the fused-block step). A spy shows that every layer's
    attention went through the port's ``flash_attention_dropout``."""
    jcfg, params, cfg, model = _pair(0.0)
    x, t, mask = _batch(2, 128, 15)
    jimpl, impl = (("pallas", "flash") if route == "flash"
                   else ("pallas_block", "fused_block"))
    if route == "demoted":
        # read at trace time inside the jitted JAX step
        jax.clear_caches()
        request.addfinalizer(jax.clear_caches)
        monkeypatch.setattr(jbt, "fused_block_train_supported",
                            lambda *a: False)
        monkeypatch.setattr(simnet_mod, "fused_block_train_supported",
                            lambda *a: False)
    calls = []
    spied = simnet_mod.flash_attention_dropout
    monkeypatch.setattr(simnet_mod, "flash_attention_dropout",
                        lambda *a: calls.append(1) or spied(*a))
    opt = jsteps.make_optimizer(LR, WD)
    jstep = jsteps.make_finetune_step(jcfg, opt, attn_impl=jimpl)
    new_params, _, jloss = jstep(
        jax.tree_util.tree_map(jnp.asarray, params),
        opt.init(jax.tree_util.tree_map(jnp.asarray, params)),
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask),
        jax.random.PRNGKey(5))
    step = make_finetune_step(cfg, impl, device="cpu")
    loss = step(model, make_optimizer(model, LR, WD), x, t, mask,
                torch.Generator().manual_seed(0))
    assert len(calls) == cfg.num_layers
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_trees_close(params_to_jax(model.state_dict()),
                        jax.tree_util.tree_map(np.asarray, new_params),
                        rtol=1e-5, atol=0.1 * LR)


def test_norm_first_and_return_attn_match_jax():
    """Pre-LN blocks and the exported attention weights (dense route)."""
    jcfg, params, cfg, model = _pair(0.0, norm_first=True)
    x, _, mask = _batch(2, 128, 7)
    js, _, jmaps = simnet_apply(jax.tree_util.tree_map(jnp.asarray, params),
                                jcfg, jnp.asarray(x), jnp.asarray(mask),
                                return_attn=True)
    with torch.no_grad():
        s, _, maps = model(torch.from_numpy(x), torch.from_numpy(mask),
                           return_attn=True, attn_impl="fused_block")
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    assert len(maps) == len(jmaps) == KW["num_layers"]
    for a, b in zip(maps, jmaps):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_three_adam_steps_match_optax():
    """torch Adam(weight_decay) against optax add_decayed_weights + adam on
    the same gradients."""
    _, params, _, model = _pair(0.0)
    opt = jsteps.make_optimizer(LR, WD)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    topt = make_optimizer(model, LR, WD)
    rng = np.random.default_rng(8)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32) * 1e-2,
            params)
        updates, state = opt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        tgrads = params_from_jax(grads)
        for k, p in model.named_parameters():
            p.grad = tgrads[k].clone()
        topt.step()
    _assert_trees_close(params_to_jax(model.state_dict()),
                        jax.tree_util.tree_map(np.asarray, jp),
                        rtol=1e-6, atol=1e-7)


def _videos(n_videos, seed, in_features=KW["in_features"], lo=60, hi=120):
    """In-memory items in the schema of ``vidsum_tpu/data/synthetic.py``:
    (features, gtscore, UserSummaries) with a learnable gtscore."""
    rng = np.random.default_rng(seed)
    probe = rng.normal(size=(in_features,)).astype(np.float32)
    items = []
    for vi in range(n_videos):
        n_picks = int(rng.integers(lo, hi + 1))
        picks = np.arange(n_picks) * 15
        n_frames = int(picks[-1] + rng.integers(1, 16))
        feats = rng.normal(size=(n_picks, in_features)).astype(np.float32)
        gt = (1 / (1 + np.exp(-(feats @ probe) / in_features ** 0.5))
              ).astype(np.float32)
        cuts = np.sort(rng.choice(np.arange(1, n_frames), size=5,
                                  replace=False))
        bounds = np.concatenate([[0], cuts, [n_frames]])
        cps = np.stack([bounds[:-1], bounds[1:] - 1], axis=1)
        frame = np.repeat(gt, 15)[:n_frames]
        user_scores = np.clip(frame[None] + 0.1 * rng.normal(
            size=(5, n_frames)), 0, None).astype(np.float32)
        base = (frame >= np.quantile(frame, 0.85)).astype(np.int8)
        user_summary = np.stack([base ^ (rng.random(n_frames) < 0.05)
                                 .astype(np.int8) for _ in range(5)])
        items.append((feats, gt, UserSummaries(
            user_summary=user_summary, user_scores=user_scores,
            change_points=cps, n_frames=n_frames, picks=picks,
            name=f"video_{vi}")))
    return items


def test_eval_metrics_equal_jax():
    items = _videos(6, 9, lo=40, hi=200)
    rng = np.random.default_rng(10)
    scores = {u.name: rng.random(f.shape[0]).astype(np.float32)
              for f, _, u in items}
    users = {u.name: u for _, _, u in items}
    got = eval_metrics(scores, users)
    want = jax_eval_metrics(scores, users)
    assert got[0] == want[0]
    np.testing.assert_array_equal(np.asarray(got[1:]), np.asarray(want[1:]))
    # the device route gives the same numbers; it runs on the card unless
    # asked for the CPU
    assert eval_metrics(scores, users, impl="device", device="cpu") == got
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            eval_metrics(scores, users, impl="device")


def test_two_epochs_match_jax():
    """Two epochs of train + val at dropout 0 (dense route): per-epoch train
    loss within f32 summation-order differences (rtol 1e-5) and the val
    loss, F, tau and rho within 1e-5."""
    jcfg, params, cfg, model = _pair(0.0, num_layers=1)
    train = [it[:2] for it in _videos(8, 11)]
    val = _videos(4, 12)
    jconf = JaxConfig(model=jcfg, train=JaxTrainConfig(batch_size=4))
    conf = Config(model=cfg, train=TrainConfig(batch_size=4))
    opt = jsteps.make_optimizer(LR, WD)
    jstep = jsteps.make_finetune_step(jcfg, opt, attn_impl="xla")
    jfwd = jsteps.make_eval_forward(jcfg, attn_impl="xla")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = opt.init(jp)
    step = make_finetune_step(cfg, conf.train.attn_impl, device="cpu")
    assert step.attn_impl == "dense"    # "auto" on the CPU
    fwd = make_eval_forward(cfg, device="cpu")
    topt = make_optimizer(model, LR, WD)
    for epoch in range(2):
        jp, jstate, jloss, _ = jft._train_epoch(
            jstep, jp, jstate, train, jconf,
            np.random.default_rng((1234, 0, epoch)), jax.random.PRNGKey(0))
        rng_np, gen = ft.epoch_streams(1234, 0, epoch)
        loss = ft._train_epoch(step, model, topt, train, conf, rng_np, gen)
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        got = ft._val_epoch(fwd, model, val, conf)
        want = jft._val_epoch(jfwd, jp, val, jconf)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_epoch_streams_are_per_split_and_epoch():
    a_np, a_gen = ft.epoch_streams(1234, 0, 1)
    b_np, b_gen = ft.epoch_streams(1234, 0, 1)
    c_np, c_gen = ft.epoch_streams(1234, 1, 1)
    assert a_np.integers(1 << 30) == b_np.integers(1 << 30)
    assert torch.equal(torch.rand(4, generator=a_gen),
                       torch.rand(4, generator=b_gen))
    assert c_np.integers(1 << 30) != ft.epoch_streams(1234, 0, 1)[0].integers(
        1 << 30)
    assert not torch.equal(torch.rand(4, generator=c_gen),
                           torch.rand(4, generator=ft.epoch_streams(
                               1234, 0, 1)[1]))


# ------------------------------------------- the batch's move to the device

def _counts():
    return move_batch.staged, move_batch.staged_bytes, move_batch.direct


@pytest.mark.parametrize("inputs", ["numpy", "tensors", "finetune_step"])
def test_move_batch_on_the_cpu_stages_nothing(inputs):
    """To the CPU every array passes through: numpy arrays as tensors over
    their own memory, tensors already there as themselves, each counted in
    ``move_batch.direct``; nothing is staged and the ring stays empty (the
    staged path needs a card: ``tests/test_torch_cuda.py``)."""
    x, t, mask = _batch(2, 128, seed=5)
    before = _counts()
    dev = torch.device("cpu")
    if inputs == "finetune_step":
        cfg, model = _pair(0.3)[2:]
        step = make_finetune_step(cfg, "dense", device=dev)
        opt = make_optimizer(model, LR, WD)
        loss = step(model, opt, x, t, mask, torch.Generator().manual_seed(1))
        assert bool(torch.isfinite(loss))
        ring = step.staging
    else:
        ring = StagingRing()
        arrays = ((x, t, mask) if inputs == "numpy" else
                  tuple(torch.from_numpy(a) for a in (x, t, mask)))
        out = move_batch(arrays, dev, ring)
        for got, a in zip(out, arrays):
            if inputs == "numpy":
                assert got.data_ptr() == a.ctypes.data
                assert got.dtype == torch.from_numpy(a).dtype
                assert got.shape == a.shape
            else:
                assert got is a
    staged, staged_bytes, direct = _counts()
    assert (staged, staged_bytes) == before[:2]
    assert direct == before[2] + 3
    assert ring.held_bytes() == 0

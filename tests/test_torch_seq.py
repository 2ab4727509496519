"""The port's sequence-parallel SimNet (``vidsum_tpu_torch/parallel/
seq_forward.py``) and mesh serving (``serve/mesh.py``) on the CPU, against
the JAX package's on its forced CPU devices: the seq-sharded forward, one
finetune step at dropout 0.3 with the JAX step's seeds (loss and updated
parameters, the tolerances of tests/test_seq_train.py), its invariance
under the mesh shape, the loss's ``reduction``, and
``ScoringService(mesh=...)``: short requests (the single-device batch path,
and replica batches where the entries name several devices) equal solo
scores bit for bit, a long request takes the ring and matches the dense
forward, and the ``use_cls``, int8-wire and coalesced-wire refusals. Meshes
repeat the ``"cpu"`` device."""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from vidsum_tpu.config import ModelConfig as JaxModelConfig
from vidsum_tpu.models import init_simnet
from vidsum_tpu.ops.losses import mse_with_mask_loss as jax_mse
from vidsum_tpu.parallel.seq_forward import (
    make_seq_sharded_finetune_step as jax_seq_step,
    make_seq_sharded_forward as jax_seq_forward,
)
from vidsum_tpu.train.steps import make_optimizer as jax_optimizer
from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.data.collate import bucket_length
from vidsum_tpu_torch.models.convert import params_from_jax, params_to_jax
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.ops.losses import mse_with_mask_loss
from vidsum_tpu_torch.parallel import (
    make_mesh, make_seq_sharded_finetune_step, make_seq_sharded_forward,
)
from vidsum_tpu_torch.serve import ScoringService
from vidsum_tpu_torch.train.steps import make_eval_forward, make_optimizer

LR, WD = 1e-3, 1e-4


def _pair(seed=0, **kw):
    jcfg = JaxModelConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, init_simnet(jax.random.PRNGKey(seed), jcfg))
    model = SimNet(ModelConfig(**kw), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return jcfg, params, ModelConfig(**kw), model


def _jmesh(data, seq):
    return Mesh(np.asarray(jax.devices()[:data * seq]).reshape(data, seq),
                ("data", "seq"))


def _batch(B, N, in_features, pad_from, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, in_features)).astype(np.float32)
    t = rng.random((B, N)).astype(np.float32)
    mask = np.zeros((B, N), bool)
    mask[:, pad_from:] = True
    return x, t, mask


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("shape", [(2, 4), (1, 4)])
def test_seq_forward_matches_jax(shape):
    kw = dict(in_features=48, d_model=64, num_heads=4, num_layers=2,
              dropout=0.0, max_len=128)
    jcfg, params, cfg, model = _pair(**kw)
    B, N = 2, 1024
    x, _, mask = _batch(B, N, 48, 900, 0)
    mask[1, 600:] = True  # the last shard of row 1 is entirely padding
    got_s, got_h = make_seq_sharded_forward(cfg, make_mesh(shape, "cpu"))(
        model, x, mask)
    want_s, want_h = jax_seq_forward(jcfg, _jmesh(*shape))(
        params, jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=2e-4,
                               atol=2e-4)
    # and the port's own dense forward: N = 1,024 > max_len, so the PE
    # table is indexed at each shard's global offset of a global table
    dense, _ = model(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got_s.numpy(), dense.detach().numpy(),
                               rtol=2e-4, atol=2e-4)


def test_seq_forward_refuses_cls():
    cfg = ModelConfig(in_features=48, d_model=64, num_heads=4, num_layers=1,
                      use_cls=True)
    with pytest.raises(ValueError, match="CLS"):
        make_seq_sharded_forward(cfg, make_mesh((1, 4), "cpu"))


# ------------------------------------------------------------ finetune step

STEP_KW = dict(in_features=1024, d_model=32, num_heads=4, num_layers=2,
               dropout=0.3, max_len=512)


def _jax_step(jcfg, params, shape, x, t, mask, key):
    opt = jax_optimizer(LR, WD)
    step = jax_seq_step(jcfg, opt, _jmesh(*shape), block_impl="xla")
    fresh = jax.tree_util.tree_map(jnp.array, params)
    p, _, loss = step(fresh, opt.init(fresh), jnp.asarray(x), jnp.asarray(t),
                      jnp.asarray(mask), key)
    return p, float(loss)


def _port_step(cfg, model, shape, x, t, mask, seeds, impl="auto"):
    m = copy.deepcopy(model)
    step = make_seq_sharded_finetune_step(cfg, make_mesh(shape, "cpu"),
                                          block_impl=impl)
    loss = step(m, make_optimizer(m, LR, WD), x, t, mask, seeds=seeds)
    return m, float(loss)


@pytest.mark.parametrize("impl,shape", [("auto", (2, 4)), ("kernel", (1, 4))])
def test_seq_step_matches_jax(impl, shape):
    """One step at dropout 0.3 with the JAX step's per-layer seeds: the loss
    within rtol 2e-5 and every updated parameter within rtol 2e-3 / atol
    5e-6 of the JAX step's (Adam's first step divides by |grad|, so f32
    reassociation shows there; the JAX tests' bound). ``"kernel"`` runs the
    fused ring (the plain versions of TPU kernels 16/17 on the CPU), Nl =
    128."""
    jcfg, params, cfg, model = _pair(seed=5, **STEP_KW)
    x, t, mask = _batch(2, 512, 1024, 460, 8)
    key = jax.random.PRNGKey(21)
    seeds = np.asarray(jax.random.randint(key, (cfg.num_layers,), 0,
                                          2**31 - 1, jnp.int32)).tolist()
    want_p, want_loss = _jax_step(jcfg, params, shape, x, t, mask, key)
    m, loss = _port_step(cfg, model, shape, x, t, mask, seeds, impl)
    np.testing.assert_allclose(loss, want_loss, rtol=2e-5)
    got_p = params_to_jax(m.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(want_p))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got_p):
        np.testing.assert_allclose(leaf, np.asarray(flat[path]), rtol=2e-3,
                                   atol=5e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_seq_step_pads_shards_to_the_key_tile(monkeypatch):
    """N = 448 on a (1, 4) mesh gives shards of 112 frames, not a multiple
    of the ring kernels' 64-key tile: the step pads the global length to 512
    (a spy on the ring sees Nl = 128) and still matches the JAX step at
    N = 448 within the bounds of ``test_seq_step_matches_jax``."""
    from vidsum_tpu_torch.parallel import seq_forward

    seen = []
    ring = seq_forward.ring_attention_train

    def spy(q, *args, **kwargs):
        seen.append(q[0].shape[2])
        return ring(q, *args, **kwargs)

    monkeypatch.setattr(seq_forward, "ring_attention_train", spy)
    jcfg, params, cfg, model = _pair(seed=5, **STEP_KW)
    x, t, mask = _batch(2, 448, 1024, 400, 8)
    key = jax.random.PRNGKey(23)
    seeds = np.asarray(jax.random.randint(key, (cfg.num_layers,), 0,
                                          2**31 - 1, jnp.int32)).tolist()
    want_p, want_loss = _jax_step(jcfg, params, (1, 4), x, t, mask, key)
    m, loss = _port_step(cfg, model, (1, 4), x, t, mask, seeds, "kernel")
    assert seen == [128] * cfg.num_layers
    np.testing.assert_allclose(loss, want_loss, rtol=2e-5)
    got_p = params_to_jax(m.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(want_p))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got_p):
        np.testing.assert_allclose(leaf, np.asarray(flat[path]), rtol=2e-3,
                                   atol=5e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_seq_forward_pads_shards_to_the_key_tile():
    """The seq-sharded forward at N = 448 on a (1, 4) mesh (Nl 112, padded
    to 128) against the JAX forward at N = 448, at
    ``test_seq_forward_matches_jax``'s bound; the outputs keep N."""
    kw = dict(in_features=48, d_model=64, num_heads=4, num_layers=2,
              dropout=0.0, max_len=128)
    jcfg, params, cfg, model = _pair(**kw)
    x, _, mask = _batch(2, 448, 48, 430, 1)
    got_s, got_h = make_seq_sharded_forward(cfg, make_mesh((1, 4), "cpu"))(
        model, x, mask)
    want_s, want_h = jax_seq_forward(jcfg, _jmesh(1, 4))(
        params, jnp.asarray(x), jnp.asarray(mask))
    assert got_s.shape == (2, 448, 1) and got_h.shape == (2, 448, 64)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=2e-4,
                               atol=2e-4)


def test_seq_step_mesh_shape_invariant():
    """Coordinate-absolute masks: the loss is the same on (1, 4), (2, 2) and
    (4, 1) meshes."""
    cfg = ModelConfig(**{**STEP_KW, "in_features": 48})
    model = SimNet(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    x, t, mask = _batch(4, 256, 48, 230, 3)
    losses = [_port_step(cfg, model, shape, x, t, mask, [11, 22])[1]
              for shape in ((1, 4), (2, 2), (4, 1))]
    np.testing.assert_allclose(losses[1], losses[0], rtol=2e-5)
    np.testing.assert_allclose(losses[2], losses[0], rtol=2e-5)


def test_seq_step_fully_padded_row_and_generator():
    """A batch row that is all padding leaves every gradient finite; without
    ``seeds`` the per-layer seeds come from the generator."""
    cfg = ModelConfig(**{**STEP_KW, "in_features": 48})
    model = SimNet(cfg, device="cpu")
    x, t, _ = _batch(2, 256, 48, 256, 4)
    mask = np.zeros((2, 256), bool)
    mask[1] = True
    step = make_seq_sharded_finetune_step(cfg, make_mesh((1, 2), "cpu"))
    losses = []
    for _ in range(2):
        m = copy.deepcopy(model)
        loss = step(m, make_optimizer(m, LR, 0.0), x, t, mask,
                    torch.Generator().manual_seed(9))
        losses.append(float(loss))
        assert np.isfinite(losses[-1])
        assert all(torch.isfinite(p.grad).all() and torch.isfinite(p).all()
                   for p in m.parameters())
    assert losses[0] == losses[1]
    with pytest.raises(ValueError, match="generator"):
        step(model, make_optimizer(model, LR, 0.0), x, t, mask)


@pytest.mark.parametrize("kw,match", [
    (dict(use_cls=True), "CLS"), (dict(pos_dropout=0.1), "pos_dropout"),
    (dict(num_heads=64, d_model=64 * 4), "collides")])
def test_seq_step_refusals(kw, match):
    cfg = ModelConfig(**{**STEP_KW, **kw})
    with pytest.raises(ValueError, match=match):
        make_seq_sharded_finetune_step(cfg, make_mesh((1, 4), "cpu"))


@pytest.mark.parametrize("reduction", ["avg", "sum"])
def test_loss_reduction_matches_jax(reduction):
    rng = np.random.default_rng(2)
    out = rng.normal(size=(3, 40, 1)).astype(np.float32)
    t = rng.random((3, 40)).astype(np.float32)
    mask = np.zeros((3, 40), bool)
    mask[0, 30:] = True
    mask[2, 10:] = True
    got = mse_with_mask_loss(*map(torch.from_numpy, (out, t, mask)),
                             reduction=reduction)
    want = jax_mse(*map(jnp.asarray, (out, t, mask)), reduction=reduction)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------ mesh serving

SERVE_KW = dict(in_features=32, d_model=64, num_heads=4, num_layers=2,
                max_len=512)


@pytest.fixture(scope="module")
def served():
    _, _, cfg, model = _pair(**SERVE_KW)
    return cfg, model


def _videos(rng, lengths):
    return [rng.normal(size=(n, 32)).astype(np.float32) for n in lengths]


def _solo(cfg, model, v, bucket=128):
    n = v.shape[0]
    nb = bucket_length(n, bucket)
    x = np.full((1, nb, 32), 1000.0, np.float32)
    x[0, :n] = v
    mask = np.ones((1, nb), bool)
    mask[0, :n] = False
    return x, mask


@pytest.mark.parametrize("replicas", [False, True])
def test_mesh_service_replicas_and_long_route(served, monkeypatch,
                                              replicas):
    """On a (1, 4) mesh of one device short requests take the single-device
    batch path; with replicas (forced here, as a mesh over several cards
    gives them) they run as replica batches. Either way they equal their
    solo scores bit for bit; the two past long_threshold take the ring
    (long_requests == 2) and match the direct seq-sharded forward and,
    within 2e-4, the dense forward."""
    from vidsum_tpu_torch.serve import mesh as mesh_mod

    if replicas:
        monkeypatch.setattr(mesh_mod, "_replica_devices", lambda devs: devs)
    cfg, model = served
    mesh = make_mesh((1, 4), "cpu")
    rng = np.random.default_rng(0)
    lengths = (37, 100, 128, 250, 300, 300, 700, 1500)
    videos = _videos(rng, lengths)
    with ScoringService(model, cfg, device="cpu", mesh=mesh,
                        long_threshold=512, max_batch=8,
                        max_delay_ms=200.0) as svc:
        assert (svc._rep_fwd is not None) == replicas
        assert (svc._fwd is None) == replicas
        results = [f.result(timeout=120) for f in
                   [svc.submit(v, want_summary=False) for v in videos]]
        st = svc.stats()
    assert st.completed == len(videos) and st.failed == 0
    assert st.long_requests == 2 and max(st.batch_hist) >= 2
    fwd = make_eval_forward(cfg, device="cpu")
    seq = make_seq_sharded_forward(cfg, mesh)
    for v, r in zip(videos, results):
        n = v.shape[0]
        if n <= 512:
            x, mask = _solo(cfg, model, v)
            np.testing.assert_array_equal(r.scores,
                                          fwd(model, x, mask)[0, :n].numpy())
            continue
        # the card holds served == direct bit for bit (chip_smoke.py); on
        # the CPU the dispatcher thread's GEMMs may split their sums
        # otherwise than the test thread's
        x, mask = _solo(cfg, model, v, bucket=512)
        direct = torch.sigmoid(seq(model, x, mask)[0][0, :n, 0]).numpy()
        np.testing.assert_allclose(r.scores, direct, rtol=1e-6, atol=1e-7)
        dense = fwd(model, x, mask)[0, :n].numpy()
        np.testing.assert_allclose(r.scores, dense, rtol=2e-4, atol=2e-4)


def test_mesh_service_use_cls_warns_and_refuses(served):
    """As in the JAX package: with ``use_cls`` the ring route does not exist;
    a long_threshold is refused, and without one the service warns and caps
    requests at the single-device envelope."""
    _, model = served
    cfg = ModelConfig(use_cls=True, **SERVE_KW)
    cls_model = SimNet(cfg, device="cpu")
    mesh = make_mesh((1, 2), "cpu")
    with pytest.raises(ValueError, match="long_threshold was given"):
        ScoringService(cls_model, cfg, device="cpu", mesh=mesh,
                       long_threshold=512)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        svc = ScoringService(cls_model, cfg, device="cpu", mesh=mesh,
                             attn_impl="flash", max_delay_ms=0.0)
    try:
        assert any("no sequence-parallel long route" in str(w.message)
                   for w in caught)
        assert svc._long_fwd is None and svc._long_cap is None
        r = svc.submit(np.zeros((200, 32), np.float32),
                       want_summary=False).result(timeout=120)
        assert r.scores.shape == (200,)
    finally:
        svc.close()


def test_mesh_service_wire_refusals(served):
    cfg, model = served
    mesh = make_mesh((1, 2), "cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU slice"):
        ScoringService(model, cfg, device="cpu", mesh=mesh,
                       wire_dtype="int8")
    with pytest.raises(ValueError, match="single-chip only"):
        ScoringService(model, cfg, device="cpu", mesh=mesh,
                       wire_mode="coalesced")
    # a one-entry mesh is a single-device service
    with ScoringService(model, cfg, device="cpu", mesh=make_mesh((1, 1),
                                                                 "cpu"),
                        wire_mode="coalesced") as svc:
        assert svc._mesh_devices is None


def test_mesh_service_long_cap(served):
    """On a kernel route the ring carries P times the single-device cap;
    past it a request is refused at submit naming the ring."""
    cfg, model = served
    from vidsum_tpu_torch.serve import RequestTooLong

    with ScoringService(model, cfg, device="cpu", attn_impl="flash",
                        mesh=make_mesh((1, 2), "cpu"), long_threshold=512,
                        max_delay_ms=0.0) as svc:
        assert svc._long_cap == 2 * svc._short_cap
        with pytest.raises(RequestTooLong, match="sequence-parallel ring"):
            svc.submit(np.zeros((svc._long_cap + 1, 32), np.float32))

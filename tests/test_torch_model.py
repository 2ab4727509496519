"""The port's SimNet and eval forward against the JAX package's, on the CPU
in f32, with the weights carried across by ``params_from_jax``; plus the
port's device policy and the features it leaves to later slices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsum_tpu.config import ModelConfig as JaxModelConfig
from vidsum_tpu.models import init_simnet, simnet_apply
from vidsum_tpu.train.steps import make_eval_forward as jax_make_eval_forward
from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.models.convert import params_from_jax, params_to_jax
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.train.steps import make_eval_forward

KW = dict(in_features=48, d_model=64, num_heads=4, num_layers=2,
          max_len=256)


def _pair(use_cls: bool, seed: int = 0):
    jcfg = JaxModelConfig(dropout=0.0, use_cls=use_cls, **KW)
    params = init_simnet(jax.random.PRNGKey(seed), jcfg)
    if use_cls:   # a non-zero CLS token, so the test sees where it goes
        params["cls"] = jax.random.normal(jax.random.PRNGKey(99),
                                          params["cls"].shape)
    cfg = ModelConfig(use_cls=use_cls, **KW)
    model = SimNet(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, cfg, model.eval()


def _inputs(N: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, N, KW["in_features"])).astype(np.float32)
    mask = np.zeros((2, N), bool)
    mask[1, N - 77:] = True          # a padded tail on one row
    x[1, N - 77:] = 1000.0           # with the pad sentinel in it
    return x, mask


@pytest.fixture(scope="module")
def jax_scores():
    """simnet_apply(attn_impl='xla') once per (use_cls, N)."""
    cache = {}

    def get(use_cls, N):
        if (use_cls, N) not in cache:
            jcfg, params, _, _ = _pair(use_cls)
            x, mask = _inputs(N, N)
            s, _ = simnet_apply(params, jcfg, jnp.asarray(x),
                                jnp.asarray(mask), attn_impl="xla")
            cache[(use_cls, N)] = np.asarray(s)
        return cache[(use_cls, N)]

    return get


@pytest.mark.parametrize("use_cls", [False, True])
@pytest.mark.parametrize("N", [128, 384, 640])
@pytest.mark.parametrize("attn_impl", ["dense", "fused_block"])
def test_simnet_matches_jax_dense(jax_scores, attn_impl, N, use_cls):
    """With CLS the sequence is N+1 long, so "fused_block" demotes down the
    ladder to the dense path, as in the JAX package."""
    _, _, _, model = _pair(use_cls)
    x, mask = _inputs(N, N)
    with torch.inference_mode():
        got, hidden = model(torch.from_numpy(x), torch.from_numpy(mask),
                            attn_impl=attn_impl)
    want = jax_scores(use_cls, N)
    assert got.shape == want.shape == (2, N + int(use_cls), 1)
    assert got.dtype == torch.float32 and hidden.shape[-1] == KW["d_model"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["dense", "flash", "fused_block"])
def test_simnet_d512_matches_jax(attn_impl):
    """d_model 512 with 4 heads (head_dim 128), the width the JAX package
    runs on its fused block (tests/test_block_kernel.py:101): one layer at
    N = 128 against ``simnet_apply(attn_impl="xla")``."""
    kw = dict(KW, d_model=512, num_layers=1)
    jcfg = JaxModelConfig(dropout=0.0, **kw)
    params = init_simnet(jax.random.PRNGKey(3), jcfg)
    model = SimNet(ModelConfig(**kw), device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    x, mask = _inputs(128, 5)
    want, _ = simnet_apply(params, jcfg, jnp.asarray(x), jnp.asarray(mask),
                           attn_impl="xla")
    with torch.inference_mode():
        got, hidden = model.eval()(torch.from_numpy(x),
                                   torch.from_numpy(mask),
                                   attn_impl=attn_impl)
    assert hidden.shape == (2, 128, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["dense", "flash", "fused_block"])
@pytest.mark.parametrize("d,heads,layers", [(192, 2, 2), (768, 8, 1)])
def test_simnet_head96_matches_jax(attn_impl, d, heads, layers):
    """head_dim 96: d_model 192 with 2 heads (two layers) and 768 with 8
    (one layer), the head width of ``ModelConfig(d_model=384,
    num_heads=4)``, at N = 128 against ``simnet_apply(attn_impl="xla")``
    on every route."""
    kw = dict(KW, d_model=d, num_heads=heads, num_layers=layers)
    jcfg = JaxModelConfig(dropout=0.0, **kw)
    params = init_simnet(jax.random.PRNGKey(d), jcfg)
    model = SimNet(ModelConfig(**kw), device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    x, mask = _inputs(128, d)
    want, _ = simnet_apply(params, jcfg, jnp.asarray(x), jnp.asarray(mask),
                           attn_impl="xla")
    with torch.inference_mode():
        got, hidden = model.eval()(torch.from_numpy(x),
                                   torch.from_numpy(mask),
                                   attn_impl=attn_impl)
    assert hidden.shape == (2, 128, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["dense", "flash", "fused_block"])
@pytest.mark.parametrize("d,heads,layers", [(192, 4, 2), (320, 4, 1)])
def test_simnet_padded_head_dims_match_jax(attn_impl, d, heads, layers):
    """head_dim 48 (d_model 192 with 4 heads, two layers) and 80 (d_model
    320 with 4 heads, one layer), which the CUDA kernels run zero-padded to
    64 and 96, at N = 128 against ``simnet_apply(attn_impl="xla")`` on
    every route, 1e-5."""
    kw = dict(KW, d_model=d, num_heads=heads, num_layers=layers)
    jcfg = JaxModelConfig(dropout=0.0, **kw)
    params = init_simnet(jax.random.PRNGKey(d + heads), jcfg)
    model = SimNet(ModelConfig(**kw), device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    x, mask = _inputs(128, d + 1)
    want, _ = simnet_apply(params, jcfg, jnp.asarray(x), jnp.asarray(mask),
                           attn_impl="xla")
    with torch.inference_mode():
        got, hidden = model.eval()(torch.from_numpy(x),
                                   torch.from_numpy(mask),
                                   attn_impl=attn_impl)
    assert hidden.shape == (2, 128, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["dense", "flash", "fused_block"])
def test_make_eval_forward_matches_jax(attn_impl):
    jcfg, params, cfg, model = _pair(False, seed=3)
    x, mask = _inputs(256, 5)
    want = jax_make_eval_forward(jcfg, attn_impl="xla")(
        params, jnp.asarray(x), jnp.asarray(mask))
    got = make_eval_forward(cfg, attn_impl, device="cpu")(model, x, mask)
    assert got.shape == (2, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_params_from_jax_roundtrip_and_keys():
    _, params, _, model = _pair(True)
    state = model.state_dict()
    assert "embedding_layer.feature_transform.weight" in state
    assert "encoder.module_list.1.sa.feature_projection.bias" in state
    assert "encoder.module_list.0.mlp.fc1.weight" in state
    assert "final_layer.weight" in state and "embedding_layer.cls_token" in state
    back = params_to_jax(state)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_reference_mirror_state_dict_loads():
    """A reference-keyed state dict (the torch mirror of the original
    SimNet) loads into the port's module once its PE buffer is dropped, and
    both score alike."""
    from tests.torch_mirrors import ScorerMirror

    mirror = ScorerMirror(d_model=64, num_heads=4, num_layers=2,
                          dropout=0.0, max_len=256, in_features=48).eval()
    state = {k: v for k, v in mirror.state_dict().items() if k != "pe"}
    model = SimNet(ModelConfig(**KW), device="cpu")
    model.load_state_dict(state)
    x = torch.randn(1, 128, 48)
    with torch.inference_mode():
        want, _ = mirror(x)
        got, _ = model(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_pe_cache_holds_only_the_max_len_table():
    """Serving many long lengths must not keep a PE table per length."""
    model = SimNet(ModelConfig(**KW), device="cpu")
    with torch.inference_mode():
        for n in (384, 512, 128, 640):
            model(torch.zeros(1, n, 48))
    assert list(model._pe_cache) == ["cpu"]
    assert model._pe_cache["cpu"].shape == (KW["max_len"], KW["d_model"])


def test_init_is_seeded_by_the_generator():
    cfg = ModelConfig(**KW)
    a = SimNet(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    b = SimNet(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    c = SimNet(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["final_layer.weight"], sc["final_layer.weight"])
    bound = 1.0 / KW["in_features"] ** 0.5
    w = sa["embedding_layer.feature_transform.weight"]
    assert float(w.abs().max()) <= bound


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from vidsum_tpu_torch.serve import ScoringService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(**KW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SimNet(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_eval_forward(cfg)
    model = SimNet(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ScoringService(model, cfg)
    assert make_eval_forward(cfg, device="cpu").attn_impl == "dense"


def _long_training_input():
    """Past the block-train envelope (N = 20,480 at d 64, H 4), and past the
    key-folded training route's too (head_dim 16, f32)."""
    return torch.zeros(1, 20480, 48)


@pytest.mark.parametrize("kwargs,match", [
    (dict(), "dense"),
    (dict(attn_impl="flash"), "dense"),
])
def test_attn_fn_replaces_attention(kwargs, match):
    """A caller-supplied attention (the sequence-parallel ring) replaces
    the attention on every route that takes one, around the plain layers:
    the reference attention passed as ``attn_fn`` gives the ``"dense"``
    route's scores, and ``pos_offset`` indexes the PE table (the int8
    routes refuse ``attn_fn`` with the JAX package's ValueError,
    tests/test_torch_int8.py)."""
    from vidsum_tpu_torch.ops.attention import attention_reference

    cfg = ModelConfig(**KW)
    model = SimNet(cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 256, 48)).astype(np.float32))
    calls = []

    def attn(q, k, v, pad_mask):
        calls.append(q.shape)
        return attention_reference(q, k, v, pad_mask, cfg.attn_scale)

    with torch.no_grad():
        got, _ = model(x, attn_fn=attn, **kwargs)
        want, _ = model(x, attn_impl=match)
        assert len(calls) == cfg.num_layers
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
        # the second half at its global offset: the PE rows 128-255
        half, _ = model(x[:, 128:], attn_fn=attn, pos_offset=128, pe_len=256,
                        **kwargs)
        solo, _ = model(x[:, 128:], attn_fn=attn, **kwargs)
        assert not torch.equal(half, solo)
        with pytest.raises(ValueError, match="pe_len"):
            model(x, attn_fn=attn, pos_offset=3000, **kwargs)


@pytest.mark.parametrize("attn_impl", ["flash", "fused_block"])
def test_training_past_the_folded_envelope_raises(attn_impl):
    """The fused block demotes to the flash route past its envelope; past
    the key-folded training route's envelope too there is no single-GPU
    route, and both raise ``ValueError`` naming the sequence-parallel ring
    (the JAX package raises there too)."""
    model = SimNet(ModelConfig(**KW), device="cpu")
    with pytest.raises(ValueError, match="sequence-parallel ring"):
        model(_long_training_input(), deterministic=False,
              attn_impl=attn_impl, generator=torch.Generator().manual_seed(0))


def test_norm_first_raises_not_implemented():
    """Pre-LN blocks run on the dense route, and so does their training,
    except on the flash route, where they train through
    ``flash_attention_dropout``: at dropout 0 that gives the eval scores."""
    model = SimNet(ModelConfig(norm_first=True, **KW), device="cpu")
    x = torch.zeros(1, 128, 48)
    with torch.no_grad():
        a, _ = model(x, attn_impl="fused_block")
        b, _ = model(x, attn_impl="dense")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    x = torch.randn(1, 128, 48, generator=torch.Generator().manual_seed(2))
    plain = SimNet(ModelConfig(norm_first=True, **{**KW, "dropout": 0.0}),
                   device="cpu")
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        want, _ = plain(x, attn_impl="dense")
        got, _ = plain(x, deterministic=False, attn_impl="flash",
                       generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_training_needs_a_generator_and_draws_seeded_dropout():
    model = SimNet(ModelConfig(**KW), device="cpu")
    x = torch.randn(1, 128, 48, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="generator is required"):
        model(x, deterministic=False)
    for impl in ("dense", "fused_block", "flash"):
        runs = [model(x, deterministic=False, attn_impl=impl,
                      generator=torch.Generator().manual_seed(s))[0]
                for s in (3, 3, 4)]
        assert torch.equal(runs[0], runs[1])
        assert not torch.equal(runs[0], runs[2])

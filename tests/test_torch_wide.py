"""The widths the CUDA kernels used to refuse, held against the JAX package
on the CPU: SimNet at d_model 640, 1,024 and 1,280 with 4 heads (head_dim
160, 256 and 320: heads the kernels run in 128-column slices), 1,056 with
8 (head_dim 132; LayerNorm rows past 1,024 columns) and 200 with 4 (d_model
off the 32-column grid), one layer, on every route; one finetune step at d
1,024 with 4 heads on the JAX package's route for that shape; and the
serving attention's plain versions at head_dim 160 against the Pallas
kernels in interpret mode. Same numpy-seeded inputs and weights on both
sides (``models.convert.params_from_jax``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsum_tpu.config import ModelConfig as JaxModelConfig
from vidsum_tpu.models import init_simnet, simnet_apply
from vidsum_tpu.ops import attention as jax_attention
from vidsum_tpu.ops.losses import mse_with_mask_loss as jax_mse
from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.models.convert import params_from_jax, params_to_jax
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.ops import attention as attn_mod
from vidsum_tpu_torch.train.steps import make_finetune_step, make_optimizer

KW = dict(in_features=48, num_layers=1, max_len=256)
# (d_model, heads): head_dim 160, 256, 320, 132 and 50
WIDE = [(640, 4), (1024, 4), (1280, 4), (1056, 8), (200, 4)]
N = 128
LR, WD = 1e-3, 1e-4


def _pair(d, heads, dropout=0.0):
    kw = dict(KW, d_model=d, num_heads=heads)
    jcfg = JaxModelConfig(dropout=dropout, **kw)
    # jitted: the same weights as the eager init, in half its time
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: init_simnet(key, jcfg))(jax.random.PRNGKey(d + heads)))
    cfg = ModelConfig(dropout=dropout, **kw)
    model = SimNet(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return jcfg, params, cfg, model


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, N, KW["in_features"])).astype(np.float32)
    t = rng.random((2, N)).astype(np.float32)
    mask = np.zeros((2, N), bool)
    mask[1, N - 45:] = True          # a padded tail on one row
    x[mask] = 1000.0                 # with the pad sentinel in it
    t[mask] = 1000.0
    return x, t, mask


@pytest.fixture(scope="module")
def wide_case():
    """Per (d, heads): the port's model and ``simnet_apply(attn_impl=
    "xla")``'s scores, once."""
    cache = {}

    def get(d, heads):
        if (d, heads) not in cache:
            jcfg, params, _, model = _pair(d, heads)
            x, _, mask = _inputs(d)
            want = jax.jit(lambda p, x, m: simnet_apply(
                p, jcfg, x, m, attn_impl="xla")[0])(
                    jax.tree_util.tree_map(jnp.asarray, params),
                    jnp.asarray(x), jnp.asarray(mask))
            cache[(d, heads)] = (model.eval(), x, mask, np.asarray(want))
        return cache[(d, heads)]

    return get


@pytest.mark.parametrize("attn_impl", ["dense", "flash", "fused_block"])
@pytest.mark.parametrize("d,heads", WIDE)
def test_simnet_at_wide_shapes_matches_jax(wide_case, d, heads, attn_impl):
    """One layer at N = 128 on every route against ``simnet_apply(
    attn_impl="xla")``, 1e-5: the plain versions the card holds the sliced
    attention kernels and the looping row kernels to."""
    model, x, mask, want = wide_case(d, heads)
    with torch.inference_mode():
        got, hidden = model(torch.from_numpy(x), torch.from_numpy(mask),
                            attn_impl=attn_impl)
    assert hidden.shape == (2, N, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_finetune_step_at_d1024_matches_jax():
    """One step at d_model 1,024 with 4 heads (head_dim 256), dropout 0, on
    the JAX package's finetune route (``"pallas_block"``, which its
    predicates demote past the fused block's envelope, as the port's do)
    against the port's ``"fused_block"`` step: the loss (1e-5) and each
    parameter's gradient at the whole-step bound (ROADMAP.md: relative RMS
    2e-3, atol 1e-4 of the step's largest gradient). The parameters after
    Adam are not compared entry by entry: its first step moves an entry by
    about lr * sign(g), so a gradient within summation-order rounding of 0
    moves it by a fraction of lr in either package (1 of the 1,048,576
    entries of the value weight, by 0.11 lr)."""
    jcfg, params, cfg, model = _pair(1024, 4)
    x, t, mask = _inputs(11)

    @jax.jit
    def jloss_grads(p):
        def loss_fn(p):
            s, _ = simnet_apply(p, jcfg, jnp.asarray(x), jnp.asarray(mask),
                                rng=jax.random.PRNGKey(5),
                                deterministic=False,
                                attn_impl="pallas_block")
            return jax_mse(s, jnp.asarray(t), jnp.asarray(mask))
        return jax.value_and_grad(loss_fn)(p)

    jloss, jgrads = jloss_grads(jax.tree_util.tree_map(jnp.asarray, params))
    step = make_finetune_step(cfg, "fused_block", device="cpu")
    loss = step(model, make_optimizer(model, LR, WD), x, t, mask,
                torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(
        {k: p.grad for k, p in model.named_parameters()})))
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jgrads)))
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        g = np.asarray(got[path], np.float64)
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * top,
                                   err_msg=name)
        norm = float(np.linalg.norm(w))
        if norm > 1e-6 * top:
            assert np.linalg.norm(g - w) <= 2e-3 * norm, name


@pytest.mark.parametrize("folded", [False, True])
def test_serving_attention_at_head_dim_160_matches_pallas(folded):
    """TPU kernels 3 (single pass) and 4 (key-folded, kb 128) in interpret
    mode at head_dim 160 against the plain versions the card holds the
    sliced kernels to (the dense one and the fold over the kernels' 64-key
    tiles), 2e-5."""
    rng = np.random.default_rng(160)
    B, Hh, Nn, Dh = 2, 2, 256, 160
    q, k, v = (rng.normal(size=(B, Hh, Nn, Dh)).astype(np.float32)
               for _ in range(3))
    mask = np.zeros((B, Nn), bool)
    mask[1, 170:] = True
    scale = Dh ** -0.5
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    if folded:
        want = jax_attention._flash_attention_folded(
            jq, jk, jv, jm, scale, interpret=True, kb=128)
        got = attn_mod._flash_attention_folded(tq, tk, tv, tm, scale, 128)
    else:
        want = jax_attention._flash_attention(jq, jk, jv, jm, scale,
                                              interpret=True)
        got = attn_mod._flash_attention(tq, tk, tv, tm, scale)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        attn_mod.attention_folded_reference(tq, tk, tv, tm, scale,
                                            attn_mod.KEY_TILE).numpy(),
        want, rtol=2e-5, atol=2e-5)

"""The port's trainable fused block (``vidsum_tpu_torch/ops/block_train.py``)
against the JAX package's on the CPU: the dropout hash bit for bit, the plain
forward and autograd backward against the Pallas kernels in interpret mode
(as ``tests/test_block_train.py`` runs them) on the grouped and the
per-element route, and the routing predicates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vidsum_tpu.ops.block_train as jbt
from vidsum_tpu.config import ModelConfig as JaxModelConfig
from vidsum_tpu.models.simnet import _init_block
from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.models.simnet import EncoderBlock
from vidsum_tpu_torch.ops import block_train as bt

D, H = 64, 4
SCALE = JaxModelConfig(d_model=D, num_heads=H).attn_scale
SEED = 77
# the JAX tests' own bounds (tests/test_block_train.py): forward f32 2e-5,
# bf16 5e-2; dx rtol 1e-3 / atol 1e-4, parameter grads 2e-3 / 2e-4; bf16
# grads 1e-1 / 2e-1
FWD_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (5e-2, 5e-2)}
DX_TOL = {"float32": (1e-3, 1e-4), "bfloat16": (1e-1, 1e-1)}
DW_TOL = {"float32": (2e-3, 2e-4), "bfloat16": (1e-1, 2e-1)}
# (B, N): (2, 128) takes the grouped route, (1, 512) the per-element one
CASES = [(2, 128, 0.3, "float32"), (2, 128, 0.0, "float32"),
         (1, 512, 0.3, "float32"), (1, 512, 0.0, "float32"),
         (2, 128, 0.3, "bfloat16")]


def _block_pair(seed=3):
    jb = _init_block(jax.random.PRNGKey(seed),
                     JaxModelConfig(d_model=D, num_heads=H))
    jb = jax.tree_util.tree_map(np.asarray, jb)
    blk = EncoderBlock(ModelConfig(d_model=D, num_heads=H))
    lin = lambda m, p: (m.weight.data.copy_(torch.tensor(p["w"].T)),  # noqa
                        m.bias.data.copy_(torch.tensor(p["b"])))
    lin(blk.sa.q, jb["attn"]["q"])
    lin(blk.sa.k, jb["attn"]["k"])
    lin(blk.sa.v, jb["attn"]["v"])
    lin(blk.sa.feature_projection, jb["attn"]["proj"])
    lin(blk.mlp.fc1, jb["mlp"]["fc1"])
    lin(blk.mlp.fc2, jb["mlp"]["fc2"])
    for ln, p in ((blk.norm1, jb["ln1"]), (blk.norm2, jb["ln2"])):
        ln.weight.data.copy_(torch.tensor(p["scale"]))
        ln.bias.data.copy_(torch.tensor(p["bias"]))
    return jb, blk


def _torch_grads(blk):
    """The block's parameter grads in the JAX layout and flat order."""
    sa, mlp = blk.sa, blk.mlp
    mods = (sa.q, sa.k, sa.v, sa.feature_projection)
    out = []
    for m in mods:
        out += [m.weight.grad.T, m.bias.grad]
    out += [blk.norm1.weight.grad, blk.norm1.bias.grad]
    for m in (mlp.fc1, mlp.fc2):
        out += [m.weight.grad.T, m.bias.grad]
    out += [blk.norm2.weight.grad, blk.norm2.bias.grad]
    return dict(zip(bt.PARAM_NAMES, (t.numpy() for t in out)))


def _inputs(B, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    mask = np.zeros((B, N), bool)
    mask[-1, N - 37:] = True             # a padded tail on the last row
    co = rng.normal(size=(B, N, D)).astype(np.float32)
    return x, mask, co


@pytest.fixture(scope="module")
def jax_results():
    """Per case: the Pallas forward (interpret), the dense JAX reference,
    and the Pallas VJP's dx and parameter grads."""
    cache = {}

    def get(B, N, rate, dtype):
        key = (B, N, rate, dtype)
        if key not in cache:
            jb, _ = _block_pair()
            x, mask, co = _inputs(B, N, B * N)
            jx = jnp.asarray(x).astype(dtype)
            m8 = jnp.asarray(mask.astype(np.int8))[:, None, :]
            seed = jnp.asarray([[SEED]], jnp.int32)

            # one jitted program: run eagerly, JAX dispatches further ops
            # while the interpret mode's callbacks dispatch their own, and
            # under load the two can block each other
            @jax.jit
            def run(x_, b_, g):
                out, vjp = jax.vjp(
                    lambda a, b: jbt.fused_block_train(a, b, m8, seed, H,
                                                       SCALE, rate), x_, b_)
                return out, vjp(g)

            fwd, (dx, dparams) = run(jx, jb, jnp.asarray(co).astype(dtype))
            ref = jbt.block_reference_with_masks(jx, jb, jnp.asarray(mask),
                                                 SEED, H, SCALE, rate)
            cache[key] = dict(
                fwd=np.asarray(fwd, np.float32),
                ref=np.asarray(ref, np.float32),
                dx=np.asarray(dx, np.float32),
                grads=dict(zip(bt.PARAM_NAMES, (
                    np.asarray(g, np.float32)
                    for g in jbt._flatten_params(dparams)))))
        return cache[key]

    return get


@pytest.mark.parametrize("rate", [0.3, 0.0, 1.0 - 2.0 ** -20])
def test_hash_keep_equals_jax_bit_for_bit(rate):
    for seed in (0, 99, 2 ** 31 - 2):
        for site in (0, 1, 2, 3, 32, 33, 34):
            for b in (0, 5):
                for row0 in (0, 384):
                    want = np.asarray(jbt._hash_keep(
                        jnp.asarray(seed, jnp.int32), site, b, row0,
                        (128, 80), rate))
                    got = bt._hash_keep(seed, site, b, row0, (128, 80), rate)
                    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,N,rate,dtype", CASES)
def test_plain_forward_matches_jax(jax_results, B, N, rate, dtype):
    """The plain forward against the Pallas kernel (interpret) and the dense
    JAX reference with the same masks."""
    want = jax_results(B, N, rate, dtype)
    _, blk = _block_pair()
    x, mask, _ = _inputs(B, N, B * N)
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = bt.fused_block_train(torch.from_numpy(x).to(tdt), blk,
                                   torch.from_numpy(mask), SEED, H, SCALE,
                                   rate)
    assert got.dtype == tdt and got.shape == (B, N, D)
    rtol, atol = FWD_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want["fwd"], rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(got.float().numpy(), want["ref"], rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("B,N,rate,dtype", CASES)
def test_plain_backward_matches_jax_vjp(jax_results, B, N, rate, dtype):
    """dx and all 16 parameter grads of the autograd Function (plain
    backward on the CPU) against ``jax.vjp`` of the Pallas kernels."""
    want = jax_results(B, N, rate, dtype)
    _, blk = _block_pair()
    x, mask, co = _inputs(B, N, B * N)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    out = bt.fused_block_train(xt, blk, torch.from_numpy(mask), SEED, H,
                               SCALE, rate)
    out.backward(torch.from_numpy(co).to(tdt))
    assert xt.grad.dtype == tdt
    rtol, atol = DX_TOL[dtype]
    np.testing.assert_allclose(xt.grad.float().numpy(), want["dx"],
                               rtol=rtol, atol=atol)
    got = _torch_grads(blk)
    rtol, atol = DW_TOL[dtype]
    for name in bt.PARAM_NAMES:
        np.testing.assert_allclose(got[name], want["grads"][name], rtol=rtol,
                                   atol=atol, err_msg=name)


def test_dropout_masks_change_with_the_seed():
    """A planted fault the card check relies on: the forward at seed + 1
    differs from the forward at seed far beyond every tolerance."""
    _, blk = _block_pair()
    x, mask, _ = _inputs(2, 128, 256)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        a = bt.fused_block_train(xt, blk, mt, SEED, H, SCALE, 0.3)
        b = bt.fused_block_train(xt, blk, mt, SEED + 1, H, SCALE, 0.3)
    assert float((a - b).abs().max()) > 0.5


def test_routing_predicates_match_jax():
    for B in (1, 2, 3, 4, 8, 32):
        for N in (128, 256, 384, 512, 640, 1152, 2048, 5120, 8192, 10240,
                  20480):
            assert bt._pick_train_group(B, N) == jbt._pick_train_group(B, N)
            assert bt._pick_fwd_tile(N) == jbt._pick_fwd_tile(N)
            assert bt._pick_bwd_tile(N) == jbt._pick_bwd_tile(N)
            for d, h in ((64, 4), (256, 4), (256, 8)):
                assert (bt.fused_block_train_supported(B, N, d, h)
                        == jbt.fused_block_train_supported(B, N, d, h)), (
                    B, N, d, h)
    assert not bt.fused_block_train_supported(4, 200, 256, 4)


@pytest.mark.parametrize("M,N,K,want", [
    # (32, 512), d 256: the forward's and the dX products fill the card
    (16384, 768, 256, 1), (16384, 256, 1024, 1), (16384, 256, 768, 1),
    # its dW products over all 16,384 rows: dWf2, dWf1, dWp, dWqkv
    (256, 1024, 16384, 16), (1024, 256, 16384, 16), (256, 256, 16384, 64),
    (768, 256, 16384, 22),
    # (8, 256): fc2 / dh1, dx and the dW products over 2,048 rows
    (2048, 256, 1024, 4), (2048, 256, 768, 3), (256, 256, 2048, 8),
])
def test_gemm_splits_at_the_main_path_shapes(M, N, K, want):
    """``bt_gemm`` splits K where its 128 x 128 tiles leave SMs idle, as far
    as one wave of 2 CTAs an SM holds and no split under 256 deep (132 SMs:
    an H100 SXM)."""
    assert bt.gemm_splits(M, N, K, 132) == want


def test_rejects_rates_and_heads_the_hash_cannot_take():
    _, blk = _block_pair()
    x = torch.zeros(1, 128, D)
    with pytest.raises(ValueError, match="rate"):
        bt.fused_block_train(x, blk, None, 0, H, SCALE, 1.0)
    with pytest.raises(ValueError, match="heads"):
        bt.fused_block_train(x, blk, None, 0, 64, SCALE, 0.3)


def _strided(rows, width, offset=0, row_stride=None):
    """A (rows, width) f32 view into a flat buffer at element ``offset``
    with row stride ``row_stride`` (default ``width``)."""
    rs = row_stride or width
    buf = torch.zeros(offset + rows * rs + width, dtype=torch.float32)
    return buf.as_strided((rows, width), (rs, 1), offset)


@pytest.mark.parametrize("case,want", [
    ("contiguous", True), ("none", True), ("offset_4", True),
    ("offset_1", False), ("row_stride_770", False), ("row_stride_772", True),
    ("column_stride_2", False)])
def test_attention_layout_predicate(case, want):
    """``attention_layout_ok`` (what the f32 attention kernels' 16-byte
    copies and stores need) on CPU views of each layout: data on a 16-byte
    boundary, unit last stride, the other strides multiples of 4."""
    t = {"contiguous": lambda: torch.zeros(128, 768),
         "none": lambda: None,
         "offset_4": lambda: _strided(128, 768, offset=4),
         "offset_1": lambda: _strided(128, 768, offset=1),
         "row_stride_770": lambda: _strided(128, 768, row_stride=770),
         "row_stride_772": lambda: _strided(128, 768, row_stride=772),
         "column_stride_2": lambda: torch.zeros(128, 1536)[:, ::2]}[case]()
    assert t is None or t.data_ptr() % 16 == 0 or case == "offset_1"
    assert bt.attention_layout_ok(torch.zeros(4, 8), t) is want


def test_attention_wrappers_refuse_misaligned_operands():
    """The block's attention wrappers raise on a fused QKV buffer off its
    16-byte boundary or with another row stride before any launch (no
    scalar fallback), here on CPU tensors, which never reach a kernel."""
    B, H, N, Dh = 2, 4, 128, 16
    d = H * Dh
    dr = bt._Drop(7, N, bt._threshold(0.3), bt._keep_scale(0.3))
    mask8 = torch.zeros(B, N, dtype=torch.uint8)
    for qkv in (_strided(B * N, 3 * d, offset=1),
                _strided(B * N, 3 * d, row_stride=3 * d + 4)):
        with pytest.raises(ValueError):
            bt._attention_fwd(qkv, mask8, B, H, N, 0.25, dr, keep=True)
        o, do = torch.zeros(B * N, d), _strided(B * N, d, offset=2)
        with pytest.raises(ValueError):
            bt._attention_bwd(qkv, o, do, torch.zeros(B, H, N), mask8, B, H,
                              N, 0.25, dr)

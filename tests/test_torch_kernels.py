"""The port's kernel modules (ops/block_kernel.py, ops/attention.py) against
the JAX package's Pallas kernels, on the CPU: the port's plain PyTorch
versions (what its wrappers run on CPU tensors) against the Pallas kernels in
interpret mode, as tests/test_block_kernel.py and tests/test_attention.py run
them, plus the routing arithmetic request for request."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsum_tpu.config import ModelConfig as JaxModelConfig
from vidsum_tpu.models.simnet import init_simnet
from vidsum_tpu.ops import attention as jax_attention
from vidsum_tpu.ops import block_kernel as jax_block
from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.models.convert import params_from_jax
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.ops import attention as attn_mod
from vidsum_tpu_torch.ops import block_kernel as bk

D, H = 64, 4


def _block_pair(seed, d=D, heads=H):
    """One block's weights in both packages, from one JAX init."""
    jcfg = JaxModelConfig(in_features=32, d_model=d, num_heads=heads,
                          num_layers=1, dropout=0.0)
    params = init_simnet(jax.random.PRNGKey(seed), jcfg)
    model = SimNet(ModelConfig(in_features=32, d_model=d, num_heads=heads,
                               num_layers=1), device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params["blocks"][0], model.encoder.module_list[0]


def _mask(B, N, seed):
    rng = np.random.default_rng(seed)
    m = np.zeros((B, N), bool)
    for b in range(B):
        m[b, int(rng.integers(N // 2, N)):] = True
    return m


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("B,N", [(2, 128), (1, 512)])
def test_encoder_block_reference_matches_pallas_kernel(dtype, tol, B, N):
    """(2, 128) takes the grouped TPU kernel, (1, 512) the per-element one;
    tolerances are the JAX tests' own (test_block_kernel.py)."""
    jblock, tblock = _block_pair(B * N)
    rng = np.random.default_rng(N)
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    mask = _mask(B, N, N)
    assert jax_block._pick_group(B, N) == bk._pick_group(B, N)
    want = jax_block.fused_encoder_block(
        jblock, jnp.asarray(x, dtype), jnp.asarray(mask), H, D ** -0.5)
    tdt = getattr(torch, dtype)
    got = bk.fused_encoder_block(tblock, torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(mask), H, D ** -0.5)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 5e-2)])
def test_head96_block_reference_matches_pallas_kernel(dtype, tol):
    """head_dim 96 (d_model 192 with 2 heads, the head width of d 384 with
    4 heads and d 768 with 8): the plain block against the grouped Pallas
    kernel in interpret mode at (2, 128), at the JAX tests' bounds."""
    d, heads = 192, 2
    jblock, tblock = _block_pair(96, d, heads)
    rng = np.random.default_rng(96)
    x = rng.normal(size=(2, 128, d)).astype(np.float32)
    mask = _mask(2, 128, 96)
    want = jax_block.fused_encoder_block(
        jblock, jnp.asarray(x, dtype), jnp.asarray(mask), heads, d ** -0.5)
    tdt = getattr(torch, dtype)
    got = bk.fused_encoder_block(tblock, torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(mask), heads, d ** -0.5)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("folded", [False, True])
def test_head96_attention_references_match_pallas_kernels(folded, dtype,
                                                           tol):
    """head_dim 96: each route's plain version against its Pallas kernel in
    interpret mode, f32 and bf16, at (2, 2, 256, 96) with a ragged mask."""
    rng = np.random.default_rng(9)
    B, Hh, N, Dh = 2, 2, 256, 96
    q, k, v = (rng.normal(size=(B, Hh, N, Dh)).astype(np.float32)
               for _ in range(3))
    mask = _mask(B, N, 10)
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(t, dtype) for t in (q, k, v))
    tq, tk, tv = (torch.from_numpy(t).to(tdt) for t in (q, k, v))
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    if folded:
        want = jax_attention._flash_attention_folded(
            jq, jk, jv, jm, Dh ** -0.5, interpret=True, kb=128)
        got = attn_mod._flash_attention_folded(tq, tk, tv, tm, Dh ** -0.5,
                                               128)
    else:
        want = jax_attention._flash_attention(jq, jk, jv, jm, Dh ** -0.5,
                                              interpret=True)
        got = attn_mod._flash_attention(tq, tk, tv, tm, Dh ** -0.5)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _attention_mask(B, N, shape_seed):
    """The first shape's ragged mask, or, at (2, 2, 512, 64), element 0
    valid for 300 keys (its last three 64-key tiles wholly padded, the
    tiles the CUDA kernel skips) and element 1 for 480 (no padded tile)."""
    if N != 512:
        return _mask(B, N, shape_seed)
    m = np.zeros((B, N), bool)
    m[0, 300:] = True
    m[1, 480:] = True
    return m


# (B, H, N, Dh) of the two attention shapes: the first small, the second at
# the flagship's head_dim with wholly padded key tiles in element 0
ATTN_SHAPES = [(2, 2, 256, 16), (2, 2, 512, 64)]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("folded", [False, True])
def test_attention_references_match_pallas_kernels(folded, shape):
    rng = np.random.default_rng(7)
    B, Hh, N, Dh = shape
    q, k, v = (rng.normal(size=(B, Hh, N, Dh)).astype(np.float32)
               for _ in range(3))
    mask = _attention_mask(B, N, 8)
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    if folded:
        want = jax_attention._flash_attention_folded(
            jq, jk, jv, jm, 0.125, interpret=True, kb=128)
        got = attn_mod._flash_attention_folded(tq, tk, tv, tm, 0.125, 128)
    else:
        want = jax_attention._flash_attention(jq, jk, jv, jm, 0.125,
                                              interpret=True)
        got = attn_mod._flash_attention(tq, tk, tv, tm, 0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # the dense plain version and the fold over the CUDA kernel's 64-key
    # tiles (the plain versions the card holds the kernel to) agree with
    # both
    np.testing.assert_allclose(
        attn_mod.attention_reference(tq, tk, tv, tm, 0.125).numpy(),
        np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        attn_mod.attention_folded_reference(tq, tk, tv, tm, 0.125,
                                            attn_mod.KEY_TILE).numpy(),
        np.asarray(want), rtol=1e-5, atol=1e-5)


# rtol of the bf16 check per shape: 0 at the first; at the second one bf16
# step of the output (2**-7): at head_dim 64 and scale 1 the softmax is
# nearly one-hot, the outputs are single keys' v (|o| up to 4), and an f32
# summation order moves their final bf16 rounding by one step (11 and 22 of
# 131,072 elements in the two orders)
BF16_RTOL = {(2, 2, 256, 16): 0.0, (2, 2, 512, 64): 2.0 ** -7}


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("folded", [False, True])
def test_bf16_attention_references_round_p_as_pallas_kernels(folded, shape):
    """In bf16 the plain versions round P where the Pallas kernels do: the
    single pass after normalising, the fold before. At scale 1 each agrees
    with its kernel to 1e-3 (plus one step of the bf16 output at the second
    shape), while the other order is further off."""
    rng = np.random.default_rng(7)
    B, Hh, N, Dh = shape
    q, k, v = (rng.normal(size=(B, Hh, N, Dh)).astype(np.float32)
               for _ in range(3))
    mask = _attention_mask(B, N, 8)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tm = torch.from_numpy(mask)
    normalised = attn_mod.attention_reference(tq, tk, tv, tm, 1.0)
    online = attn_mod.attention_folded_reference(tq, tk, tv, tm, 1.0, 128)
    if folded:
        want = jax_attention._flash_attention_folded(
            jq, jk, jv, jnp.asarray(mask), 1.0, interpret=True, kb=128)
        own, other = online, normalised
    else:
        want = jax_attention._flash_attention(jq, jk, jv, jnp.asarray(mask),
                                              1.0, interpret=True)
        own, other = normalised, online
    want = np.asarray(want, np.float32)
    rtol = BF16_RTOL[shape]
    np.testing.assert_allclose(own.float().numpy(), want, rtol=rtol,
                               atol=1e-3)
    assert np.abs(other.float().numpy() - want).max() > 5e-3
    assert not np.allclose(other.float().numpy(), want, rtol=rtol, atol=1e-3)


def test_mma_cta_rows_follow_the_grid():
    """128-query CTAs where a grid of them fills both CTA slots of every SM
    once, 64 on smaller grids and at head_dim 128, at the shapes the
    serving path gives the bf16 kernel (132 SMs: an H100 SXM)."""
    rows = attn_mod.mma_cta_rows
    assert rows(1, 4, 16384, 64, 132) == 128   # kernel 4: 512 CTAs
    assert rows(32, 4, 512, 64, 132) == 128    # kernels 1, 13: 512
    assert rows(1, 4, 6016, 64, 132) == 64     # kernel 3: 188 < 264
    assert rows(1, 4, 1280, 64, 132) == 64     # a 1,200-frame request: 40
    assert rows(8, 4, 256, 64, 132) == 64      # kernels 2, 14: 64
    assert rows(1, 4, 8448, 64, 132) == 128    # 66 x 4 = 264: fills once
    assert rows(1, 4, 8320, 64, 132) == 64     # 65 x 4 = 260
    assert rows(32, 4, 512, 128, 132) == 64    # head_dim 128: 4 warps
    assert rows(32, 4, 512, 16, 132) == 128


# the serving block's four products at d_model d: (name, N, K)
def _block_products(d):
    return (("qkv", 3 * d, d), ("proj", d, d), ("fc1", 4 * d, d),
            ("fc2", d, 4 * d))


@pytest.mark.parametrize("B,N,d,want", [
    (32, 512, 256, (128, 128, 128, 128)),   # the flagship: 128-384 CTAs
    (32, 512, 64, (128, 128, 128, 128)),
    (8, 256, 256, (64, 64, 64, 64)),        # 16-64 CTAs of 128 rows
    (8, 256, 512, (128, 64, 128, 64)),      # qkv: 96 x 6 fills 2 waves
    (16, 512, 256, (64, 64, 128, 64)),      # proj: 64 CTAs of 128 rows
])
def test_gemm_cta_rows_follow_the_grid(B, N, d, want):
    """The wgmma GEMM's CTA rows at the serving path's products (132 SMs:
    an H100 SXM): 64 where a grid of 64-row CTAs takes fewer waves than
    twice the 128-row grid's."""
    got = tuple(bk.gemm_cta_rows(B * N, n, 132)
                for _, n, _ in _block_products(d))
    assert got == want


def test_gemm_cta_rows_and_tile_n_at_edges():
    assert bk.gemm_cta_rows(2048, 2048, 132) == 128    # probe 18a: 128 CTAs
    assert bk.gemm_cta_rows(132 * 128, 256, 132) == 128    # one full wave
    assert bk.gemm_cta_rows(133 * 128, 256, 132) == 64     # a 1-CTA tail
    assert bk.gemm_cta_rows(66 * 128, 256, 132) == 64      # half a wave
    assert bk.gemm_cta_rows(67 * 128, 256, 132) == 128
    assert [bk.gemm_tile_n(n) for n in (1, 64, 128, 129, 256, 768)] == [
        128, 128, 128, 256, 256, 256]


def test_gemm_takes_wgmma_where_tma_can_load():
    """TMA needs K and both row strides a multiple of 8 bf16 and 16-byte
    aligned bases; everything else takes the mma.sync fallback."""
    bf = torch.bfloat16
    x = torch.zeros(200, 96, dtype=bf)
    w = torch.zeros(64, 96, dtype=bf)
    assert bk.gemm_takes_wgmma(x, w)
    assert not bk.gemm_takes_wgmma(x.float(), w.float())   # f32: FMA kernel
    assert not bk.gemm_takes_wgmma(torch.zeros(200, 100, dtype=bf),
                                   torch.zeros(64, 100, dtype=bf))  # K 100
    assert bk.gemm_takes_wgmma(torch.zeros(200, 104, dtype=bf)[:, :96], w)
    assert not bk.gemm_takes_wgmma(
        torch.zeros(200, 100, dtype=bf)[:, :96], w)         # row stride 100
    assert not bk.gemm_takes_wgmma(x, torch.zeros(64, 100, dtype=bf)[:, :96])
    flat = torch.zeros(200 * 96 + 8, dtype=bf)
    assert bk.gemm_takes_wgmma(flat[8:].view(200, 96), w)
    assert not bk.gemm_takes_wgmma(flat[1:1 + 200 * 96].view(200, 96), w)


def test_gemm_takes_vec4_where_16_byte_loads_can():
    """The f32 FMA GEMM's 16-byte loads need K and both row strides a
    multiple of 4 floats and 16-byte aligned bases; everything else takes
    the same kernel's scalar loads (a counted fallback)."""
    x, w = torch.zeros(200, 96), torch.zeros(64, 96)
    assert bk.gemm_takes_vec4(x, w)
    assert not bk.gemm_takes_vec4(x.bfloat16(), w.bfloat16())  # bf16: wgmma
    assert not bk.gemm_takes_vec4(torch.zeros(200, 98),
                                  torch.zeros(64, 98))         # K 98
    assert bk.gemm_takes_vec4(torch.zeros(200, 100)[:, :96], w)
    assert not bk.gemm_takes_vec4(torch.zeros(200, 98)[:, :96], w)
    assert not bk.gemm_takes_vec4(x, torch.zeros(64, 98)[:, :96])
    flat = torch.zeros(200 * 96 + 4)
    assert bk.gemm_takes_vec4(flat[4:].view(200, 96), w)
    assert not bk.gemm_takes_vec4(flat[1:1 + 200 * 96].view(200, 96), w)
    # 128 x 128 tiles where their grid gives 3/4 of the SMs a CTA, else
    # 64 x 64: (32, 512)'s products, then (8, 256)'s and a 256-frame
    # request's
    assert [bk.gemm_f32_tile(16384, n, 132) for n in (768, 256, 1024)] == [
        128, 128, 128]
    assert [bk.gemm_f32_tile(2048, n, 132) for n in (768, 256, 1024)] == [
        64, 64, 128]
    assert bk.gemm_f32_tile(256, 1, 132) == 64
    assert [bk.gemm_f32_tile(128 * m, 1, 132) for m in (98, 99)] == [64, 128]


def test_attention_layout_ok_routes_the_f32_attention():
    """The f32 serving attention's 16-byte route: q/k/v views of the fused
    (B, N, 3d) QKV buffer and the (B, N, d) output view qualify at every
    head_dim; a row stride off 4 floats or a base off 16 bytes does not
    (masked_attention stages such views into aligned copies, counted)."""
    for d, heads in ((256, 4), (384, 4), (192, 2), (768, 8), (512, 4)):
        Dh = d // heads
        qkv = torch.zeros(2, 100, 3 * d).view(2, 100, 3, heads, Dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = torch.zeros(2, 100, d).view(2, 100, heads, Dh).transpose(1, 2)
        assert attn_mod.attention_layout_ok(q, k, v, out)
    assert not attn_mod.attention_layout_ok(
        torch.zeros(1, 1, 64, 18)[..., :16])                 # row stride 18
    flat = torch.zeros(64 * 16 + 4)
    assert attn_mod.attention_layout_ok(flat[4:].view(1, 1, 64, 16))
    assert not attn_mod.attention_layout_ok(
        flat[1:1 + 64 * 16].view(1, 1, 64, 16))              # base off 16 B
    assert attn_mod.attention_layout_ok(None, flat[:1024].view(1, 64, 16))


def test_routing_arithmetic_matches_jax():
    """Every routing predicate gives the JAX package's answer, so a request
    takes the same route in both packages."""
    for B in (1, 2, 3, 8, 32):
        for N in (128, 256, 384, 512, 640, 1280, 4096, 6016, 8192):
            assert bk._pick_group(B, N) == jax_block._pick_group(B, N)
            for d, itm in ((64, 4), (256, 2), (256, 4), (512, 2)):
                assert (bk.fused_block_supported(B, N, d, itm)
                        == jax_block.fused_block_supported(B, N, d, itm))
                t = bk._pick_tile(N)
                assert t == jax_block._pick_tile(N)
                assert (bk._working_set_bytes(B, N, d, itm, t)
                        == jax_block._working_set_bytes(B, N, d, itm, t))
    for N in list(range(128, 40960, 1152)) + [16384, 131072, 262144]:
        assert attn_mod._pick_key_block(N) == jax_attention._pick_key_block(N)
        for Dh, itm in ((64, 2), (64, 4), (16, 4)):
            assert (attn_mod.flash_forward_supported(N, Dh, itm)
                    == jax_attention.flash_forward_supported(N, Dh, itm))


def test_flash_attention_picks_the_tpu_route(monkeypatch):
    """flash_attention's ladder: single pass while its budget holds, the
    key-folded route past it, and a ValueError past the folded envelope."""
    taken = []
    monkeypatch.setattr(attn_mod, "_flash_attention",
                        lambda *a: taken.append("single"))
    monkeypatch.setattr(attn_mod, "_flash_attention_folded",
                        lambda *a: taken.append(("folded", a[-1])))
    for N in (6016, 12288, 16384):
        q = torch.zeros((1, 1, N, 64), dtype=torch.bfloat16)
        attn_mod.flash_attention(q, q, q, None, 0.1)
    assert taken == ["single", "single", ("folded", 4096)]
    q = torch.zeros((1, 1, 262144, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="envelope"):
        attn_mod.flash_attention(q, q, q, None, 0.1)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers run their plain versions and count no
    kernel launch."""
    _, tblock = _block_pair(0)
    x = torch.randn(2, 128, D)
    counters = (bk.gemm_bias_epilogue, bk._fused_block,
                bk._fused_block_grouped, attn_mod.masked_attention,
                attn_mod._flash_attention, attn_mod._flash_attention_folded)
    before = [c.launches for c in counters]
    got = bk.fused_encoder_block(tblock, x, None, H, D ** -0.5)
    want = bk.encoder_block_reference(bk.block_weights(tblock, x.dtype), x,
                                      None, H, D ** -0.5)
    assert torch.equal(got, want)
    w = torch.randn(96, D)
    b = torch.randn(96)
    y, _ = bk.gemm_bias_epilogue(x.reshape(-1, D), w, b, "relu")
    assert torch.equal(y, torch.relu(x.reshape(-1, D) @ w.t() + b))
    q = torch.randn(1, 2, 128, 16)
    assert torch.equal(attn_mod.masked_attention(q, q, q, None, 0.2),
                       attn_mod.attention_reference(q, q, q, None, 0.2))
    assert torch.equal(
        attn_mod.masked_attention(q, q, q, None, 0.2, norm_first=False),
        attn_mod.attention_folded_reference(q, q, q, None, 0.2,
                                            attn_mod.KEY_TILE))
    assert [c.launches for c in counters] == before


def test_block_weights_repack_after_a_weight_change():
    _, tblock = _block_pair(1)
    w1 = bk.block_weights(tblock, torch.float32)
    assert bk.block_weights(tblock, torch.float32) is w1
    with torch.no_grad():
        tblock.sa.q.weight.add_(1.0)
    w2 = bk.block_weights(tblock, torch.float32)
    assert w2 is not w1
    assert torch.equal(w2.wqkv[:D], tblock.sa.q.weight)


# ---------------------------------------------------------- the shape guards

def _guards():
    """Every CUDA wrapper's shape guard, called on CPU tensors, by the
    shape it reads: the training attention's and the ring's (head_dim), the
    serving attention's head_dim check, the training block's (d_model, and
    head_dim at 4 heads) and the LayerNorm epilogue's row path (both
    GEMMs)."""
    import importlib

    from vidsum_tpu_torch.ops import _cuda
    from vidsum_tpu_torch.ops import attention_train as att
    from vidsum_tpu_torch.ops import block_train as bt

    # the package exports a function of the module's name
    ra = importlib.import_module("vidsum_tpu_torch.parallel.ring_attention")
    mask = torch.zeros(1, 128, dtype=torch.bool)

    def qkv(Dh):
        q = torch.zeros(1, 2, 128, Dh)
        return q, q, q, mask

    return {
        "attention_train": lambda Dh, d: att._cuda_inputs(*qkv(Dh), 0),
        "ring": lambda Dh, d: ra._cuda_inputs(*qkv(Dh), (torch.float32,)),
        "masked_attention": lambda Dh, d: _cuda.kernel_head_dim(Dh,
                                                                "kernels"),
        "block_train": lambda Dh, d: bt._check_cuda_inputs(
            torch.zeros(1, 128, d), (), d // Dh),
        "ln_rows": lambda Dh, d: _cuda.ln_rows_path(d, False),
    }


GUARDS = ("attention_train", "ring", "masked_attention", "block_train",
          "ln_rows")


@pytest.mark.parametrize("guard", GUARDS)
def test_guards_accept_the_repos_shapes(guard):
    """head_dim 16, 32, 64, 96 (d_model 384 with 4 heads, 768 with 8) and
    128 (d_model 512 with 4 heads), d_model up to 768."""
    for Dh in (16, 32, 64, 96, 128):
        _guards()[guard](Dh, 4 * Dh)
    _guards()[guard](96, 768)


@pytest.mark.parametrize("guard", GUARDS)
def test_guards_refuse_other_shapes(guard):
    """No guard refuses a width: head_dim 48 (run zero-padded to
    64), 160, 256 and 320 (run in 128-column slices), d_model 800, 1,056
    (LayerNorm rows past 1,024) and 200 (off the 32-column grid) are all
    taken; only a head_dim below 1 raises, in the head_dim guards. The
    LayerNorm rows read d only, the attention guards head_dim only."""
    fn = _guards()[guard]
    for Dh, d in ((48, 192), (100, 800), (160, 640), (256, 1024),
                  (320, 1280), (132, 1056), (50, 200)):
        fn(Dh, d)
    if guard in ("masked_attention", "attention_train", "ring"):
        with pytest.raises(ValueError, match="head_dim"):
            fn(0, 0)


# ------------------------------------------ head_dims off the kernels' own

def _dyadic(rng, *shape):
    """Multiples of 1/16 in [-1/2, 1/2]: every product and sum of a few
    hundred of them is exact in f32, so Q.K^T, dp and D are the same values
    at any width and in any order."""
    return torch.from_numpy(rng.integers(-8, 9, shape).astype(np.float32)
                            / 16)


@pytest.mark.parametrize("Dh", [48, 80, 160, 320])
def test_head_dim_padding_is_exact(Dh):
    """What the CUDA wrappers do with a head_dim off ``_cuda.HEAD_DIMS``:
    q, k, v (and o, dO) zero-padded to ``_cuda.kernel_head_dim`` (48 -> 64,
    80 -> 96, 160 -> 256 and 320 -> 384, the widths the kernels run in
    128-column slices), the kernel run at that width with the caller's
    scale, the results sliced back. Run here through the kernels' plain
    versions (the serving attention, its fold, the training attention's
    forward and backward with dropout): padded and unpadded give the same
    bits in output, lse and grads, and the padded columns of o, dq, dk and
    dv are zero."""
    from vidsum_tpu_torch.ops import _cuda
    from vidsum_tpu_torch.ops import attention_train as att

    Dp = _cuda.kernel_head_dim(Dh, "kernels")
    assert Dp == {48: 64, 80: 96, 160: 256, 320: 384}[Dh]
    rng = np.random.default_rng(Dh)
    B, Hh, N = 2, 2, 256
    q, k, v, do = (_dyadic(rng, B, Hh, N, Dh) for _ in range(4))
    mask = torch.zeros(B, N, dtype=torch.bool)
    mask[1, 200:] = True
    scale = Dh ** -0.5  # the caller's, never recomputed from Dp

    def pad(t):
        return _cuda.pad_head_dim(t, Dp)

    for fn in (lambda *a: attn_mod.attention_reference(*a, mask, scale),
               lambda *a: attn_mod.attention_folded_reference(
                   *a, mask, scale, attn_mod.KEY_TILE)):
        got = fn(pad(q), pad(k), pad(v))
        assert torch.equal(got[..., :Dh], fn(q, k, v))
        assert not got[..., Dh:].any()
    o, lse = att.attention_train_fwd_reference(q, k, v, mask, 7, 0.3, scale)
    po, plse = att.attention_train_fwd_reference(pad(q), pad(k), pad(v),
                                                 mask, 7, 0.3, scale)
    assert torch.equal(po[..., :Dh], o) and torch.equal(plse, lse)
    assert not po[..., Dh:].any()
    grads = att.attention_train_bwd_reference(q, k, v, mask, 7, lse, do, 0.3,
                                              scale)
    pgrads = att.attention_train_bwd_reference(pad(q), pad(k), pad(v), mask,
                                               7, lse, pad(do), 0.3, scale)
    for a, b in zip(pgrads, grads):
        assert torch.equal(a[..., :Dh], b) and not a[..., Dh:].any()


def test_head_dim_padding_helpers():
    """``kernel_head_dim`` maps each head_dim up to 128 onto the smallest
    kernel width that holds it and a wider one onto the multiple of 128
    that holds it (its ``head_slices``), and refuses only a head_dim below
    1; ``ln_rows_path`` names the LayerNorm row kernel of a width;
    ``pad_head_dim`` is the identity at that width; the training block's
    per-head padding of its fused (rows, heads * Dh) buffers round-trips."""
    from vidsum_tpu_torch.ops import _cuda
    from vidsum_tpu_torch.ops import block_train as bt

    want = {1: 16, 16: 16, 17: 32, 48: 64, 64: 64, 80: 96, 96: 96, 112: 128,
            128: 128, 129: 256, 132: 256, 160: 256, 256: 256, 320: 384,
            512: 512}
    assert {dh: _cuda.kernel_head_dim(dh, "x") for dh in want} == want
    assert {dh: _cuda.head_slices(dh) for dh in (50, 128, 160, 320, 512)} \
        == {50: 1, 128: 1, 160: 2, 320: 3, 512: 4}
    for dh in (0, -1):
        with pytest.raises(ValueError, match="head_dim"):
            _cuda.kernel_head_dim(dh, "x")
    assert [_cuda.ln_rows_path(n, f32) for n, f32 in (
        (200, False), (256, False), (384, False), (1024, False), (1056, False),
        (200, True), (2048, True))] == ["tile", "tile", "rows", "rows",
                                        "wide", "rows", "wide"]
    t = torch.randn(3, 2, 5, 64)
    assert _cuda.pad_head_dim(t, 64) is t
    qkv = torch.randn(10, 3 * 4 * 48)
    padded = bt._pad_heads(qkv, 12, 48, 64)
    assert padded.shape == (10, 12 * 64)
    assert torch.equal(padded.view(10, 12, 64)[..., :48],
                       qkv.view(10, 12, 48))
    assert not padded.view(10, 12, 64)[..., 48:].any()
    assert torch.equal(bt._unpad_heads(padded, 12, 48, 64), qkv)

"""The port's flash-attention training route
(``vidsum_tpu_torch/ops/attention_train.py``) against the JAX package's on
the CPU: the dropout hash bit for bit, the four plain versions (o, lse, dq,
dk, dv) against the Pallas kernels in interpret mode on the single-pass and
the forced key-folded route (as ``tests/test_attention_train.py`` forces
it), at head_dims 32 and 128 on both routes, on the folded route with an
element whose keys are all padded, in f32 with whole key tiles padded in
the middle and at the end of rows (the tiles the f32 kernels skip), the
autograd Function against ``jax.vjp`` (the forward's o reaching the
backward on both routes), and the routing predicates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vidsum_tpu.ops.attention_train as jat
from vidsum_tpu_torch.ops import attention_train as at

SEED = 9
# the JAX tests' own bounds (tests/test_attention_train.py): forward f32
# 2e-5; grads rtol 1e-3 / atol 1e-4 on the single-pass route, 2e-4 / 2e-4
# on the folded one (measured: under 1e-6). bf16 (measured): o and the
# grads differ from the interpret-mode kernels by at most one bf16 step
# where a value rounds the other way (their f32 sums run in another order),
# up to 2.0e-3 absolute on values of size 1-2, so one step (rtol 2**-7)
# plus atol 4e-3; lse is f32 in both dtypes
TOL = {
    ("fwd", "float32"): (2e-5, 2e-5),
    ("lse", "float32"): (2e-5, 2e-5),
    ("grad", "float32", False): (1e-3, 1e-4),
    ("grad", "float32", True): (2e-4, 2e-4),
    ("fwd", "bfloat16"): (8e-3, 4e-3),
    ("lse", "bfloat16"): (2e-5, 2e-5),
    ("grad", "bfloat16", False): (8e-3, 4e-3),
    ("grad", "bfloat16", True): (8e-3, 4e-3),
}
# (B, H, N, Dh): single pass at (2, 2, 256, 16); folded, forced with
# kb = 128, at (2, 2, 512, 64); valid lengths (200, 100) of 256 and
# (400, 200) of 512
SHAPES = {False: (2, 2, 256, 16), True: (2, 2, 512, 64)}
CASES = [(False, 0.3, "float32"), (False, 0.0, "float32"),
         (False, 0.3, "bfloat16"), (True, 0.3, "float32"),
         (True, 0.0, "float32"), (True, 0.3, "bfloat16"),
         (True, 0.0, "bfloat16")]
# the other head_dims the kernels take (d 512 with 4 heads: 128; d 640
# with 4: 160, which the kernels run in two 128-column slices), valid
# length 200 of 256 (on the folded route two 128-key blocks)
HEAD_DIM_SHAPES = [(1, 2, 256, 128), (1, 2, 256, 32), (1, 2, 256, 160)]


def _inputs(folded: bool, shape=None, dead=False, holes=False):
    """Seeded q, k, v, the cotangent and the (B, N) pad mask (element b
    valid up to N * 25 / (32 * 2**b)); ``dead`` pads every key of the
    elements past the first; ``holes`` (B = 2, N = 256) pads whole 64-key
    tiles in the middle of element 0's row (keys 64-191, and 200-255) and
    at the end of element 1's (128-255), whose first tile keeps exactly one
    unpadded key (key 5)."""
    B, H, N, Dh = shape or SHAPES[folded]
    rng = np.random.default_rng(N + Dh)
    q, k, v, co = (rng.normal(size=(B, H, N, Dh)).astype(np.float32)
                   for _ in range(4))
    mask = np.zeros((B, N), bool)
    for b in range(B):
        mask[b, N * 25 // (32 << b):] = True
    if dead:
        mask[1:] = True
    if holes:
        assert (B, N) == (2, 256)
        mask[:] = False
        mask[0, 64:192] = mask[0, 200:] = True
        mask[1, :64] = mask[1, 128:] = True
        mask[1, 5] = False
    return q, k, v, co, mask, Dh ** -0.5


@pytest.fixture(scope="module")
def jax_results():
    """Per case: the Pallas forward (o, lse) and ``jax.vjp``'s dq, dk, dv,
    interpret mode. The folded route is forced as the JAX tests force it,
    with the jit caches cleared before and after."""
    cache = {}

    def get(folded, rate, dtype, shape=None, dead=False, holes=False):
        key = (folded, rate, dtype, shape, dead, holes)
        if key in cache:
            return cache[key]
        q, k, v, co, mask, scale = _inputs(folded, shape, dead, holes)
        jq, jk, jv, jco = (jnp.asarray(a).astype(dtype)
                           for a in (q, k, v, co))
        m8 = jnp.asarray(mask.astype(np.int8))[:, None, :]
        seed = jnp.asarray([[SEED]], jnp.int32)
        saved = jat._single_pass_ok, jat._pick_key_block
        jax.clear_caches()
        try:
            if folded:
                jat._single_pass_ok = lambda *a: False
                jat._pick_key_block = lambda n: 128

            # one jitted program: run eagerly, JAX dispatches further ops
            # while the interpret mode's callbacks dispatch their own, and
            # under load the two can block each other
            @jax.jit
            def run(a, b, c, g):
                o, lse = jat._fwd_impl(a, b, c, m8, seed, rate, scale)
                _, vjp = jax.vjp(lambda *t: jat.flash_attention_dropout(
                    *t, m8, seed, rate, scale), a, b, c)
                return o, lse, vjp(g)

            o, lse, grads = jax.block_until_ready(run(jq, jk, jv, jco))
        finally:
            jat._single_pass_ok, jat._pick_key_block = saved
            jax.clear_caches()
        cache[key] = dict(
            o=np.asarray(o, np.float32), lse=np.asarray(lse)[:, :, 0],
            grads=[np.asarray(g, np.float32) for g in grads])
        return cache[key]

    return get


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("rate", [0.3, 0.0, 1.0 - 2.0 ** -20])
def test_keep_mask_block_equals_jax_bit_for_bit(rate):
    """A different hash family from the block's ``_hash_keep``: equal to
    JAX's for several seeds, (b, h) and tile corners; a (T, kb) block is the
    slice of the full-width mask at its corner."""
    for seed in (0, SEED, 2 ** 31 - 2):
        js = jnp.asarray(seed, jnp.int32)
        for b, h in ((0, 0), (1, 3), (5, 2)):
            for row0, col0 in ((0, 0), (384, 0), (128, 256)):
                want = np.asarray(jat._keep_mask_block(js, b, h, row0, col0,
                                                       (128, 96), rate))
                got = at._keep_mask_block(seed, b, h, row0, col0, (128, 96),
                                          rate)
                np.testing.assert_array_equal(got.numpy(), want)
    full = at._keep_mask(77, 3, 2, 5, (at.TILE, 512), 0.3)
    np.testing.assert_array_equal(
        full.numpy(), np.asarray(jat._keep_mask(jnp.asarray(77, jnp.int32),
                                                3, 2, 5, (at.TILE, 512),
                                                0.3)))
    for j, kb in ((0, 128), (3, 128), (1, 256)):
        blk = at._keep_mask_block(77, 3, 2, 5 * at.TILE, j * kb,
                                  (at.TILE, kb), 0.3)
        assert torch.equal(blk, full[:, j * kb:(j + 1) * kb])


def test_reference_keep_mask_matches_jax():
    want = np.asarray(jat.reference_keep_mask(SEED, 2, 2, 256, 0.3))
    np.testing.assert_array_equal(
        at.reference_keep_mask(SEED, 2, 2, 256, 0.3).numpy(), want)


@pytest.mark.parametrize("folded,rate,dtype", CASES)
def test_plain_versions_match_jax_kernels(jax_results, folded, rate, dtype):
    """Each route's plain forward (o, lse) and backward (dq, dk, dv) against
    the Pallas kernels in interpret mode, padded tails included."""
    want = jax_results(folded, rate, dtype)
    q, k, v, co, mask, scale = _inputs(folded)
    tq, tk, tv, tco = (_torch(a, dtype) for a in (q, k, v, co))
    tm = torch.from_numpy(mask)
    if folded:
        o, lse = at._fwd_kernel_folded(tq, tk, tv, tm, SEED, rate, scale,
                                       128)
        grads = at._bwd_kernel_folded(tq, tk, tv, tm, SEED, lse, tco, o,
                                      rate, scale, 128)
    else:
        o, lse = at._fwd_kernel(tq, tk, tv, tm, SEED, rate, scale)
        grads = at._bwd_kernel(tq, tk, tv, tm, SEED, lse, tco, rate, scale)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    rtol, atol = TOL[("fwd", dtype)]
    np.testing.assert_allclose(o.float().numpy(), want["o"], rtol=rtol,
                               atol=atol)
    rtol, atol = TOL[("lse", dtype)]
    np.testing.assert_allclose(lse.numpy(), want["lse"], rtol=rtol,
                               atol=atol)
    rtol, atol = TOL[("grad", dtype, folded)]
    for name, g, w in zip("qkv", grads, want["grads"]):
        assert g.dtype == tq.dtype
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=atol, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", HEAD_DIM_SHAPES)
def test_plain_versions_match_jax_kernels_at_head_dims(jax_results, shape,
                                                       dtype):
    """head_dim 128 (d 512, 4 heads), 32 and 160 on the single-pass route at
    rate 0.3: the plain forward and backward against the Pallas kernels in
    interpret mode, at the bounds of the head_dim 16 cases."""
    want = jax_results(False, 0.3, dtype, shape)
    q, k, v, co, mask, scale = _inputs(False, shape)
    tq, tk, tv, tco = (_torch(a, dtype) for a in (q, k, v, co))
    tm = torch.from_numpy(mask)
    o, lse = at._fwd_kernel(tq, tk, tv, tm, SEED, 0.3, scale)
    grads = at._bwd_kernel(tq, tk, tv, tm, SEED, lse, tco, 0.3, scale)
    rtol, atol = TOL[("fwd", dtype)]
    np.testing.assert_allclose(o.float().numpy(), want["o"], rtol=rtol,
                               atol=atol)
    rtol, atol = TOL[("lse", dtype)]
    np.testing.assert_allclose(lse.numpy(), want["lse"], rtol=rtol,
                               atol=atol)
    rtol, atol = TOL[("grad", dtype, False)]
    for name, g, w in zip("qkv", grads, want["grads"]):
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=atol, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", HEAD_DIM_SHAPES)
def test_folded_plain_versions_match_jax_kernels_at_head_dims(
        jax_results, shape, dtype):
    """head_dim 128, 32 and 160 on the forced key-folded route (kb = 128)
    at rate 0.3: the plain folded forward and backward against the Pallas
    kernels in interpret mode, at the folded bounds of the head_dim 64
    cases."""
    want = jax_results(True, 0.3, dtype, shape)
    q, k, v, co, mask, scale = _inputs(True, shape)
    tq, tk, tv, tco = (_torch(a, dtype) for a in (q, k, v, co))
    tm = torch.from_numpy(mask)
    o, lse = at._fwd_kernel_folded(tq, tk, tv, tm, SEED, 0.3, scale, 128)
    grads = at._bwd_kernel_folded(tq, tk, tv, tm, SEED, lse, tco, o, 0.3,
                                  scale, 128)
    rtol, atol = TOL[("fwd", dtype)]
    np.testing.assert_allclose(o.float().numpy(), want["o"], rtol=rtol,
                               atol=atol)
    rtol, atol = TOL[("lse", dtype)]
    np.testing.assert_allclose(lse.numpy(), want["lse"], rtol=rtol,
                               atol=atol)
    rtol, atol = TOL[("grad", dtype, True)]
    for name, g, w in zip("qkv", grads, want["grads"]):
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=atol, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_element_with_no_unpadded_key(jax_results, dtype):
    """On the forced key-folded route an element whose keys are all padded
    gets o = 0, lse = -inf and zero dq, dk, dv from the Pallas kernels in
    interpret mode and from the plain versions alike (the ``_DEAD`` guards
    and the lse guard; the single pass gives NaN there); the other element
    agrees at the folded bounds."""
    want = jax_results(True, 0.3, dtype, dead=True)
    q, k, v, co, mask, scale = _inputs(True, dead=True)
    assert mask[1].all() and not mask[0].all()
    tq, tk, tv, tco = (_torch(a, dtype) for a in (q, k, v, co))
    tm = torch.from_numpy(mask)
    o, lse = at._fwd_kernel_folded(tq, tk, tv, tm, SEED, 0.3, scale, 128)
    grads = at._bwd_kernel_folded(tq, tk, tv, tm, SEED, lse, tco, o, 0.3,
                                  scale, 128)
    for got in (o.float().numpy(), want["o"]):
        np.testing.assert_array_equal(got[1], 0.0)
    for got in (lse.numpy(), want["lse"]):
        assert np.isneginf(got[1]).all()
    for g, w in zip(grads, want["grads"]):
        np.testing.assert_array_equal(g[1].float().numpy(), 0.0)
        np.testing.assert_array_equal(w[1], 0.0)
    rtol, atol = TOL[("fwd", dtype)]
    np.testing.assert_allclose(o[0].float().numpy(), want["o"][0],
                               rtol=rtol, atol=atol)
    rtol, atol = TOL[("lse", dtype)]
    np.testing.assert_allclose(lse[0].numpy(), want["lse"][0], rtol=rtol,
                               atol=atol)
    rtol, atol = TOL[("grad", dtype, True)]
    for name, g, w in zip("qkv", grads, want["grads"]):
        np.testing.assert_allclose(g[0].float().numpy(), w[0], rtol=rtol,
                                   atol=atol, err_msg=f"d{name}")


@pytest.mark.parametrize("folded", [False, True])
def test_f32_plain_versions_match_jax_kernels_with_padded_key_tiles(
        jax_results, folded):
    """Whole 64-key tiles padded in the middle of one element's row and at
    the end of the other's, beside a tile with exactly one unpadded key
    (the tiles the f32 kernels skip or keep): the f32 plain versions the
    card holds the kernels to (the fold over the kernels' 64-key tiles)
    against the Pallas kernels in interpret mode (the fold forced with
    kb = 128), at head_dim 32, rate 0.3."""
    shape = (2, 2, 256, 32)
    want = jax_results(folded, 0.3, "float32", shape, holes=True)
    q, k, v, co, mask, scale = _inputs(folded, shape, holes=True)
    assert mask[0, 64:192].all() and mask[1, 128:].all()
    assert (~mask[1, :64]).sum() == 1
    tq, tk, tv, tco = (torch.from_numpy(a) for a in (q, k, v, co))
    tm = torch.from_numpy(mask)
    if folded:
        kb = at.KEY_TILE
        o, lse = at.attention_train_fwd_folded_reference(
            tq, tk, tv, tm, SEED, 0.3, scale, kb, rows=64)
        grads = at.attention_train_bwd_folded_reference(
            tq, tk, tv, tm, SEED, lse, tco, o, 0.3, scale, kb, rows=64)
    else:
        o, lse = at.attention_train_fwd_reference(tq, tk, tv, tm, SEED, 0.3,
                                                   scale, rows=64)
        grads = at.attention_train_bwd_reference(tq, tk, tv, tm, SEED, lse,
                                                 tco, 0.3, scale, rows=64)
    rtol, atol = TOL[("fwd", "float32")]
    np.testing.assert_allclose(o.numpy(), want["o"], rtol=rtol, atol=atol)
    rtol, atol = TOL[("lse", "float32")]
    np.testing.assert_allclose(lse.numpy(), want["lse"], rtol=rtol,
                               atol=atol)
    rtol, atol = TOL[("grad", "float32", folded)]
    for name, g, w in zip("qkv", grads, want["grads"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=atol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("folded", [False, True])
def test_autograd_function_matches_jax_vjp(jax_results, monkeypatch, folded):
    """``flash_attention_dropout`` routes by the copied predicates and its
    grads equal ``jax.vjp`` of the Pallas kernels; the folded route is
    forced in the port as in JAX."""
    want = jax_results(folded, 0.3, "float32")
    if folded:
        monkeypatch.setattr(at, "_single_pass_ok", lambda *a: False)
        monkeypatch.setattr(at, "_pick_key_block", lambda n: 128)
    q, k, v, co, mask, scale = _inputs(folded)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    spy = at._fwd_kernel_folded if folded else at._fwd_kernel
    bwd = at._bwd_kernel_folded if folded else at._bwd_kernel
    calls, got_o = [], []
    monkeypatch.setattr(at, spy.__name__,
                        lambda *a: calls.append(1) or spy(*a))

    def bwd_spy(*a, **kw):
        # the forward's o reaches the backward on both routes (in f32 the
        # single pass's kernels take D = rowsum(do * o) from it)
        got_o.append(a[7] if folded else kw.get("o"))
        return bwd(*a, **kw)

    monkeypatch.setattr(at, bwd.__name__, bwd_spy)
    o = at.flash_attention_dropout(tq, tk, tv, torch.from_numpy(mask), SEED,
                                   0.3, scale)
    assert calls == [1]
    o.backward(torch.from_numpy(co))
    assert len(got_o) == 1 and torch.equal(got_o[0], o.detach())
    np.testing.assert_allclose(o.detach().numpy(), want["o"], rtol=2e-5,
                               atol=2e-5)
    rtol, atol = TOL[("grad", "float32", folded)]
    for name, t, w in zip("qkv", (tq, tk, tv), want["grads"]):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=rtol, atol=atol,
                                   err_msg=f"d{name}")


def test_plain_versions_match_the_masked_dense_reference():
    """At rate 0.3 the single-pass plain version equals dense attention
    applying ``reference_keep_mask``; the folded one too, up to rounding."""
    q, k, v, _, mask, scale = _inputs(False)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tm = torch.from_numpy(mask)
    keep = at.reference_keep_mask(SEED, *q.shape[:3], 0.3)
    want = at.dropout_attention_reference(tq, tk, tv, tm, keep, 0.3, scale)
    got, _ = at._fwd_kernel(tq, tk, tv, tm, SEED, 0.3, scale)
    folded, _ = at._fwd_kernel_folded(tq, tk, tv, tm, SEED, 0.3, scale, 128)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(folded, want, rtol=2e-5, atol=2e-5)
    other, _ = at._fwd_kernel(tq, tk, tv, tm, SEED + 1, 0.3, scale)
    assert float((other - want).abs().max()) > 0.1


def test_routing_predicates_match_jax():
    for N in (128, 1152, 7552, 7680, 8064, 8192, 9088, 10880, 11008, 11520,
              11648, 16384, 20480, 22528, 36864, 200):
        for Dh in (16, 64):
            for itemsize in (2, 4):
                args = (N, Dh, itemsize)
                assert at._single_pass_ok(*args) == jat._single_pass_ok(*args)
                assert (at._folded_train_ok(*args)
                        == jat._folded_train_ok(*args))
                assert (at.flash_train_supported(*args)
                        == jat.flash_train_supported(*args)), args
    # the edges of the flagship's routes (head_dim 64)
    assert at._single_pass_ok(7552, 64, 4) and not at._single_pass_ok(
        7680, 64, 4)
    assert at._single_pass_ok(10880, 64, 2) and not at._single_pass_ok(
        11008, 64, 2)
    assert at.flash_train_supported(11520, 64, 4)
    assert not at.flash_train_supported(11648, 64, 4)
    assert at.flash_train_supported(20480, 64, 2)
    assert not at.flash_train_supported(22528, 64, 2)


def test_past_the_envelope_raises():
    q = torch.zeros(1, 1, 11648, 64)
    with pytest.raises(ValueError, match="sequence-parallel ring"):
        at.flash_attention_dropout(q, q, q, None, 0, 0.3, 0.125)
    q = torch.zeros(1, 1, 200, 64)
    with pytest.raises(ValueError, match="multiple of 128"):
        at.flash_attention_dropout(q, q, q, None, 0, 0.3, 0.125)
    q = torch.zeros(1, 1, 128, 64)
    with pytest.raises(ValueError, match="rate"):
        at.flash_attention_dropout(q, q, q, None, 0, 1.0, 0.125)

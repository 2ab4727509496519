"""The port's ring attention (``vidsum_tpu_torch/parallel/ring_attention.py``
and ``parallel/mesh.py``) on the CPU against the JAX package's: the dropout
bits bit for bit, each plain step against its Pallas kernel in interpret
mode (TPU kernels 15-17), the whole rings (forward, and training at rates 0
and 0.3) against the JAX rings under ``shard_map`` on the forced CPU
devices, and the routing arithmetic. Meshes repeat the ``"cpu"`` device, as
one card holds P shards on the GPU. Tolerances are the JAX tests' own
(tests/test_ring_attention.py, tests/test_seq_train.py)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from vidsum_tpu.ops.block_train import S_MLP, S_RES1, S_RES2
from vidsum_tpu_torch.ops.attention import attention_reference
from vidsum_tpu_torch.parallel import mesh as pm

# the packages re-export the function ring_attention under the module's name
ra = importlib.import_module("vidsum_tpu_torch.parallel.ring_attention")
jra = importlib.import_module("vidsum_tpu.parallel.ring_attention")

B, H, N, DH = 2, 2, 512, 32
NL = N // 4


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _inputs(seed, pad_from=400, n=N, full_pad_row=None):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.normal(size=(B, H, n, DH)).astype(np.float32)
                  for _ in range(4))
    mask = np.zeros((B, n), bool)
    mask[:, pad_from:] = True
    if full_pad_row is not None:
        mask[full_pad_row] = True
    return q, k, v, w, mask


def _jmesh(data, seq):
    return Mesh(np.asarray(jax.devices()[:data * seq]).reshape(data, seq),
                ("data", "seq"))


# ------------------------------------------------------------ dropout bits

@pytest.mark.parametrize("seed,b0,q0,k0,rate", [
    (1234, 3, 5, 7, 0.3), (0, 0, 0, 0, 0.5), (2**31 - 2, 6, 384, 128, 0.3),
    (77, 1, 2**20, 2**21 + 64, 0.1)])
def test_ring_hash_keep_bit_equal(seed, b0, q0, k0, rate):
    shape = (3, 4, 16, 24)
    got = ra.ring_hash_keep(seed, b0, q0, k0, shape, rate).numpy()
    want = np.asarray(jra.ring_hash_keep(jnp.int32(seed), b0, q0, k0, shape,
                                         rate))
    np.testing.assert_array_equal(got, want)
    # the planted fault of the card checks: k0 of the neighbouring shard
    shifted = ra.ring_hash_keep(seed, b0, q0, k0 + 128, shape, rate).numpy()
    # independent bits differ with probability 2 rate (1 - rate)
    assert (shifted != want).mean() > rate * (1 - rate)


def test_ring_hash_keep_golden():
    """The JAX package's own golden bits (tests/test_seq_train.py)."""
    k1 = ra.ring_hash_keep(1234, 3, 5, 7, (2, 2, 4, 4), 0.3).numpy()
    assert np.packbits(k1.reshape(-1)).tolist() == [
        133, 241, 218, 246, 251, 242, 176, 111]
    k2 = ra.hash_keep3d(99, 33, 1, 2, (2, 3, 4), 0.5).numpy()
    assert np.packbits(k2.reshape(-1)).tolist() == [144, 240, 38]


@pytest.mark.parametrize("b_global,h,q_start,k0", [
    (0, 0, 0, 0), (5, 3, 256, 384), (1, 31, 2**16, 7)])
def test_ring_keep_tile_bit_equal(b_global, h, q_start, k0):
    got = ra._ring_keep_tile(4242, b_global, h, q_start, k0, (128, 64),
                             0.3).numpy()
    want = np.asarray(jra._ring_keep_tile(
        jnp.int32(4242), jnp.int32(b_global), jnp.int32(h),
        jnp.int32(q_start), jnp.int32(k0), (128, 64), 0.3))
    np.testing.assert_array_equal(got, want)
    # a tile is the ring mask's (b, h) slice at its offsets
    full = ra.ring_hash_keep(4242, b_global, q_start, k0, (1, h + 1, 128, 64),
                             0.3).numpy()
    np.testing.assert_array_equal(got, full[0, h])


@pytest.mark.parametrize("site", [S_RES1, S_MLP, S_RES2])
def test_hash_keep3d_bit_equal(site):
    got = ra.hash_keep3d(9876, site, 2, 384, (3, 128, 40), 0.3).numpy()
    want = np.asarray(jra.hash_keep3d(jnp.int32(9876), site, 2, 384,
                                      (3, 128, 40), 0.3))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------- plain steps vs Pallas kernels

def _carry(seed, fresh):
    """A carry before a step: fresh (o 0, m -inf, l 0) or one a previous
    fold left."""
    if fresh:
        return (np.zeros((B, H, NL, DH), np.float32),
                np.full((B, H, NL, 1), -np.inf, np.float32),
                np.zeros((B, H, NL, 1), np.float32))
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, NL, DH)).astype(np.float32) * 5,
            rng.normal(size=(B, H, NL, 1)).astype(np.float32),
            rng.uniform(1, 50, size=(B, H, NL, 1)).astype(np.float32))


@pytest.mark.parametrize("fresh,block", [(True, 0), (False, 3), (False, 1)])
def test_block_step_matches_pallas(fresh, block):
    """Kernel 15's plain version against the Pallas kernel in interpret
    mode; block 3 is partly padded (keys 400-511)."""
    q, k, v, _, mask = _inputs(1)
    q32 = q[:, :, :NL] * 0.125
    sl = slice(block * NL, (block + 1) * NL)
    args = (q32, k[:, :, sl], v[:, :, sl], mask[:, sl], *_carry(2, fresh))
    got = ra._ring_block_step(*map(torch.from_numpy, args))
    want = jra._ring_block_step(*map(jnp.asarray, args), interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


def test_block_step_padded_block_leaves_carry():
    """A K/V block whose keys are all padded leaves a carry unchanged, and
    a row that has seen no key keeps m = -inf, l = 0."""
    q, k, v, _, _ = _inputs(3)
    q32 = torch.from_numpy(q[:, :, :NL] * 0.125)
    padded = torch.ones((B, NL), dtype=torch.bool)
    carry = tuple(map(torch.from_numpy, _carry(4, False)))
    out = ra._ring_block_step(q32, torch.from_numpy(k[:, :, :NL]),
                              torch.from_numpy(v[:, :, :NL]), padded, *carry)
    for g, w in zip(out, carry):
        assert torch.equal(g, w)
    fresh = tuple(map(torch.from_numpy, _carry(0, True)))
    o, m, l = ra._ring_block_step(q32, torch.from_numpy(k[:, :, :NL]),
                                  torch.from_numpy(v[:, :, :NL]), padded,
                                  *fresh)
    assert torch.isneginf(m).all() and (l == 0).all() and (o == 0).all()


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("fresh", [False, True])
def test_train_step_padded_block_leaves_carry(rate, fresh):
    """Kernel 16's plain step and its Pallas kernel on a block whose keys
    are all padded leave the carry as it was, bit for bit (a fresh one
    keeps m = -inf, l = 0, o = 0): the contract the CUDA kernels meet by
    walking no key tile."""
    q, k, v, _, _ = _inputs(14)
    q32 = q[:, :, :NL] * 0.177
    arrays = (q32, k[:, :, :NL], v[:, :, :NL], np.ones((B, NL), bool))
    info = (1234, 1, 128, 384)
    carry = _carry(15, fresh)
    got = ra._ring_train_step(*map(torch.from_numpy, arrays), info,
                              *map(torch.from_numpy, carry), rate)
    want = jra._ring_train_step(
        *map(jnp.asarray, arrays), jnp.asarray([info], jnp.int32),
        *map(jnp.asarray, carry), rate=rate, interpret=True)
    for g, w, c in zip(got, want, carry):
        assert torch.equal(g, torch.from_numpy(c))
        np.testing.assert_array_equal(np.asarray(w), c)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_train_step_bwd_padded_block_leaves_grads(rate):
    """Kernel 17's plain step and its Pallas kernel on a block whose keys
    are all padded return dq, dk and dv as they came in, bit for bit, rows
    with m = -inf and l = 0 included."""
    q, k, v, g, _ = _inputs(16)
    rng = np.random.default_rng(17)
    q32 = q[:, :, :NL] * 0.177
    _, m, l = _carry(18, False)
    m[:, :, :5] = -np.inf
    l[:, :, :5] = 0.0
    d = rng.normal(size=(B, H, NL, 1)).astype(np.float32)
    acc = tuple(rng.normal(size=(B, H, NL, DH)).astype(np.float32)
                for _ in range(3))
    arrays = (q32, k[:, :, :NL], v[:, :, :NL], g[:, :, :NL], d, m, l,
              np.ones((B, NL), bool))
    info = (5, 2, 384, 256)
    got = ra._ring_train_step_bwd(*map(torch.from_numpy, arrays), info,
                                  *map(torch.from_numpy, acc), rate)
    want = jra._ring_train_step_bwd(
        *map(jnp.asarray, arrays), jnp.asarray([info], jnp.int32),
        *map(jnp.asarray, acc), rate=rate, interpret=True)
    for a, w, c in zip(got, want, acc):
        assert torch.equal(a, torch.from_numpy(c))
        np.testing.assert_array_equal(np.asarray(w), c)


# CTAs of each ring kernel shape an H100 SM holds at head_dim 64 (the
# library's occupancy report, vs_ring_slots: chip_smoke.py's
# ring_cta_variants line)
H100_SLOTS = {"fwd": {(16, 8): 2, (16, 4): 3},
              "dq": {(16, 8): 1, (16, 4): 1},
              "dkdv": {(16, 8): 1, (16, 4): 1}}


@pytest.mark.parametrize("kernel,B,N,shape", [
    ("fwd", 1, 4096, (16, 4)),    # kernel 15 at a 16,384-frame request
    ("fwd", 1, 35072, (16, 4)),   # a 140,000-frame request
    ("fwd", 4, 2048, (16, 8)),    # kernel 16 at chip_smoke.py's shape
    ("fwd", 4, 2304, (16, 4)),    # the seq step over 9,216 frames
    ("fwd", 2, 2048, (16, 4)),
    ("fwd", 1, 8192, (16, 8)),
    ("fwd", 2, 8192, (16, 8)),
    ("dq", 4, 2048, (16, 8)),     # kernel 17 at chip_smoke.py's shape
    ("dkdv", 4, 2048, (16, 8)),
    ("dq", 4, 2304, (16, 4)),
    ("dkdv", 4, 2304, (16, 4)),
    ("dq", 2, 8192, (16, 8))])
def test_ring_cta_shape(kernel, B, N, shape):
    """The CTA shape the ring kernels take on an H100's 132 SMs (4 heads,
    head_dim 64): at the grids chip_smoke.py's ring_cta_variants line
    times, the fastest of the kernel's shapes there (PERF.md, PR 13)."""
    slots = H100_SLOTS[kernel]
    assert ra.ring_cta_shape(kernel, B, 4, N, 64, 132,
                             lambda ty, ri: slots[(ty, ri)]) == shape


def test_ring_shapes():
    assert ra.ring_shapes("fwd", 64) == [(16, 8), (16, 4)]
    assert ra.ring_shapes("dq", 96) == [(16, 4)]
    assert ra.ring_shapes("fwd", 128) == [(16, 4)]
    assert ra.ring_shapes("dkdv", 128) == [(8, 4)]
    # one shape only: no choice to make
    assert ra.ring_cta_shape("dkdv", 4, 4, 2048, 128, 132,
                             lambda ty, ri: 1) == (8, 4)
    # a shape no SM can hold is not taken
    assert ra.ring_cta_shape("fwd", 4, 4, 2048, 64, 132,
                             lambda ty, ri: 0 if ri == 8 else 3) == (16, 4)
    with pytest.raises(ValueError, match="ring kernel"):
        ra.ring_shapes("bwd", 64)


@pytest.mark.parametrize("rate,info", [
    (0.0, (1234, 0, 0, 0)), (0.3, (1234, 0, 128, 384)),
    (0.3, (99, 4, 256, 0))])
def test_train_step_matches_pallas(rate, info):
    q, k, v, _, mask = _inputs(5)
    q32 = q[:, :, :NL] * 0.177
    sl = slice(3 * NL, 4 * NL)
    carry = _carry(6, info[3] == 0)
    got = ra._ring_train_step(
        *map(torch.from_numpy, (q32, k[:, :, sl], v[:, :, sl], mask[:, sl])),
        info, *map(torch.from_numpy, carry), rate)
    want = jra._ring_train_step(
        *map(jnp.asarray, (q32, k[:, :, sl], v[:, :, sl], mask[:, sl])),
        jnp.asarray([info], jnp.int32), *map(jnp.asarray, carry), rate=rate,
        interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("rate,info,dead_rows", [
    (0.0, (77, 0, 0, 128), False), (0.3, (77, 0, 128, 0), False),
    (0.3, (5, 2, 384, 256), True)])
def test_train_step_bwd_matches_pallas(rate, info, dead_rows):
    """Kernel 17's plain version against the Pallas kernel: dq, dk and dv
    accumulated onto nonzero inputs; rows with m = -inf and l = 0 (no key
    seen) contribute nothing."""
    q, k, v, g, mask = _inputs(7)
    rng = np.random.default_rng(8)
    q32 = q[:, :, :NL] * 0.177
    sl = slice(3 * NL, 4 * NL)
    _, m, l = _carry(9, False)
    m = m + 3.0
    l = l * 20.0
    if dead_rows:
        m[:, :, :5] = -np.inf
        l[:, :, :5] = 0.0
    d = rng.normal(size=(B, H, NL, 1)).astype(np.float32)
    dq, dk, dv = (rng.normal(size=(B, H, NL, DH)).astype(np.float32)
                  for _ in range(3))
    arrays = (q32, k[:, :, sl], v[:, :, sl], g[:, :, :NL], d, m, l,
              mask[:, sl])
    got = ra._ring_train_step_bwd(
        *map(torch.from_numpy, arrays), info,
        *map(torch.from_numpy, (dq, dk, dv)), rate)
    want = jra._ring_train_step_bwd(
        *map(jnp.asarray, arrays), jnp.asarray([info], jnp.int32),
        *map(jnp.asarray, (dq, dk, dv)), rate=rate, interpret=True)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=5e-5,
                                   atol=5e-6, err_msg=f"d{name}")


# -------------------------------------------------------------- the rings

@pytest.mark.parametrize("shape,impl,pad_from", [
    ((1, 4), "kernel", 400), ((2, 2), "kernel", 400),
    ((1, 4), "kernel", 384), ((1, 4), "plain", 400),
    ((1, 4), "auto", 300)])
def test_ring_forward_matches_jax(shape, impl, pad_from):
    """``make_ring_forward`` against the JAX one with the Pallas step; at
    pad_from 384 the last shard is entirely padding."""
    q, k, v, _, mask = _inputs(11, pad_from)
    mesh = pm.make_mesh(shape, "cpu")
    got = ra.make_ring_forward(mesh, 0.125, block_impl=impl)(
        *map(torch.from_numpy, (q, k, v, mask)))
    want = jra.make_ring_forward(_jmesh(*shape), 0.125, block_impl="pallas")(
        *map(jnp.asarray, (q, k, v, mask)))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    dense = attention_reference(*map(torch.from_numpy, (q, k, v, mask)),
                                0.125)
    np.testing.assert_allclose(_np(got), _np(dense), rtol=2e-5, atol=2e-5)


def test_ring_forward_fully_padded_row_is_zero():
    q, k, v, _, mask = _inputs(12, full_pad_row=1)
    out = ra.make_ring_forward(pm.make_mesh((1, 4), "cpu"), 0.1,
                               block_impl="kernel")(
        *map(torch.from_numpy, (q, k, v, mask)))
    assert torch.isfinite(out).all() and (out[1] == 0).all()


def _jax_ring_train(impl, q, k, v, mask, seed, rate, scale=0.177):
    """ring_attention_train under shard_map on a 1 x 4 mesh (the JAX
    tests' harness, tests/test_seq_train.py)."""
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("seq",))

    def local(q, k, v, pad):
        return jra.ring_attention_train(q, k, v, pad, scale, "seq",
                                        jnp.int32(seed), rate, b0=0,
                                        block_impl=impl)

    spec = P(None, None, "seq", None)
    return jax.shard_map(local, mesh=mesh,
                         in_specs=(spec, spec, spec, P(None, "seq")),
                         out_specs=spec, check_vma=False)(q, k, v, mask)


def _port_ring_train(impl, q, k, v, mask, seed, rate, w, scale=0.177):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    split = lambda t, d: list(torch.chunk(t, 4, dim=d))  # noqa: E731
    out = torch.cat(ra.ring_attention_train(
        split(qt, 2), split(kt, 2), split(vt, 2),
        split(torch.from_numpy(mask), 1), scale, seed, rate,
        block_impl=impl), dim=2)
    (out * torch.from_numpy(w)).sum().backward()
    return out, qt.grad, kt.grad, vt.grad


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("impl,jax_impl", [("kernel", "pallas"),
                                           ("plain", "xla")])
def test_ring_train_matches_jax(impl, jax_impl, rate):
    """Forward and dq/dk/dv of the training ring against the JAX ring of
    the same route, with one fully padded batch row."""
    q, k, v, w, mask = _inputs(31, pad_from=448, full_pad_row=1)
    got = _port_ring_train(impl, q, k, v, mask, 1234, rate, w)

    @jax.jit
    def fwd_and_grads(q, k, v):
        def loss(q, k, v):
            out = _jax_ring_train(jax_impl, q, k, v, jnp.asarray(mask), 1234,
                                  rate)
            return jnp.sum(out * w), out
        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(q, k, v)
        return (out, *grads)

    want = fwd_and_grads(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=2e-5,
                               atol=2e-6)
    for a, b, name in zip(got[1:], want[1:], "qkv"):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=5e-5,
                                   atol=5e-6, err_msg=f"d{name} rate={rate}")


# ------------------------------------------------------- routing and mesh

def test_routing_predicates_match_jax():
    for Nl in range(128, 8193, 128):
        for dh in (16, 32, 64):
            assert (ra._ring_block_supported(Nl, Nl, dh, 4)
                    == jra._ring_block_supported(Nl, Nl, dh, 4))
            assert (ra._ring_train_supported(Nl, Nl, dh)
                    == jra._ring_train_supported(Nl, Nl, dh))
    assert not ra._ring_block_supported(200, 200, 64, 4)
    # the flagship's envelopes (head_dim 64)
    assert ra._ring_block_supported(6912, 6912, 64, 4)
    assert not ra._ring_block_supported(7040, 7040, 64, 4)
    assert ra._ring_train_supported(2944, 2944, 64)
    assert not ra._ring_train_supported(3072, 3072, 64)


@pytest.mark.parametrize("impl,calls", [("kernel", 16), ("auto", 0),
                                        ("plain", 0)])
def test_block_impl_routing(monkeypatch, impl, calls):
    """On the CPU ``"kernel"`` runs every step through the kernel wrapper
    (P x P calls) and ``"auto"`` the plain step, as JAX's auto takes the XLA
    step off the TPU."""
    seen = []
    real = ra._ring_block_step

    def spy(*args):
        seen.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(ra, "_ring_block_step", spy)
    q, k, v, _, mask = _inputs(13)
    ra.make_ring_forward(pm.make_mesh((1, 4), "cpu"), 0.125,
                         block_impl=impl)(
        *map(torch.from_numpy, (q, k, v, mask)))
    assert len(seen) == calls
    with pytest.raises(ValueError, match="block_impl"):
        ra.make_ring_forward(pm.make_mesh((1, 4), "cpu"), 0.125,
                             block_impl="pallas")(
            *map(torch.from_numpy, (q, k, v, mask)))


@pytest.mark.parametrize("impl,inside,on_cpu,on_cuda", [
    ("auto", True, False, True), ("auto", False, False, True),
    ("kernel", True, True, True), ("kernel", False, False, True),
    ("plain", True, False, False)])
def test_kernel_routing_by_device(impl, inside, on_cpu, on_cuda):
    """The TPU envelope steers only the CPU route: on CUDA tensors the ring
    takes its kernels at every length (they stream K/V tiles; the wrappers
    raise outside their own constraints), and ``"plain"`` stays plain."""
    from types import SimpleNamespace

    def q(dev):
        return SimpleNamespace(device=torch.device(dev))

    assert ra._use_kernel(impl, q("cpu"), inside) == on_cpu
    assert ra._use_kernel(impl, q("cuda"), inside) == on_cuda


def test_mesh_and_rotation(monkeypatch):
    mesh = pm.make_mesh((2, 3), "cpu")
    assert mesh.shape == {"data": 2, "seq": 3} and mesh.size == 6
    assert mesh.devices == [torch.device("cpu")] * 6
    blocks = [torch.full((2,), float(i)) for i in range(4)]
    out = pm.rotate(blocks, [torch.device("cpu")] * 4)
    assert [float(b[0]) for b in out] == [3.0, 0.0, 1.0, 2.0]
    assert out[1] is blocks[0]  # one device: a re-index, not a copy
    grid = pm.place(mesh, torch.arange(24.0).view(2, 12))
    assert [g.tolist() for g in grid[1]] == [[[12.0, 13.0, 14.0, 15.0]],
                                             [[16.0, 17.0, 18.0, 19.0]],
                                             [[20.0, 21.0, 22.0, 23.0]]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pm.make_mesh((1, 4))

# ported from vidsum_tpu/parallel/ring_attention.py
"""Ring attention: exact attention over a sequence split into P shards, with
an online softmax folding one rotating K/V block per step, for inference and
for training with dropout on the attention weights.

The JAX package runs the ring under ``shard_map``: every device keeps its
query block and ``ppermute`` rotates K/V (and the key mask) one shard on per
step. Here the ring runs in one process over the shards of a
:class:`~vidsum_tpu_torch.parallel.mesh.DeviceMesh` row: step t folds, for
every shard s, the block that started on shard (s - t) mod P (global key
offset ``k0 = ((s - t) mod P) * Nl``), then :func:`~vidsum_tpu_torch.parallel.
mesh.rotate` moves the blocks on. A shard's functions take lists of
per-shard tensors, q/k/v (B, H, Nl, Dh) and key masks (B, Nl) bool, True at
padded keys.

Three TPU kernels fold one block into a carry and map onto
``csrc/ring_attention.cu`` (all f32, exact FMA in the FMA attention family's
register tiles, live key tiles only, no atomics):

- ``_ring_block_kernel`` -> :func:`_ring_block_step` (inference; K/V may
  arrive in bf16 and are widened exactly to f32 before the launch, as the
  JAX step upcasts them at its kernel call);
- ``_ring_train_fwd_kernel`` -> :func:`_ring_train_step` (plus dropout on
  the weights of the output accumulation only, bits at global coordinates);
- ``_ring_train_bwd_kernel`` -> :func:`_ring_train_step_bwd` (one step of
  the backward: dv += w~^T g, ds = w (keep inv dp - D), dq += ds k,
  dk += ds^T q, with w = exp(s - m) / l from the saved m and l).

Each wrapper runs its plain PyTorch version on CPU tensors and its kernel on
CUDA tensors (no fallback), and counts its launches in ``launches``. A block
whose keys are all padded leaves the carry (forward) and dq, dk, dv
(backward) unchanged bit for bit, in the kernels as in the plain steps. The
kernels' CTA shape is :func:`ring_cta_shape`'s; it moves no bit.
``block_impl``: ``"plain"`` (JAX ``"xla"``) takes the plain steps, with
autograd in training. On CUDA tensors ``"auto"`` and ``"kernel"`` take the
kernels at every length: they stream K/V in 64-key tiles, so their only
constraint is Nl a multiple of 64 (the sequence-parallel forward and step
pad the global length to make it one); a head_dim off ``_cuda.HEAD_DIMS``
runs zero-padded to the next of them, one past 128 to a multiple of 128
that the kernels run in 128-column slices (``_cuda.kernel_head_dim``). On
CPU tensors ``"kernel"`` (JAX
``"pallas"``) takes the wrappers' plain versions inside the TPU kernels'
VMEM envelope (copied, so that a shape takes the same route as in the JAX
package, which the parity tests hold) and ``"auto"`` the plain steps, as
JAX's ``auto`` takes the XLA step off the TPU. The JAX XLA step guards
with ``isneginf`` where the kernels test ``< _DEAD``: the same arithmetic
for every score that is not -inf, so one plain step serves both.

The dropout bits are ``ops/block_train._hash_keep``'s family (site = head)
at global coordinates (b0 + b, h, q0 + row, k0 + col): a pure function of
the coordinates and the seed, so every shard, mesh shape and tiling draws the
same mask, and the backward regenerates it instead of storing it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from vidsum_tpu_torch.ops import _cuda
from vidsum_tpu_torch.ops.block_train import (
    _keep_bits, _keep_scale, _threshold,
)
from vidsum_tpu_torch.parallel.mesh import DeviceMesh, place, rotate

NEG_INF = float("-inf")
TILE_Q = 128
KEY_TILE = 64  # keys per tile streamed by the CUDA kernels
_DEAD = -1e37  # threshold: anything below is "no unmasked key seen yet"
BLOCK_IMPLS = ("auto", "kernel", "plain")

Info = Tuple[int, int, int, int]  # (seed, b0, q0, k0), the TPU kernels' info


# ------------------------------------------------------------ dropout bits

def _arange(n: int, start: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device) + int(start)


def ring_hash_keep(seed: int, b0: int, q0: int, k0: int, shape,
                   rate: float, device=None, h0: int = 0) -> torch.Tensor:
    """(B, H, Nq, Nk) keep mask over GLOBAL coordinates (batch offset
    ``b0``, query offset ``q0``, key offset ``k0``, head offset ``h0`` for a
    tensor-parallel shard's heads), equal bit for bit to
    ``vidsum_tpu/parallel/ring_attention.py::ring_hash_keep``."""
    B, H, Nq, Nk = shape
    return _keep_bits(seed, _arange(H, h0, device)[None, :, None, None],
                      _arange(B, b0, device)[:, None, None, None],
                      _arange(Nq, q0, device)[None, None, :, None],
                      _arange(Nk, k0, device)[None, None, None, :], rate)


def _ring_keep_tile(seed: int, b_global: int, h: int, q_start: int, k0: int,
                    shape, rate: float, device=None) -> torch.Tensor:
    """The in-kernel mask of a (T, N) score tile at global coordinates,
    equal bit for bit to the JAX ``_ring_keep_tile``."""
    T, N = shape
    return _keep_bits(seed, int(h), int(b_global),
                      _arange(T, q_start, device)[:, None],
                      _arange(N, k0, device)[None, :], rate)


def hash_keep3d(seed: int, site: int, b0: int, row0: int, shape,
                rate: float, device=None, c0: int = 0) -> torch.Tensor:
    """(B, N, C) keep mask of a position-local dropout site (``S_RES1``,
    ``S_MLP``, ``S_RES2``) over global batch, row and column offsets (``c0``
    for a tensor-parallel shard's MLP channels), equal bit for bit to the
    JAX ``hash_keep3d``."""
    B, N, C = shape
    return _keep_bits(seed, int(site), _arange(B, b0, device)[:, None, None],
                      _arange(N, row0, device)[None, :, None],
                      _arange(C, c0, device)[None, None, :], rate)


# ---------------------------------------------------------- plain versions
# Carries are o (B, H, Nq, Dh) f32 (unnormalised), m and l (B, H, Nq, 1) f32;
# q32 is f32 and pre-scaled. The TPU kernels loop over 128-query tiles, whose
# rows are independent, so the plain versions take all rows at once.

def _fold(q32, kb, vb, mb, o, m, l, keep=None, rate: float = 0.0):
    s = torch.matmul(q32, kb.float().transpose(-1, -2))
    s = s.masked_fill(mb[:, None, None, :], NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    dead = m_new < _DEAD
    m_safe = torch.where(dead, 0.0, m_new)
    p = torch.where(dead, 0.0, torch.exp(s - m_safe))
    corr = torch.where(m < _DEAD, 0.0, torch.exp(m - m_safe))
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    if keep is not None:
        p = torch.where(keep, p * _keep_scale(rate), 0.0)
    o_new = o * corr + torch.matmul(p, vb.float())
    return o_new, m_new, l_new


def ring_block_step_reference(q32, kb, vb, mb, o, m, l):
    """TPU kernel 15's fold of one K/V block into (o, m, l)."""
    return _fold(q32, kb, vb, mb, o, m, l)


def ring_train_step_reference(q32, kb, vb, mb, info: Info, o, m, l,
                              rate: float):
    """TPU kernel 16: kernel 15 plus dropout on the weights of the o
    accumulation (the denominator sums the raw weights)."""
    seed, b0, q0, k0 = info
    keep = (ring_hash_keep(seed, b0, q0, k0, q32.shape[:3] + kb.shape[2:3],
                           rate, q32.device) if rate > 0.0 else None)
    return _fold(q32, kb, vb, mb, o, m, l, keep, rate)


def ring_train_step_bwd_reference(q32, kb, vb, g, d, m, l, mb, info: Info,
                                  dq, dk, dv, rate: float):
    """TPU kernel 17: one ring step of the backward from the saved (m, l)
    and D = rowsum(g * out); returns (dq, dk, dv) with this block's terms
    added."""
    seed, b0, q0, k0 = info
    s = torch.matmul(q32, kb.transpose(-1, -2))
    dead = m < _DEAD
    m_safe = torch.where(dead, 0.0, m)
    e = torch.where(mb[:, None, None, :] | dead, 0.0, torch.exp(s - m_safe))
    w = e / torch.where(l == 0.0, 1.0, l)
    if rate > 0.0:
        keep = ring_hash_keep(seed, b0, q0, k0, s.shape, rate, q32.device)
        kp = torch.where(keep, _keep_scale(rate), 0.0)
        wd = w * kp
    else:
        kp, wd = 1.0, w
    dv = dv + torch.matmul(wd.transpose(-1, -2), g)
    dp = torch.matmul(g, vb.transpose(-1, -2))
    ds = w * (kp * dp - d)
    dq = dq + torch.matmul(ds, kb)
    dk = dk + torch.matmul(ds.transpose(-1, -2), q32)
    return dq, dk, dv


# ----------------------------------------------------- the kernel launches

RING_KERNELS = ("fwd", "dq", "dkdv")  # vs_ring_slots's kernel codes


def ring_shapes(kernel: str, Dh: int) -> list:
    """The CTA shapes (depth TY, rows a thread RI) ring kernel ``kernel``
    (``"fwd"``, ``"dq"`` or ``"dkdv"``) is built in at kernel head_dim Dh,
    in order of preference: a CTA holds TY * RI rows (queries; keys in
    dK/dV) in 8 TY threads (twice that in the backward's two groups).
    (16, 8) and (16, 4) at head_dim <= 64; (16, 4) alone past it, but
    (8, 4) for dK/dV at head_dim 128 ((16, 4) would need 240 KB of shared
    memory). Every shape gives the same bits."""
    if kernel not in RING_KERNELS:
        raise ValueError(f"no ring kernel {kernel!r}")
    if Dh <= 64:
        return [(16, 8), (16, 4)]
    return [(8, 4)] if kernel == "dkdv" and Dh >= 128 else [(16, 4)]


def ring_cta_shape(kernel: str, B: int, H: int, N: int, Dh: int, sms: int,
                   slots) -> tuple:
    """The CTA shape (TY, RI) of ring kernel ``kernel`` over N rows
    (queries; keys for dK/dV) of B * H heads at kernel head_dim Dh on a card
    of ``sms`` SMs, where ``slots(TY, RI)`` is how many CTAs of that shape
    an SM holds at once: of :func:`ring_shapes`, the one whose grid ends
    soonest if every SM runs its slots at one rate, ceil(CTAs / (slots *
    sms)) waves of slots * rows rows an SM; ties go to the earlier shape
    (the taller tile: more FMAs a shared-memory read). A shape of no slot
    (its shared memory past the card's) is not taken. On an H100 this picks
    (16, 4), 64-row CTAs three an SM, for kernel 15 at 4,096 rows a head
    and (16, 8) for 16 at (4, 4, 2,048), the faster shape at every grid
    timed (PERF.md, PR 13)."""
    shapes = ring_shapes(kernel, Dh)
    if len(shapes) == 1:
        return shapes[0]
    best = (None, shapes[0])  # no shape fits: its launch reports the error
    for ty, ri in shapes:
        s = slots(ty, ri)
        if s < 1:
            continue
        rows = ty * ri
        ctas = -(-N // rows) * B * H
        cost = -(-ctas // (s * sms)) * s * rows
        if best[0] is None or cost < best[0]:
            best = (cost, (ty, ri))
    return best[1]


_slots_cache: dict = {}


def _card_slots(kernel: str, Dh: int, Nk: int):
    """``slots(TY, RI)`` of ring kernel ``kernel`` on the current card (the
    CUDA occupancy calculator, through the library; cached)."""
    lib = _cuda.load("ring_attention")

    def slots(ty: int, ri: int) -> int:
        key = (kernel, Dh, ty, ri, Nk)
        if key not in _slots_cache:
            out = ctypes.c_int(0)
            err = lib.vs_ring_slots(RING_KERNELS.index(kernel), Dh, ty, ri,
                                    Nk, ctypes.byref(out))
            _cuda.check(lib, err, "ring_attention occupancy")
            _slots_cache[key] = out.value
        return _slots_cache[key]

    return slots


def _shape(kernel: str, B: int, H: int, Nq: int, Nk: int, Dh: int,
           device) -> tuple:
    return ring_cta_shape(kernel, B, H, Nk if kernel == "dkdv" else Nq, Dh,
                          _cuda.sm_count(device), _card_slots(kernel, Dh, Nk))


def _cuda_inputs(q32, kb, vb, mb, kv_dtypes):
    """q, k, v as the kernels take them (contiguous, zero-padded along
    head_dim to ``_cuda.kernel_head_dim``), the key mask as bytes, and B,
    H, Nq, Nk and the padded head_dim."""
    B, H, Nq, Dh = q32.shape
    Nk = kb.shape[2]
    if q32.dtype != torch.float32:
        raise ValueError("the ring kernels take q pre-scaled in float32")
    if kb.shape != (B, H, Nk, Dh) or vb.shape != kb.shape:
        raise ValueError("k and v must be (B, H, Nk, Dh) beside q's "
                         "(B, H, Nq, Dh)")
    if kb.dtype != vb.dtype or kb.dtype not in kv_dtypes:
        raise ValueError(f"k and v must share one of {kv_dtypes}, got "
                         f"{kb.dtype}, {vb.dtype}")
    Dp = _cuda.kernel_head_dim(Dh, "the ring kernels")
    if Nq % KEY_TILE or Nk % KEY_TILE:
        raise ValueError(f"Nq={Nq} and Nk={Nk} must be multiples of "
                         f"{KEY_TILE}")
    mask8 = mb.to(device=q32.device, dtype=torch.uint8).contiguous()
    if mask8.shape != (B, Nk):
        raise ValueError(f"the key mask must be {(B, Nk)}, got "
                         f"{tuple(mask8.shape)}")
    # bf16 K/V widen here: the kernels stream f32 tiles by 16-byte copies
    return (*(_cuda.aligned16(_cuda.pad_head_dim(t.float(), Dp).contiguous())
              for t in (q32, kb, vb)),
            _cuda.aligned16(mask8), B, H, Nq, Nk, Dp)


def _carry(t, shape):
    """A carry as the kernels take it: f32, contiguous, on 16 bytes, its
    last dim zero-padded to ``shape``'s (the padded head_dim; zero columns
    stay zero through every step)."""
    t = t.float()
    if t.shape[:-1] != shape[:-1] or not 0 < t.shape[-1] <= shape[-1]:
        raise ValueError(f"carry of shape {tuple(t.shape)}, expected {shape}")
    return _cuda.aligned16(_cuda.pad_head_dim(t, shape[-1]).contiguous())


def _launch_fwd(q32, kb, vb, mb, o, m, l, info: Optional[Info], rate: float):
    """Kernel 15 (``info`` None) or 16 (dropout from ``info``); returns new
    (o, m, l) tensors (the kernel reads each carry row before it writes its
    own output, and never writes its inputs)."""
    kv = (torch.float32,) if info is not None else (torch.float32,
                                                    torch.bfloat16)
    Dh = q32.shape[-1]
    if o.shape != q32.shape:
        raise ValueError(f"carry of shape {tuple(o.shape)}, expected "
                         f"{tuple(q32.shape)}")
    q32, kb, vb, mask8, B, H, Nq, Nk, Dp = _cuda_inputs(q32, kb, vb, mb, kv)
    o = _carry(o, (B, H, Nq, Dp))
    m, l = (_carry(t, (B, H, Nq, 1)) for t in (m, l))
    o_out, m_out, l_out = (torch.empty_like(t) for t in (o, m, l))
    seed, b0, q0, k0 = info if info is not None else (0, 0, 0, 0)
    lib = _cuda.load("ring_attention")
    with torch.cuda.device(q32.device):  # a shard may sit on another card
        shape = _shape("fwd", B, H, Nq, Nk, Dp, q32.device)
        err = lib.vs_ring_fwd(
            _cuda.ptr(q32), _cuda.ptr(kb), _cuda.ptr(vb), _cuda.ptr(mask8),
            _cuda.ptr(o), _cuda.ptr(m), _cuda.ptr(l), _cuda.ptr(o_out),
            _cuda.ptr(m_out), _cuda.ptr(l_out), B, H, Nq, Nk, Dp, *shape,
            int(seed), int(b0), int(q0), int(k0), _threshold(rate),
            _keep_scale(rate), _cuda.stream_of(q32))
    _cuda.check(lib, err, "ring_attention forward step")
    if Dp != Dh:
        o_out = o_out[..., :Dh].contiguous()
    return o_out, m_out, l_out


def _launch_bwd(q32, kb, vb, g, d, m, l, mb, info: Info, dq, dk, dv,
                rate: float):
    Dh = q32.shape[-1]
    for t, like in ((g, q32), (dq, q32), (dk, kb), (dv, kb)):
        if t.shape != like.shape:
            raise ValueError(f"carry of shape {tuple(t.shape)}, expected "
                             f"{tuple(like.shape)}")
    q32, kb, vb, mask8, B, H, Nq, Nk, Dp = _cuda_inputs(
        q32, kb, vb, mb, (torch.float32,))
    g, dq = (_carry(t, (B, H, Nq, Dp)) for t in (g, dq))
    d, m, l = (_carry(t, (B, H, Nq, 1)) for t in (d, m, l))
    dk, dv = (_carry(t, (B, H, Nk, Dp)) for t in (dk, dv))
    dq_out, dk_out, dv_out = (torch.empty_like(t) for t in (dq, dk, dv))
    seed, b0, q0, k0 = info
    lib = _cuda.load("ring_attention")
    with torch.cuda.device(q32.device):
        sq, sk = (_shape(k, B, H, Nq, Nk, Dp, q32.device)
                  for k in ("dq", "dkdv"))
        err = lib.vs_ring_bwd(
            _cuda.ptr(q32), _cuda.ptr(kb), _cuda.ptr(vb), _cuda.ptr(g),
            _cuda.ptr(d), _cuda.ptr(m), _cuda.ptr(l), _cuda.ptr(mask8),
            _cuda.ptr(dq), _cuda.ptr(dk), _cuda.ptr(dv), _cuda.ptr(dq_out),
            _cuda.ptr(dk_out), _cuda.ptr(dv_out), B, H, Nq, Nk, Dp,
            *sq, *sk, int(seed), int(b0), int(q0), int(k0),
            _threshold(rate), _keep_scale(rate), _cuda.stream_of(q32))
    _cuda.check(lib, err, "ring_attention backward step")
    if Dp == Dh:
        return dq_out, dk_out, dv_out
    return tuple(t[..., :Dh].contiguous() for t in (dq_out, dk_out, dv_out))


# ------------------------------------------------ the three TPU entry points

def _ring_block_step(q32, kb, vb, mb, o, m, l):
    """Counterpart of the JAX ``_ring_block_step`` (TPU kernel 15): q32
    (B, H, Nq, Dh) f32 pre-scaled, kb/vb (B, H, Nk, Dh) f32 or bf16, mb
    (B, Nk) bool; returns the updated (o, m, l)."""
    if q32.device.type == "cpu":
        return ring_block_step_reference(q32, kb, vb, mb, o, m, l)
    out = _launch_fwd(q32, kb, vb, mb, o, m, l, None, 0.0)
    _ring_block_step.launches += 1
    return out


_ring_block_step.launches = 0


def _ring_train_step(q32, kb, vb, mb, info: Info, o, m, l, rate: float):
    """Counterpart of the JAX ``_ring_train_step`` (TPU kernel 16); ``info``
    is (seed, b0, q0, k0), kb/vb f32."""
    if q32.device.type == "cpu":
        return ring_train_step_reference(q32, kb, vb, mb, info, o, m, l, rate)
    out = _launch_fwd(q32, kb, vb, mb, o, m, l, info, rate)
    _ring_train_step.launches += 1
    return out


_ring_train_step.launches = 0


def _ring_train_step_bwd(q32, kb, vb, g, d, m, l, mb, info: Info, dq, dk,
                         dv, rate: float):
    """Counterpart of the JAX ``_ring_train_step_bwd`` (TPU kernel 17):
    returns (dq, dk, dv) with this step's terms added to the inputs."""
    if q32.device.type == "cpu":
        return ring_train_step_bwd_reference(q32, kb, vb, g, d, m, l, mb,
                                             info, dq, dk, dv, rate)
    out = _launch_bwd(q32, kb, vb, g, d, m, l, mb, info, dq, dk, dv, rate)
    _ring_train_step_bwd.launches += 1
    return out


_ring_train_step_bwd.launches = 0


# ------------------------------------------------------ routing arithmetic
# The TPU kernels' VMEM budgets, copied so that a shape takes the same route
# on the CPU as in the JAX package; the CUDA kernels have no such limit.

def _ring_block_supported(Nq: int, Nk: int, Dh: int, itemsize: int) -> bool:
    """VMEM per cell: q/o_in/o_out (Nq, Dh) f32 + k/v (Nk, Dh) + score
    tile."""
    vmem = (3 * Nq * Dh * 4 + 2 * Nk * Dh * itemsize
            + TILE_Q * Nk * 4 + 4 * Nq * 4)
    return (Nq % TILE_Q == 0 and Nk % TILE_Q == 0
            and vmem <= 12 * 1024 * 1024)


def _ring_train_supported(Nq: int, Nk: int, Dh: int) -> bool:
    """Bwd VMEM per cell: q/g/dq_in/dq_out (Nq, Dh) + k/v/dk_in/dk_out/
    dv_in/dv_out (Nk, Dh), all f32, plus two (Tq, Nk) tiles and five (Nq, 1)
    rows."""
    vmem = ((4 * Nq * Dh + 6 * Nk * Dh) * 4
            + 3 * TILE_Q * Nk * 4 + 6 * Nq * 4)
    return (Nq % TILE_Q == 0 and Nk % TILE_Q == 0
            and vmem <= 12 * 1024 * 1024)


def _use_kernel(block_impl: str, q: torch.Tensor,
                tpu_supported: bool) -> bool:
    """Whether the ring takes the kernel wrappers: on CUDA tensors always
    (but for ``"plain"``), on the CPU for ``"kernel"`` inside the TPU
    envelope."""
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"block_impl must be one of {BLOCK_IMPLS}, got "
                         f"{block_impl!r}")
    if block_impl == "plain":
        return False
    if q.device.type == "cuda":
        return True
    return block_impl == "kernel" and tpu_supported


# ---------------------------------------------------------------- the rings

def _normalize(o, l, dtype):
    """o / l with a safe denominator: a row with no unpadded key (l == 0)
    gives 0, and its gradients stay finite."""
    l_safe = torch.where(l == 0.0, 1.0, l)
    return torch.where(l == 0.0, 0.0, o / l_safe).to(dtype)


def _masks(qs, pms):
    if pms is None:
        return [torch.zeros(q.shape[0], q.shape[2], dtype=torch.bool,
                            device=q.device) for q in qs]
    return [pm.to(device=q.device, dtype=torch.bool)
            for q, pm in zip(qs, pms)]


def _init_carries(q32):
    B, H, Nl, _ = q32.shape
    return (torch.zeros_like(q32),
            torch.full((B, H, Nl, 1), NEG_INF, device=q32.device),
            torch.zeros((B, H, Nl, 1), device=q32.device))


def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], pms, scale: float,
                   block_impl: str = "auto") -> list:
    """Exact attention over P shards: per-shard q/k/v (B, H, Nl, Dh) and key
    masks (B, Nl) (True = padded; None = no padding), each shard on its own
    device. Returns the P output blocks in q's dtype. A row with no
    unpadded key gives 0."""
    P = len(qs)
    Nl, Dh = qs[0].shape[2:]
    devs = [q.device for q in qs]
    kb, vb, mb = list(ks), list(vs), _masks(qs, pms)
    if len(set(devs)) == 1:
        # on one device the rotation is a re-index: widen K/V once here
        # rather than in each of the P x P steps (exact either way); across
        # devices the blocks travel in their own dtype and each step widens
        kb, vb = [k.float() for k in kb], [v.float() for v in vb]
    q32 = [q.float() * scale for q in qs]
    # itemsize 4: the step kernel widens K/V to f32 whatever the wire dtype
    step = (_ring_block_step
            if _use_kernel(block_impl, qs[0],
                           _ring_block_supported(Nl, Nl, Dh, 4))
            else ring_block_step_reference)
    carries = [_init_carries(q) for q in q32]
    for t in range(P):
        carries = [step(q32[s], kb[s], vb[s], mb[s], *carries[s])
                   for s in range(P)]
        if t < P - 1:
            kb, vb, mb = rotate(kb, devs), rotate(vb, devs), rotate(mb, devs)
    return [_normalize(o, l, q.dtype) for (o, _, l), q in zip(carries, qs)]


class _RingTrain(torch.autograd.Function):
    """The fused training ring (the JAX ``_ring_fused_train`` custom VJP):
    the forward is P x P launches of kernel 16, the backward P x P of kernel
    17, with dk/dv rotating with their K/V block until, after P rotations,
    they are back at their owner (the JAX step order). Inputs after the
    config are the P q shards, then k, v and the key masks."""

    @staticmethod
    def forward(ctx, cfg, *tensors):
        scale, rate, seed, b0 = cfg
        P = len(tensors) // 4
        qs, ks, vs, pms = (tensors[i * P:(i + 1) * P] for i in range(4))
        devs = [q.device for q in qs]
        Nl = qs[0].shape[2]
        q32 = [q.float() * scale for q in qs]
        kb, vb, mb = [k.float() for k in ks], [v.float() for v in vs], \
            list(pms)
        carries = [_init_carries(q) for q in q32]
        for t in range(P):
            carries = [_ring_train_step(
                q32[s], kb[s], vb[s], mb[s],
                (seed, b0, s * Nl, ((s - t) % P) * Nl), *carries[s], rate)
                for s in range(P)]
            if t < P - 1:
                kb, vb, mb = (rotate(kb, devs), rotate(vb, devs),
                              rotate(mb, devs))
        outs = [_normalize(o, l, q.dtype) for (o, _, l), q in zip(carries,
                                                                 qs)]
        ctx.save_for_backward(*qs, *ks, *vs, *pms, *outs,
                              *(c[1] for c in carries),
                              *(c[2] for c in carries))
        ctx.cfg = cfg
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        scale, rate, seed, b0 = ctx.cfg
        saved = ctx.saved_tensors
        P = len(gs)
        qs, ks, vs, pms, outs, ms, ls = (saved[i * P:(i + 1) * P]
                                         for i in range(7))
        devs = [q.device for q in qs]
        Nl = qs[0].shape[2]
        q32 = [q.float() * scale for q in qs]
        kb, vb, mb = [k.float() for k in ks], [v.float() for v in vs], \
            list(pms)
        g32 = [g.float() for g in gs]
        # D = rowsum(g * out), out normalised: the weights w = e / l carry
        # the normalisation
        d = [(g * o.float()).sum(dim=-1, keepdim=True)
             for g, o in zip(g32, outs)]
        dq = [torch.zeros_like(q) for q in q32]
        dkb = [torch.zeros_like(k) for k in kb]
        dvb = [torch.zeros_like(v) for v in vb]
        for t in range(P):
            for s in range(P):
                dq[s], dkb[s], dvb[s] = _ring_train_step_bwd(
                    q32[s], kb[s], vb[s], g32[s], d[s], ms[s], ls[s], mb[s],
                    (seed, b0, s * Nl, ((s - t) % P) * Nl), dq[s], dkb[s],
                    dvb[s], rate)
            if t < P - 1:
                kb, vb, mb = (rotate(kb, devs), rotate(vb, devs),
                              rotate(mb, devs))
            dkb, dvb = rotate(dkb, devs), rotate(dvb, devs)
        return (None, *((g * scale).to(q.dtype) for g, q in zip(dq, qs)),
                *(g.to(k.dtype) for g, k in zip(dkb, ks)),
                *(g.to(v.dtype) for g, v in zip(dvb, vs)), *([None] * P))


def ring_attention_train(qs: Sequence[torch.Tensor],
                         ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor], pms, scale: float,
                         seed: int, rate: float, b0: int = 0,
                         block_impl: str = "auto") -> list:
    """Trainable exact ring attention with dropout on the softmax weights,
    differentiable in every shard's q, k and v: the keep mask is
    :func:`ring_hash_keep` at global coordinates (``b0``: the shards' global
    batch offset), applied to the o accumulation while l sums the raw
    weights, elementwise ``dropout(softmax(s)) @ v``. The kernel route
    (every CUDA shape, see the module's ``block_impl``) is
    :class:`_RingTrain`; the plain route differentiates kernel 16's plain
    step and recomputes it in the backward (``torch.utils.checkpoint``), so
    no route keeps a (Nl, Nl) block per step and activation memory stays
    O(N / P)."""
    P = len(qs)
    Nl, Dh = qs[0].shape[2:]
    pms = _masks(qs, pms)
    if _use_kernel(block_impl, qs[0], _ring_train_supported(Nl, Nl, Dh)):
        return list(_RingTrain.apply((float(scale), float(rate), int(seed),
                                      int(b0)), *qs, *ks, *vs, *pms))
    devs = [q.device for q in qs]
    kb, vb, mb = list(ks), list(vs), pms
    q32 = [q.float() * scale for q in qs]
    carries = [_init_carries(q) for q in q32]
    for t in range(P):
        carries = [checkpoint(
            ring_train_step_reference, q32[s], kb[s], vb[s], mb[s],
            (int(seed), int(b0), s * Nl, ((s - t) % P) * Nl), *carries[s],
            float(rate), use_reentrant=False) for s in range(P)]
        if t < P - 1:
            kb, vb, mb = rotate(kb, devs), rotate(vb, devs), rotate(mb, devs)
    return [_normalize(o, l, q.dtype) for (o, _, l), q in zip(carries, qs)]


def make_ring_forward(mesh: DeviceMesh, scale: float,
                      block_impl: str = "auto"):
    """``fwd(q, k, v, pad_mask)``: sequence-sharded attention over a
    (data, seq) mesh. q/k/v (B, H, N, Dh) and pad_mask (B, N) arrive whole;
    the batch splits over ``data``, the sequence over ``seq``; the output
    comes back whole on q's device."""

    def fwd(q, k, v, pad_mask):
        if pad_mask is None:
            pad_mask = torch.zeros(q.shape[0], q.shape[2], dtype=torch.bool,
                                   device=q.device)
        qg, kg, vg = (place(mesh, t, 2) for t in (q, k, v))
        mg = place(mesh, pad_mask, 1)
        rows = [torch.cat([o.to(q.device) for o in ring_attention(
            qr, kr, vr, mr, scale, block_impl)], dim=2)
            for qr, kr, vr, mr in zip(qg, kg, vg, mg)]
        return torch.cat(rows, dim=0)

    return fwd

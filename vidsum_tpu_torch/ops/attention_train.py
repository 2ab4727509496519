# ported from vidsum_tpu/ops/attention_train.py
"""Trainable masked attention with dropout on the attention weights: the
flash-attention training route (``flash_attention_dropout``) and its
hand-written CUDA kernels.

The JAX package runs both passes as Pallas kernels and never materialises
the (B, H, N, N) dropout mask: its bits come from a counter hash of
(seed, batch index, head, absolute query row, absolute key column),
:func:`_keep_mask_block`, reproduced here bit for bit. Four TPU kernels,
chosen by the TPU's VMEM arithmetic (copied below, so that a shape takes the
same route in both packages):

- ``_fwd_kernel`` / ``_bwd_kernel`` (single pass, every key of a row at
  once): the forward normalises p = e / l, drops it, and rounds it to v's
  dtype before P.V; the backward recomputes p = exp(s - lse) and uses
  D = rowsum(dp * p) over the full row.
- ``_fwd_kernel_folded`` / ``_bwd_kernel_folded`` (an online softmax over
  ``kb``-key blocks, for long N): the denominator sums the raw e, dropout
  acts on the numerator, which is rounded unnormalised; the backward uses
  D = rowsum(do * o) and guards rows whose lse is below ``_DEAD``.

In the backward dp = do . v^T and dv = pd^T . do are f32 x f32 products in
both dtypes (the cotangent is rounded to q's dtype and widened), and ds is
rounded to q's dtype before dq = ds . k and dk = ds^T . q.

Here the four entry points map onto ``csrc/attention_train.cu``, which
launches one of two kernel families, by dtype, on both routes:

- bf16: ``csrc/attention_train_mma.cuh``, every product on the tensor cores
  (``mma.sync``, f32 accumulate; dv's f32 pd as three bf16 terms),
  double-buffered ``cp.async`` tiles, wholly padded key tiles skipped. The
  folded route is a mode of the same kernels: its forward fuses the two
  passes into one online pass, its dQ kernel takes D from the o rows in
  place of a pass over the keys. Bound at (2, 4, 8,192, 64): the products
  at the bf16 peak, 0.11 ms forward and 0.33 ms backward; below that, an
  exp and a hash per score element in every pass.
- f32: the FMA family of ``csrc/attention_core.cuh`` (the training block's
  chain runs it too), exact f32 products, since TF32 would not compute
  what the TPU's f32 kernels compute: 8 x 8 register tiles read as float4
  from row-major tiles that ``cp.async`` streams in, wholly padded key
  tiles skipped, one online forward pass on both routes (f32 rounds nothing
  between the normalise-first order's passes), and D = rowsum(do * o) on
  both routes (the single pass's Function saves o in f32; given no o, the
  kernel sums D = rowsum(dp * p) in a first pass, counted in
  ``_bwd_kernel.d_pass_launches``). Bound at (2, 4, 8,192, 64): 1.64 ms
  forward and 3.28 ms backward at the f32 peak.

Each has one forward kernel (bf16 normalise-first: two passes; online and
f32: one) and one backward pair, dQ per query tile and dK/dV per key tile,
with a D mode.
Blocks stream 64-key tiles through shared memory, so the TPU's ``kb`` is a
VMEM tactic: the plain folded versions fold over it, the kernels over their
own tiles (in f32 the two differ by summation order; in bf16 by where the
unnormalised e is rounded, as for ``ops/attention._flash_attention_folded``:
the card's checks fold the plain version over ``KEY_TILE``).
Each wrapper runs its plain version on CPU tensors and its kernel on CUDA
tensors, never a fallback, and counts its launches in ``launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from vidsum_tpu_torch.ops import _cuda
from vidsum_tpu_torch.ops.attention import _DEAD, _pick_key_block
from vidsum_tpu_torch.ops.block_train import (
    _M32, _fmix_keep, _keep_scale, _mul32, _threshold,
)

TILE = 128
KEY_TILE = 64  # keys per tile streamed by the CUDA kernels
NEG_INF = float("-inf")


# ------------------------------------------------------------ dropout bits

def _keep_hash(seed: int, b, h, rows, cols, rate: float) -> torch.Tensor:
    """Keep bits of ``_keep_mask_block`` over broadcast int64 tensors of
    batch index, head, absolute query row and absolute key column (uint32
    arithmetic in int64, masked to 32 bits, as ``block_train._keep_bits``
    does for the block's hash family)."""
    base = (((int(seed) * 0x9E3779B1) & _M32)
            + _mul32(b * 1024 + h + 1, 0x85EBCA77)) & _M32
    return _fmix_keep(base ^ _mul32(rows, 0xC2B2AE3D)
                      ^ _mul32(cols, 0x27D4EB2F), rate)


def _keep_mask_block(seed: int, b: int, h: int, row0: int, col0: int, shape,
                     rate: float) -> torch.Tensor:
    """Keep mask of a (T, C) tile at absolute (row0, col0), equal bit for bit
    to ``vidsum_tpu/ops/attention_train.py::_keep_mask_block``."""
    T, C = shape
    rows = torch.arange(T, dtype=torch.int64) + row0
    cols = torch.arange(C, dtype=torch.int64) + col0
    return _keep_hash(seed, torch.tensor(b), torch.tensor(h), rows[:, None],
                      cols[None, :], rate)


def _keep_mask(seed: int, b: int, h: int, tile_i: int, shape,
               rate: float) -> torch.Tensor:
    """The full-width (col0 = 0) mask of query tile ``tile_i``."""
    return _keep_mask_block(seed, b, h, tile_i * shape[0], 0, shape, rate)


def _tile_keep(seed: int, B: int, H: int, row0: int, rows: int, col0: int,
               cols: int, rate: float, device) -> torch.Tensor:
    """(B, H, rows, cols) keep bits of the tile at (row0, col0)."""
    ar = lambda n, off=0: torch.arange(  # noqa: E731
        n, dtype=torch.int64, device=device) + off
    return _keep_hash(seed, ar(B)[:, None, None, None],
                      ar(H)[None, :, None, None],
                      ar(rows, row0)[None, None, :, None],
                      ar(cols, col0)[None, None, None, :], rate)


def reference_keep_mask(seed: int, B: int, H: int, N: int,
                        rate: float) -> torch.Tensor:
    """(B, H, N, N) boolean keep mask, True = attention weight kept."""
    return _tile_keep(seed, B, H, 0, N, 0, N, rate, "cpu")


def dropout_attention_reference(q, k, v, pad_mask, keep, rate: float,
                                scale: float) -> torch.Tensor:
    """Dense attention applying a given (B, H, N, N) keep mask; ``pad_mask``
    (B, N) bool, True at padded keys."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s.masked_fill(pad_mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        p = torch.where(keep, p / (1.0 - rate), 0.0)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


# ---------------------------------------------------------- plain versions
# Loops over ``rows``-row query tiles (TILE, as the TPU kernels do, unless
# the caller asks for larger steps: rows are independent, so only the
# summation order of dk and dv depends on it); ``pad_mask`` is (B, N) bool,
# True at padded keys; lse is (B, H, N) f32.

def _scores(qt, kblk, pad_blk, scale: float):
    s = torch.matmul(qt, kblk.transpose(-1, -2)) * scale
    return s.masked_fill(pad_blk[:, None, None, :], NEG_INF)


def _drop(x, keep, rate: float):
    return torch.where(keep, x * _keep_scale(rate), 0.0) if rate > 0.0 else x


def attention_train_fwd_reference(q, k, v, pad_mask, seed: int, rate: float,
                                  scale: float, rows: int = TILE):
    """Single-pass forward (``_fwd_kernel``): (o in q's dtype, lse)."""
    B, H, N, _ = q.shape
    kf, vf = k.float(), v.float()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    for r0 in range(0, N, rows):
        s = _scores(q[:, :, r0:r0 + rows].float(), kf, pad_mask, scale)
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        l = e.sum(dim=-1, keepdim=True)
        lse[:, :, r0:r0 + rows] = (m + torch.log(l))[..., 0]
        p = e / l
        if rate > 0.0:
            p = _drop(p, _tile_keep(seed, B, H, r0, rows, 0, N, rate,
                                    q.device), rate)
        o[:, :, r0:r0 + rows] = torch.matmul(p.to(v.dtype).float(),
                                             vf).to(q.dtype)
    return o, lse


def attention_train_bwd_reference(q, k, v, pad_mask, seed: int, lse, do,
                                  rate: float, scale: float,
                                  rows: int = TILE):
    """Single-pass backward (``_bwd_kernel``): (dq, dk, dv) in q's dtype,
    with D = rowsum(dp * p) over the full row."""
    B, H, N, Dh = q.shape
    kf, vf = k.float(), v.float()
    dof = do.to(q.dtype).float()
    dq = torch.empty_like(q)
    dk = torch.zeros((B, H, N, Dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for r0 in range(0, N, rows):
        sl = slice(r0, r0 + rows)
        qt, dot = q[:, :, sl], dof[:, :, sl]
        p = torch.exp(_scores(qt.float(), kf, pad_mask, scale)
                      - lse[:, :, sl, None])
        dpd = torch.matmul(dot, vf.transpose(-1, -2))
        if rate > 0.0:
            keep = _tile_keep(seed, B, H, r0, rows, 0, N, rate, q.device)
            pd, dp = _drop(p, keep, rate), _drop(dpd, keep, rate)
        else:
            pd, dp = p, dpd
        dv += torch.matmul(pd.transpose(-1, -2), dot)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq[:, :, sl] = (torch.matmul(ds.to(k.dtype).float(), kf)
                        * scale).to(q.dtype)
        dk += torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                           qt.float()) * scale
    return dq, dk.to(q.dtype), dv.to(q.dtype)


def attention_train_fwd_folded_reference(q, k, v, pad_mask, seed: int,
                                         rate: float, scale: float, kb: int,
                                         rows: int = TILE):
    """Key-folded forward (``_fwd_kernel_folded``) over ``kb``-key blocks:
    (o in q's dtype, lse); a row with no unpadded key gives o = 0 and
    lse = -inf."""
    B, H, N, Dh = q.shape
    o_out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    for r0 in range(0, N, rows):
        qt = q[:, :, r0:r0 + rows].float()
        o = torch.zeros((B, H, rows, Dh), dtype=torch.float32,
                        device=q.device)
        m = torch.full((B, H, rows, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, H, rows, 1), device=q.device)
        for c0 in range(0, N, kb):
            s = _scores(qt, k[:, :, c0:c0 + kb].float(),
                        pad_mask[:, c0:c0 + kb], scale)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            dead = m_new < _DEAD
            m_safe = torch.where(dead, 0.0, m_new)
            e = torch.where(dead, 0.0, torch.exp(s - m_safe))
            corr = torch.where(m < _DEAD, 0.0, torch.exp(m - m_safe))
            l = l * corr + e.sum(dim=-1, keepdim=True)
            if rate > 0.0:
                e = _drop(e, _tile_keep(seed, B, H, r0, rows, c0, kb, rate,
                                        q.device), rate)
            o = o * corr + torch.matmul(e.to(v.dtype).float(),
                                        v[:, :, c0:c0 + kb].float())
            m = m_new
        empty = l == 0.0
        l_safe = torch.where(empty, 1.0, l)
        o_out[:, :, r0:r0 + rows] = torch.where(
            empty, 0.0, o * (1.0 / l_safe)).to(q.dtype)
        lse[:, :, r0:r0 + rows] = torch.where(
            empty, NEG_INF, m + torch.log(l_safe))[..., 0]
    return o_out, lse


def attention_train_bwd_folded_reference(q, k, v, pad_mask, seed: int, lse,
                                         do, o, rate: float, scale: float,
                                         kb: int, rows: int = TILE):
    """Key-folded backward (``_bwd_kernel_folded``): (dq, dk, dv) in q's
    dtype, with D = rowsum(do * o) and p = 0 on rows whose lse is below
    ``_DEAD``."""
    B, H, N, Dh = q.shape
    dof = do.to(q.dtype).float()
    d_row = (dof * o.float()).sum(dim=-1)
    dq_out = torch.empty_like(q)
    dk = torch.zeros((B, H, N, Dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for r0 in range(0, N, rows):
        sl = slice(r0, r0 + rows)
        qt, dot = q[:, :, sl].float(), dof[:, :, sl]
        lse_t = lse[:, :, sl, None]
        live = lse_t >= _DEAD
        lse_safe = torch.where(live, lse_t, 0.0)
        dq = torch.zeros((B, H, rows, Dh), dtype=torch.float32,
                         device=q.device)
        for c0 in range(0, N, kb):
            cs = slice(c0, c0 + kb)
            kblk, vblk = k[:, :, cs], v[:, :, cs].float()
            s = _scores(qt, kblk.float(), pad_mask[:, cs], scale)
            p = torch.where(live, torch.exp(s - lse_safe), 0.0)
            dpd = torch.matmul(dot, vblk.transpose(-1, -2))
            if rate > 0.0:
                keep = _tile_keep(seed, B, H, r0, rows, c0, kb, rate,
                                  q.device)
                pd, dp = _drop(p, keep, rate), _drop(dpd, keep, rate)
            else:
                pd, dp = p, dpd
            dv[:, :, cs] += torch.matmul(pd.transpose(-1, -2), dot)
            ds = p * (dp - d_row[:, :, sl, None])
            dq = dq + torch.matmul(ds.to(k.dtype).float(),
                                   kblk.float()) * scale
            dk[:, :, cs] += torch.matmul(
                ds.to(q.dtype).float().transpose(-1, -2), qt) * scale
        dq_out[:, :, sl] = dq.to(q.dtype)
    return dq_out, dk.to(q.dtype), dv.to(q.dtype)


# ----------------------------------------------------- the kernel launches

def _cuda_inputs(q, k, v, pad_mask, seed: int):
    """q, k, v as the kernels take them (contiguous, on 16 bytes, zero-padded
    along head_dim to ``_cuda.kernel_head_dim``), the mask as bytes and the
    dtype code."""
    B, H, N, Dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have one shape")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("q, k and v must have one dtype")
    Dp = _cuda.kernel_head_dim(Dh, "the training attention kernels")
    if N % KEY_TILE:
        raise ValueError(f"N={N} must be a multiple of {KEY_TILE}")
    if not 0 <= int(seed) < 2**31:
        raise ValueError(f"seed must lie in [0, 2**31), got {seed}")
    mask8 = pad_mask.to(device=q.device, dtype=torch.uint8).contiguous()
    if mask8.shape != (B, N):
        raise ValueError(f"pad_mask must be {(B, N)}, got "
                         f"{tuple(mask8.shape)}")
    q, k, v = (_cuda.pad_head_dim(t, Dp) for t in (q, k, v))
    return (*(_cuda.aligned16(t.contiguous()) for t in (q, k, v, mask8)),
            _cuda.dtype_code(q))


def _launch_fwd(q, k, v, pad_mask, seed: int, rate: float, scale: float,
                online: bool):
    Dh = q.shape[-1]
    q, k, v, mask8, code = _cuda_inputs(q, k, v, pad_mask, seed)
    B, H, N, Dp = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    lib = _cuda.load("attention_train")
    err = lib.vs_at_fwd(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(mask8),
        _cuda.ptr(o), _cuda.ptr(lse), B, H, N, Dp, float(scale), int(seed),
        _threshold(rate), _keep_scale(rate), code, int(online),
        _cuda.stream_of(q))
    _cuda.check(lib, err, "attention_train forward")
    return (o if Dp == Dh else o[..., :Dh].contiguous()), lse


def _launch_bwd(q, k, v, pad_mask, seed: int, lse, do, o, rate: float,
                scale: float, folded: bool):
    """``folded``: the folded backward (D = rowsum(do * o), lse guard; ``o``
    required); else the single-pass one (D = rowsum(dp * p), or in f32
    rowsum(do * o) where ``o`` is given)."""
    Dh = q.shape[-1]
    if do.shape != q.shape or (o is not None and o.shape != q.shape):
        raise ValueError("do (and o) must be (B, H, N, Dh) like q")
    q, k, v, mask8, code = _cuda_inputs(q, k, v, pad_mask, seed)
    B, H, N, Dp = q.shape
    do = _cuda.aligned16(_cuda.pad_head_dim(do.to(q.dtype), Dp).contiguous())
    lse = _cuda.aligned16(lse.float().contiguous())
    if o is not None:
        o = _cuda.aligned16(
            _cuda.pad_head_dim(o.to(q.dtype), Dp).contiguous())
    if lse.shape != (B, H, N):
        raise ValueError("lse must be (B, H, N)")
    d_row = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _cuda.load("attention_train")
    err = lib.vs_at_bwd(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(do),
        _cuda.ptr(o), _cuda.ptr(lse), _cuda.ptr(mask8), _cuda.ptr(d_row),
        _cuda.ptr(dq), _cuda.ptr(dk), _cuda.ptr(dv), B, H, N, Dp,
        float(scale), int(seed), _threshold(rate), _keep_scale(rate), code,
        int(folded), _cuda.stream_of(q))
    _cuda.check(lib, err, "attention_train backward")
    if Dp == Dh:
        return dq, dk, dv
    return tuple(t[..., :Dh].contiguous() for t in (dq, dk, dv))


# ------------------------------------------------ the four TPU entry points

def _fwd_kernel(q, k, v, pad_mask, seed: int, rate: float, scale: float):
    """Counterpart of ``vidsum_tpu/ops/attention_train.py::_fwd_kernel``:
    (o, lse)."""
    if q.device.type == "cpu":
        return attention_train_fwd_reference(q, k, v, pad_mask, seed, rate,
                                             scale)
    out = _launch_fwd(q, k, v, pad_mask, seed, rate, scale, online=False)
    _fwd_kernel.launches += 1
    return out


_fwd_kernel.launches = 0


def _bwd_kernel(q, k, v, pad_mask, seed: int, lse, do, rate: float,
                scale: float, o=None):
    """Counterpart of ``vidsum_tpu/ops/attention_train.py::_bwd_kernel``:
    (dq, dk, dv). The plain version takes D = rowsum(dp * p), as the TPU
    kernel does; the f32 kernels take D = rowsum(do * o) from the forward's
    ``o`` where it is given (the same quantity), else they sum it in a
    first pass over the keys, as the bf16 kernels always do (counted in
    ``d_pass_launches``)."""
    if q.device.type == "cpu":
        return attention_train_bwd_reference(q, k, v, pad_mask, seed, lse,
                                             do, rate, scale)
    if q.dtype != torch.float32:
        o = None
    out = _launch_bwd(q, k, v, pad_mask, seed, lse, do, o, rate, scale,
                      folded=False)
    _bwd_kernel.launches += 1
    _bwd_kernel.d_pass_launches += o is None
    return out


_bwd_kernel.launches = 0
_bwd_kernel.d_pass_launches = 0


def _fwd_kernel_folded(q, k, v, pad_mask, seed: int, rate: float,
                       scale: float, kb: int):
    """Counterpart of ``vidsum_tpu/ops/attention_train.py::
    _fwd_kernel_folded``: (o, lse). ``kb`` is the TPU key block; the plain
    version folds over it, the CUDA kernel over its own 64-key tiles."""
    if q.device.type == "cpu":
        return attention_train_fwd_folded_reference(q, k, v, pad_mask, seed,
                                                    rate, scale, kb)
    out = _launch_fwd(q, k, v, pad_mask, seed, rate, scale, online=True)
    _fwd_kernel_folded.launches += 1
    return out


_fwd_kernel_folded.launches = 0


def _bwd_kernel_folded(q, k, v, pad_mask, seed: int, lse, do, o,
                       rate: float, scale: float, kb: int):
    """Counterpart of ``vidsum_tpu/ops/attention_train.py::
    _bwd_kernel_folded`` with its D = rowsum(do * o), which the CUDA dQ
    kernel computes: (dq, dk, dv)."""
    if q.device.type == "cpu":
        return attention_train_bwd_folded_reference(
            q, k, v, pad_mask, seed, lse, do, o, rate, scale, kb)
    out = _launch_bwd(q, k, v, pad_mask, seed, lse, do, o, rate, scale,
                      folded=True)
    _bwd_kernel_folded.launches += 1
    return out


_bwd_kernel_folded.launches = 0


# ------------------------------------------------------ routing arithmetic
# The TPU kernels' VMEM budgets, copied so that a shape takes the same route
# here as in the JAX package.

def _single_pass_ok(N: int, Dh: int, itemsize: int) -> bool:
    """Single-pass budget: q/k/v/o (N, Dh) + (TILE, N) f32 score and mask
    tiles per program."""
    return (4 * N * Dh * itemsize + 5 * TILE * N) <= 12 * 1024 * 1024


def _folded_train_ok(N: int, Dh: int, itemsize: int) -> bool:
    """Key-folded training budget: seven lane-padded, double-buffered
    (N, Dh) windows and two f32 accumulators within 90 MB."""
    lanes = max(Dh, 128)
    windows = 7 * 2 * N * lanes * itemsize
    scratch = 2 * N * lanes * 4
    return windows + scratch <= 90 * 1024 * 1024


def flash_train_supported(N: int, Dh: int, itemsize: int) -> bool:
    """True when :func:`flash_attention_dropout` has a route for this shape
    (single-pass or key-folded)."""
    return (N % TILE == 0
            and (_single_pass_ok(N, Dh, itemsize)
                 or _folded_train_ok(N, Dh, itemsize)))


# ------------------------------------------------------- autograd Function

class _FlashAttentionDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pad_mask, seed, rate, scale):
        N, Dh = q.shape[2], q.shape[3]
        folded = not _single_pass_ok(N, Dh, q.element_size())
        kb = _pick_key_block(N)
        if folded:
            o, lse = _fwd_kernel_folded(q, k, v, pad_mask, seed, rate, scale,
                                        kb)
            # o is a residual of the folded backward (its D)
            ctx.save_for_backward(q, k, v, pad_mask, lse, o)
        else:
            o, lse = _fwd_kernel(q, k, v, pad_mask, seed, rate, scale)
            # in f32 the single pass's D comes from o too (no pass over the
            # keys for rowsum(dp * p)); bf16 keeps its TPU kernel's D
            ctx.save_for_backward(q, k, v, pad_mask, lse,
                                  *((o,) if q.dtype == torch.float32 else ()))
        ctx.cfg = (seed, rate, scale, folded, kb)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, pad_mask, lse, *o = ctx.saved_tensors
        seed, rate, scale, folded, kb = ctx.cfg
        do = do.to(q.dtype)
        if folded:
            dq, dk, dv = _bwd_kernel_folded(q, k, v, pad_mask, seed, lse, do,
                                            o[0], rate, scale, kb)
        else:
            dq, dk, dv = _bwd_kernel(q, k, v, pad_mask, seed, lse, do, rate,
                                     scale, o=o[0] if o else None)
        return dq, dk, dv, None, None, None, None


def flash_attention_dropout(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, pad_mask: Optional[torch.Tensor],
                            seed: int, rate: float,
                            scale: float) -> torch.Tensor:
    """Attention with dropout on the softmax weights, differentiable in q, k
    and v. q/k/v (B, H, N, Dh), N a multiple of 128; ``pad_mask`` the port's
    (B, N) bool, True at padded keys (the JAX package takes it as (B, 1, N)
    int8), or None; ``seed`` in [0, 2**31); returns (B, H, N, Dh) in q's
    dtype. Raises ``ValueError`` past the key-folded route's envelope."""
    B, H, N, Dh = q.shape
    if N % TILE:
        raise ValueError(f"flash_attention_dropout: N={N} must be a multiple "
                         f"of {TILE}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    if not flash_train_supported(N, Dh, q.element_size()):
        raise ValueError(
            f"flash_attention_dropout: N={N}, Dh={Dh}, dtype={q.dtype} is "
            f"past the key-folded training route's envelope (the TPU "
            f"kernels' VMEM budget, copied so that routes match), and a "
            f"dense fallback would need the (B, H, N, N) attention tensor in "
            f"memory. Train such lengths with the sequence-parallel ring "
            f"(parallel/seq_forward.make_seq_sharded_finetune_step) or a "
            f"shorter length bucket.")
    if pad_mask is None:
        pad_mask = torch.zeros((B, N), dtype=torch.bool, device=q.device)
    return _FlashAttentionDropout.apply(q, k, v, pad_mask.to(torch.bool),
                                        int(seed), float(rate), float(scale))

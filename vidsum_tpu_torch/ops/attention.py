# ported from vidsum_tpu/ops/attention.py
"""Masked attention on (B, H, N, Dh): the flash-attention ladder of the
inference path and its hand-written CUDA kernel.

The JAX package has two Pallas kernels here: ``_attention_kernel`` (a
single pass over all keys per 128-query tile) and
``_attention_kernel_folded`` (an online softmax over key blocks, for long
N). Both map onto ``csrc/masked_attention.cu``, which streams K/V through
shared memory in 64-key tiles at every length (bf16 on the tensor cores;
f32 on ``csrc/attention_core.cuh``'s FMA forward, the f32 training
attention's); the single-pass/folded split is a TPU VMEM matter, apart from
where bf16 P is rounded (after normalising in the single pass, before it in
the fold), which the kernels follow. The two entry points
:func:`_flash_attention` and :func:`_flash_attention_folded` stay, with the
JAX package's dispatch arithmetic in :func:`flash_attention`, so that the
route a request takes maps one to one onto the TPU kernel it replaces.

Each wrapper runs its kernel on CUDA tensors and its plain PyTorch version
on CPU tensors; a CUDA tensor never falls back. ``launches`` on a wrapper
counts its kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from vidsum_tpu_torch.ops import _cuda

TILE_Q = 128
KEY_TILE = 64  # keys per tile streamed by the CUDA kernel
_DEAD = -1e37  # rows below this max have seen no unmasked key yet


# ------------------------------------------------------------ plain versions

def attention_reference(q, k, v, pad_mask, scale: float) -> torch.Tensor:
    """Dense masked attention: scores in f32, ``-inf`` at padded keys, a
    stable softmax, P rounded to the input dtype, P.V accumulated in f32,
    output in the input dtype (``attention.py::_xla_attention``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if pad_mask is not None:
        s = s.masked_fill(pad_mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


def attention_folded_reference(q, k, v, pad_mask, scale: float,
                               kb: int) -> torch.Tensor:
    """The key-block fold of ``_attention_kernel_folded`` in plain PyTorch:
    an online softmax over ``kb``-key blocks with the ``_DEAD`` guards; a row
    with no unpadded key comes out as 0."""
    B, H, N, Dh = q.shape
    qf = q.float()
    o = torch.zeros((B, H, N, Dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, N, 1), float("-inf"), device=q.device)
    l = torch.zeros((B, H, N, 1), device=q.device)
    for j in range(0, N, kb):
        kblk = k[:, :, j:j + kb].float()
        vblk = v[:, :, j:j + kb]
        s = torch.matmul(qf, kblk.transpose(-1, -2)) * scale
        if pad_mask is not None:
            s = s.masked_fill(pad_mask[:, None, None, j:j + kb],
                              float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        dead = m_new < _DEAD
        m_safe = torch.where(dead, 0.0, m_new)
        e = torch.where(dead, 0.0, torch.exp(s - m_safe))
        corr = torch.where(m < _DEAD, 0.0, torch.exp(m - m_safe))
        l = l * corr + e.sum(dim=-1, keepdim=True)
        o = o * corr + torch.matmul(e.to(v.dtype).float(), vblk.float())
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.where(l == 0.0, 0.0, o * (1.0 / l_safe))
    return o.to(q.dtype)


# -------------------------------------------------------------- the kernel

def attention_q8_reference(q8, k8, v, qs, ks, pad_mask, scale: float,
                           out_dtype) -> torch.Tensor:
    """The int8 block's attention with ``qk_int8``
    (``block_kernel_int8.py::_block_kernel_int8``, lines 105-120): scores
    ``i8dot(q8, k8) * (qs * ks) * scale`` (the integer dot exact, in f64),
    the softmax normalised by a reciprocal multiply, P rounded to v's dtype,
    P.V in f32; the output in ``out_dtype``."""
    dot = torch.matmul(q8.double(), k8.double().transpose(-1, -2)).float()
    s = dot * (qs[..., :, None] * ks[..., None, :]) * scale
    if pad_mask is not None:
        s = s.masked_fill(pad_mask[:, None, None, :], float("-inf"))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(out_dtype)


def attention_layout_ok(*tensors) -> bool:
    """True when every given tensor (None skipped) can be an operand of the
    f32 attention kernels (``csrc/attention_core.cuh``), which copy and
    store 16-byte chunks: data on a 16-byte boundary, a unit last stride
    and every other stride a multiple of 4 elements. The training kernels
    refuse the rest; :func:`masked_attention` stages it (a counted
    fallback)."""
    return all(t is None or (
        t.data_ptr() % 16 == 0 and t.stride(-1) == 1
        and all(st % 4 == 0 for st in t.stride()[:-1])) for t in tensors)


def mma_cta_rows(B: int, H: int, N: int, Dh: int, sms: int) -> int:
    """Query rows of a CTA: 128 (bf16: 8 warps; f32: 8 rows a thread; each
    K/V tile read from L2 feeding twice the rows) where a grid of 128-row
    CTAs fills the card once, that is both CTA slots of each of its ``sms``
    SMs (the kernels' launch bounds hold two), else 64 (bf16: 4 warps,
    twice the CTAs on a smaller grid; f32: 4 rows a thread, twice the warps
    a CTA); 64 at head_dim 96 and 128, whose accumulators take the
    registers. The rule follows the two shapes' device times at the serving
    path's shapes in both dtypes (``chip_smoke.py``'s
    ``attention_cta_variants`` line)."""
    if Dh > 64:
        return 64
    return 128 if -(-N // 128) * H * B >= 2 * sms else 64


def masked_attention(q, k, v, pad_mask, scale: float,
                     out: Optional[torch.Tensor] = None,
                     norm_first: bool = True, qk_scales=None) -> torch.Tensor:
    """Launch ``csrc/masked_attention.cu`` on CUDA tensors.

    ``q``/``k``/``v`` are (B, H, N, Dh) views with equal strides and a
    contiguous last dim (they may be slices of one fused QKV buffer), any
    Dh (a head_dim off ``_cuda.HEAD_DIMS`` runs zero-padded to the next
    entry, one past 128 to a multiple of 128 that the kernels run in
    128-column slices: ``_cuda.kernel_head_dim``; with ``qk_scales`` the
    int8 codes are padded with zero codes, so the scales stay the unpadded
    rows');
    ``pad_mask`` is (B, N) bool, True at padded keys;
    ``out``, if given, is a (B, H, N, Dh) view to write into, in v's dtype
    or, for bf16 inputs with ``norm_first``, in f32 (the int8 block's attn).
    ``norm_first`` rounds the normalised probabilities to the input dtype,
    as the single-pass and block TPU kernels do; without it the
    unnormalised ones of an online softmax over the kernel's 64-key tiles
    are rounded, as the folded TPU kernel does. ``qk_scales=(qs, ks)``,
    (B, H, N) f32 views, make ``q`` and ``k`` int8 codes with those per-row
    scales (the int8 block's ``qk_int8``). :func:`mma_cta_rows` picks the
    query rows of a CTA; every row's arithmetic is the same in both
    shapes. f32 takes the FMA forward, whose 16-byte copies need
    :func:`attention_layout_ok` views: others are staged into aligned
    contiguous copies first, counted by ``masked_attention.
    fallback_launches`` (the same kernel, the same bits). On CPU tensors
    this is
    :func:`attention_reference`, :func:`attention_folded_reference` over
    64-key blocks or :func:`attention_q8_reference`."""
    if v.device.type == "cpu":
        if qk_scales is not None:
            ref = attention_q8_reference(
                q, k, v, *qk_scales, pad_mask, scale,
                v.dtype if out is None else out.dtype)
        elif norm_first:
            ref = attention_reference(q, k, v, pad_mask, scale)
        else:
            ref = attention_folded_reference(q, k, v, pad_mask, scale,
                                             KEY_TILE)
        if out is None:
            return ref
        out.copy_(ref)
        return out
    B, H, N, Dh = v.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have one shape")
    if k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError("q, k and v must have equal strides")
    if q.stride(-1) != 1:
        raise ValueError("q, k, v need a contiguous last dim")
    qsc = ksc = None
    if qk_scales is None:
        if not (q.dtype == k.dtype == v.dtype):
            raise ValueError("q, k and v must have one dtype")
    else:
        qsc, ksc = qk_scales
        if q.dtype != torch.int8 or k.dtype != torch.int8:
            raise ValueError("with qk_scales, q and k are int8 codes")
        if (qsc.shape != (B, H, N) or ksc.shape != qsc.shape
                or qsc.stride() != ksc.stride()
                or qsc.dtype != torch.float32 or ksc.dtype != torch.float32):
            raise ValueError("qk_scales must be two (B, H, N) float32 views "
                             "with equal strides")
    Dp = _cuda.kernel_head_dim(Dh, "masked_attention's kernels")
    given = None
    if Dp != Dh:
        # the kernels run the head zero-padded to Dp; the result is sliced
        # back into ``out`` (or a new tensor)
        q, k, v = (_cuda.pad_head_dim(t, Dp) for t in (q, k, v))
        given = out
        if given is not None and given.shape != (B, H, N, Dh):
            raise ValueError(f"out must be {(B, H, N, Dh)}, got "
                             f"{tuple(given.shape)}")
        out = None if given is None else torch.empty(
            v.shape, dtype=given.dtype, device=v.device)
    if pad_mask is None:
        pad_mask = torch.zeros((B, N), dtype=torch.bool, device=v.device)
    mask = pad_mask.to(device=v.device, dtype=torch.bool).contiguous()
    if mask.shape != (B, N):
        raise ValueError(f"pad_mask must be {(B, N)}, got {tuple(mask.shape)}")
    if out is None:
        out = torch.empty_like(v)
    f32_out = out.dtype == torch.float32 and v.dtype == torch.bfloat16
    if (out.shape != v.shape or out.stride(-1) != 1
            or not (out.dtype == v.dtype or (f32_out and norm_first))):
        raise ValueError("out must be a (B, H, N, Dh) view with a contiguous "
                         "last dim, in v's dtype (or float32 for bfloat16 "
                         "inputs with norm_first)")
    if qk_scales is not None and v.dtype == torch.bfloat16 and not f32_out:
        raise ValueError("int8 Q.K^T with bfloat16 v writes a float32 out")
    staged = None
    if (v.dtype == torch.float32 and qk_scales is None
            and not attention_layout_ok(q, k, v, out)):
        q, k, v = (_cuda.aligned16(t.contiguous()) for t in (q, k, v))
        staged, out = out, torch.empty_like(v)
    lib = _cuda.load("masked_attention")
    sb, sh, sn, _ = v.stride()
    ob, oh, on, _ = out.stride()
    cb, ch, cn = qsc.stride() if qsc is not None else (0, 0, 0)
    cta_rows = mma_cta_rows(B, H, N, Dp, _cuda.sm_count(v.device))
    err = lib.vs_masked_attention(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(mask),
        _cuda.ptr(out), _cuda.ptr(qsc), _cuda.ptr(ksc), B, H, N, Dp, sb, sh,
        sn, ob, oh, on, cb, ch, cn, float(scale), _cuda.dtype_code(v),
        _cuda.dtype_code(out), int(norm_first), cta_rows,
        _cuda.stream_of(v))
    _cuda.check(lib, err, "masked_attention")
    masked_attention.launches += 1
    if staged is not None:
        masked_attention.fallback_launches += 1
        return staged.copy_(out)
    if Dp != Dh:
        out = out[..., :Dh]
        return out.contiguous() if given is None else given.copy_(out)
    return out


masked_attention.launches = 0
masked_attention.fallback_launches = 0


# ------------------------------------------- the position-biased attention
# PGL-SUM's attention (models/pglsum.py): softmax(Q K^T + P_T) V, unscaled,
# with P_T the absolute position bias of each batch element's own valid
# length T. It has no TPU kernel: the JAX package has no PGL-SUM.

POSBIAS_HEAD_DIMS = (64, 128)


def position_bias_den(count: int, d: int, freq: int, device) -> torch.Tensor:
    """``den[j] = freq ** ((2 j) / d)`` for ``j < count``, float32, computed
    as PGL-SUM's public code computes it (an int64 ``j``, true division,
    then the power in float32; past ``2j`` ~ 9,860 at d 1,024 it is inf)."""
    j = torch.arange(count, device=device)
    return (freq ** ((2 * j) / d)).float()


def position_bias(T: int, den: torch.Tensor, rows: Optional[int] = None
                  ) -> torch.Tensor:
    """The (rows, T) position bias of a length-``T`` sequence (``rows``
    defaults to T): ``P[p, 2j] = sin(p / den[j])``, ``P[p, 2j + 1] =
    cos(p / den[j])`` for ``j < T // 2``, every other entry 0 (the last
    column of an odd T)."""
    rows = T if rows is None else rows
    half = T // 2
    p = torch.zeros((rows, T), dtype=torch.float32, device=den.device)
    if half:
        ang = (torch.arange(rows, device=den.device).float()[:, None]
               / den[None, :half])
        p[:, 0:2 * half:2] = torch.sin(ang)
        p[:, 1:2 * half:2] = torch.cos(ang)
    return p


def attention_posbias_reference(q, k, v, lens, den) -> torch.Tensor:
    """Plain version of :func:`masked_attention_posbias`: per batch element
    b of valid length ``T = lens[b]``, ``softmax(q k^T + P_T)`` over its
    first T keys (the bias given for every query row), times v; an element
    with T = 0 gives zeros. f32."""
    B, H, N, Dh = q.shape
    out = torch.zeros((B, H, N, Dh), dtype=torch.float32, device=q.device)
    for b, T in enumerate(int(t) for t in lens):
        if T == 0:
            continue
        s = torch.matmul(q[b].float(), k[b, :, :T].float().transpose(-1, -2))
        s = s + position_bias(T, den, rows=N)
        out[b] = torch.matmul(torch.softmax(s, dim=-1), v[b, :, :T].float())
    return out


def masked_attention_posbias(q, k, v, lens, den,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """``softmax(Q K^T + P_T) V`` with no scaling, PGL-SUM's attention, on
    ``csrc/masked_attention.cu``'s ``vs_masked_attention_posbias``
    (``attention_core.cuh``'s ``fma_fwd_posbias_kernel``).

    ``q``/``k``/``v`` are f32 (B, H, N, Dh) views with equal strides and a
    contiguous last dim, Dh in ``POSBIAS_HEAD_DIMS``; ``lens`` (B,) int the
    valid length of each element: keys at and past it are padded, and its
    bias is ``P_{lens[b]}`` (:func:`position_bias`), computed in the kernel
    tile by tile: one IEEE ``sincosf`` of ``row / den[j]`` for each row and
    column pair (2j, 2j + 1) below ``2 (lens[b] // 2)``; ``den`` is
    :func:`position_bias_den`'s table, at least ``ceil(N / 2)`` long.
    Nothing of size N x N is allocated. An element with length 0 gives
    zeros. ``out``, if given, is a (B, H, N, Dh) f32 view to write into.
    CTAs hold 64 query rows at both head_dims; a row's bits do not depend
    on the batch. On CPU tensors this is
    :func:`attention_posbias_reference`."""
    if v.device.type == "cpu":
        ref = attention_posbias_reference(q, k, v, lens, den)
        return ref if out is None else out.copy_(ref)
    B, H, N, Dh = v.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have one shape")
    if k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError("q, k and v must have equal strides")
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise ValueError("the position-biased attention takes float32")
    if Dh not in POSBIAS_HEAD_DIMS:
        raise ValueError(f"the position-biased attention takes head_dim "
                         f"{POSBIAS_HEAD_DIMS}, got {Dh}")
    if den.dtype != torch.float32 or den.numel() < (N + 1) // 2:
        raise ValueError("den must be a float32 table of ceil(N / 2) or "
                         "more entries")
    lens_t = lens.to(device=v.device, dtype=torch.int32).contiguous()
    if lens_t.shape != (B,):
        raise ValueError(f"lens must be ({B},), got {tuple(lens_t.shape)}")
    mask = (torch.arange(N, device=v.device)[None, :]
            >= lens_t[:, None]).contiguous()
    if out is None:
        out = torch.empty_like(v)
    if (out.shape != v.shape or out.dtype != torch.float32
            or out.stride(-1) != 1):
        raise ValueError("out must be a (B, H, N, Dh) float32 view with a "
                         "contiguous last dim")
    staged = None
    if not attention_layout_ok(q, k, v, out):
        q, k, v = (_cuda.aligned16(t.contiguous()) for t in (q, k, v))
        staged, out = out, torch.empty_like(v)
    den = _cuda.aligned16(den.contiguous())
    lib = _cuda.load("masked_attention")
    sb, sh, sn, _ = v.stride()
    ob, oh, on, _ = out.stride()
    err = lib.vs_masked_attention_posbias(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(lens_t),
        _cuda.ptr(den), _cuda.ptr(mask), _cuda.ptr(out), B, H, N, Dh, sb, sh,
        sn, ob, oh, on, _cuda.stream_of(v))
    _cuda.check(lib, err, "masked_attention_posbias")
    masked_attention_posbias.launches += 1
    if staged is not None:
        masked_attention_posbias.fallback_launches += 1
        return staged.copy_(out)
    return out


masked_attention_posbias.launches = 0
masked_attention_posbias.fallback_launches = 0


# ------------------------------------------------ the two TPU entry points

def _flash_attention(q, k, v, pad_mask, scale: float) -> torch.Tensor:
    """Counterpart of the single-pass TPU kernel
    (``vidsum_tpu/ops/attention.py::_attention_kernel``)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, pad_mask, scale)
    out = masked_attention(q, k, v, pad_mask, scale)
    _flash_attention.launches += 1
    return out


_flash_attention.launches = 0


def _flash_attention_folded(q, k, v, pad_mask, scale: float,
                            kb: int) -> torch.Tensor:
    """Counterpart of the key-folded TPU kernel
    (``vidsum_tpu/ops/attention.py::_attention_kernel_folded``). ``kb`` is
    the TPU key block; the plain version folds over it, the CUDA kernel
    over its own 64-key tiles."""
    if q.device.type == "cpu":
        return attention_folded_reference(q, k, v, pad_mask, scale, kb)
    out = masked_attention(q, k, v, pad_mask, scale, norm_first=False)
    _flash_attention_folded.launches += 1
    return out


_flash_attention_folded.launches = 0


# ------------------------------------------------------ dispatch arithmetic
# The thresholds below are the TPU's VMEM budgets, copied so that a request
# takes the same route here as in the JAX package. A later PR retunes them
# after measuring on the H100.

def _pick_key_block(N: int) -> int:
    """Largest 128-multiple divisor of N capped at 4096."""
    for kb in (4096, 2048, 1024, 512, 256, 128):
        if N % kb == 0:
            return kb
    return TILE_Q


def _folded_forward_vmem(N: int, Dh: int, itemsize: int, kb: int) -> int:
    return (4 * N * Dh * itemsize + 6 * TILE_Q * kb * 4
            + 2 * TILE_Q * Dh * 4)


def flash_forward_supported(N: int, Dh: int, itemsize: int = 4) -> bool:
    """True when the last rung of the single-device ladder (the key-folded
    route) carries a length-``N`` forward: the dispatch arithmetic of
    :func:`flash_attention`. Serving uses it for its length cap."""
    return _folded_forward_vmem(N, Dh, itemsize,
                                _pick_key_block(N)) <= 80 * 1024 * 1024


def flash_attention(q, k, v, pad_mask, scale: float) -> torch.Tensor:
    """Fused attention. q/k/v: (B, H, N, Dh); pad_mask: (B, N) bool, True at
    padded keys (or None); returns (B, H, N, Dh) in q's dtype. On the CPU, N
    that is not a multiple of 128 takes the dense plain path, as in the JAX
    package; on the card the kernels take any N (they mask their last key
    tile), so a CUDA tensor never leaves them for the plain path."""
    B, H, N, Dh = q.shape
    if N % TILE_Q != 0 and q.device.type == "cpu":
        return attention_reference(q, k, v, pad_mask, scale)
    if pad_mask is None:
        pad_mask = torch.zeros((B, N), dtype=torch.bool, device=q.device)
    itemsize = q.element_size()
    vmem_single = 4 * N * Dh * itemsize + 4 * TILE_Q * N
    if vmem_single <= 12 * 1024 * 1024:
        return _flash_attention(q, k, v, pad_mask, scale)
    kb = _pick_key_block(N)
    if flash_forward_supported(N, Dh, itemsize):
        return _flash_attention_folded(q, k, v, pad_mask, scale, kb)
    raise ValueError(
        f"flash_attention: N={N}, Dh={Dh} is past the key-folded route's "
        f"envelope ({_folded_forward_vmem(N, Dh, itemsize, kb) / 2**20:.0f} "
        f"MB > 80 MB); use a shorter length bucket.")

# ported from vidsum_tpu/ops/attention.py
"""Masked attention on (B, H, N, Dh): the flash-attention ladder of the
inference path and its hand-written CUDA kernel.

The JAX package has two Pallas kernels here: ``_attention_kernel`` (a
single pass over all keys per 128-query tile) and
``_attention_kernel_folded`` (an online softmax over key blocks, for long
N). Both map onto one CUDA kernel, ``csrc/masked_attention.cu``, which
streams K/V through shared memory in 64-key tiles at every length; the
single-pass/folded split is a TPU VMEM matter, apart from where bf16 P is
rounded (after normalising in the single pass, before it in the fold),
which the kernel follows. The two entry points
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


def masked_attention(q, k, v, pad_mask, scale: float,
                     out: Optional[torch.Tensor] = None,
                     norm_first: bool = True, qk_scales=None) -> torch.Tensor:
    """Launch ``csrc/masked_attention.cu`` on CUDA tensors.

    ``q``/``k``/``v`` are (B, H, N, Dh) views with equal strides and a
    contiguous last dim (they may be slices of one fused QKV buffer), Dh 16
    or 64; ``pad_mask`` is (B, N) bool, True at padded keys; ``out``, if
    given, is a (B, H, N, Dh) view to write into, in v's dtype or, for bf16
    inputs with ``norm_first``, in f32 (the int8 block's attn). ``norm_first``
    rounds the normalised probabilities to the input dtype, as the
    single-pass and block TPU kernels do; without it the unnormalised ones of
    an online softmax over the kernel's 64-key tiles are rounded, as the
    folded TPU kernel does. ``qk_scales=(qs, ks)``, (B, H, N) f32 views, make
    ``q`` and ``k`` int8 codes with those per-row scales (the int8 block's
    ``qk_int8``). On CPU tensors this is :func:`attention_reference`,
    :func:`attention_folded_reference` over 64-key blocks or
    :func:`attention_q8_reference`."""
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
    if Dh not in (16, 64):
        raise ValueError(f"masked_attention takes head_dim 16 or 64 (those "
                         f"of the repo's configurations), got {Dh}")
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
    lib = _cuda.load("masked_attention")
    sb, sh, sn, _ = v.stride()
    ob, oh, on, _ = out.stride()
    cb, ch, cn = qsc.stride() if qsc is not None else (0, 0, 0)
    err = lib.vs_masked_attention(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(mask),
        _cuda.ptr(out), _cuda.ptr(qsc), _cuda.ptr(ksc), B, H, N, Dh, sb, sh,
        sn, ob, oh, on, cb, ch, cn, float(scale), _cuda.dtype_code(v),
        _cuda.dtype_code(out), int(norm_first), _cuda.stream_of(v))
    _cuda.check(lib, err, "masked_attention")
    masked_attention.launches += 1
    return out


masked_attention.launches = 0


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
    padded keys (or None); returns (B, H, N, Dh) in q's dtype. N that is not
    a multiple of 128 takes the dense plain path, as in the JAX package."""
    B, H, N, Dh = q.shape
    if N % TILE_Q != 0:
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

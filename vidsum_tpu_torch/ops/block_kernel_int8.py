# ported from vidsum_tpu/ops/block_kernel_int8.py
"""The fused int8 (W8A8) post-LN encoder block of the int8 scoring path, as
a chain of hand-written CUDA kernels.

The JAX package runs the whole quantised block in one Pallas program per
batch element (``_block_kernel_int8``, N >= 512) or per group of
G = 1024//N elements (``_block_kernel_int8_grouped``, N < 512), with every
product on the int8 MXU. As for the bf16 block (``ops/block_kernel.py``), an
H100 SM cannot hold a block's weights, so here the block is a chain:

    quant  quantize_rows(x)                           x8, sx (x in its dtype)
    QKV    int8_gemm(x8, Wqkv)                        d -> 3d, x's dtype (and
                                                      f32 with qk_int8)
    [quant quantize_rows(Q, K per head, from f32)     qk_int8 only]
    attn   masked_attention(Q, K, V) -> f32           normalised P rounded to
                                                      x's dtype; int8 Q.K^T
                                                      with qk_int8
    quant  quantize_rows(attn)                        from f32
    proj   int8_gemm(attn8, Wp) + x -> LN1            h1 f32 and its codes
    fc1    int8_gemm(h1_8, W1) -> ReLU                m1 f32
    quant  quantize_rows(m1)
    fc2    int8_gemm(m1_8, W2) + h1 -> LN2            out in x's dtype

``csrc/int8_gemm.cu`` holds the quantizer and the int8 tensor-core GEMM,
``csrc/masked_attention.cu`` the attention. The rounding points are the TPU
kernel's (``block_kernel_int8.py:71-137``): the int8 products are exact, the
quantizer is the plain version's arithmetic step for step, so kernel and
plain version share their int8 codes except where an f32 summation order
(LayerNorm moments, softmax sums, P.V) moves a value across a rounding
boundary. Grouping is a VMEM tactic with no counterpart here beyond the row
count B*N, so both TPU kernels map onto the same chain; the two entry points
and the routing arithmetic (``_working_set_bytes``, ``_VMEM_BUDGET``,
``fused_block_int8_supported``, ``_pick_group``, ``_pick_tile``) stay, so a
request takes the same route as in the JAX package and launch counts map
one to one.

Each entry point runs its kernels on CUDA tensors and its plain PyTorch
version (``ops/quant.int8_block`` with the plain quantizer and product) on
CPU tensors; a CUDA tensor never falls back. ``launches`` on an entry point
counts its runs of the chain.
"""

from __future__ import annotations

from typing import Optional

import torch

from vidsum_tpu_torch.ops.attention import masked_attention
from vidsum_tpu_torch.ops.block_kernel import _pick_group, _pick_tile
from vidsum_tpu_torch.ops.quant import (
    QuantBlock, int8_block, int8_gemm, int8_gemm_reference, qk_int8_default,
    quantize_rows, quantize_rows_reference,
)

__all__ = ["fused_encoder_block_int8", "fused_block_int8_supported",
           "int8_block_reference"]


# ------------------------------------------------------------ plain version

def int8_block_reference(qb: QuantBlock, x: torch.Tensor, pad_mask,
                         num_heads: int, scale: float,
                         qk_int8: bool) -> torch.Tensor:
    """Plain version of TPU kernels 13/14 on any device: the quantised block
    with the plain row quantizer and exact f64 integer products."""
    return int8_block(qb, x, pad_mask, num_heads, scale, qk_int8,
                      quant=quantize_rows_reference, gemm=int8_gemm_reference)


# -------------------------------------------------------------- the chain

def _block_chain_int8(qb: QuantBlock, x: torch.Tensor, pad_mask,
                      num_heads: int, scale: float,
                      qk_int8: bool) -> torch.Tensor:
    """The launches of one int8 block on CUDA tensors."""
    B, N, d = x.shape
    H, Dh, M = num_heads, d // num_heads, B * N
    x2 = x.reshape(M, d)
    x8, sx = quantize_rows(x2)
    qkv_t, qkv_f, _, _ = int8_gemm(x8, sx, qb.wqkv, qb.sqkv, qb.bqkv,
                                   out_dtype=x.dtype, want_f32=qk_int8)
    attn = torch.empty((B, N, d), dtype=torch.float32, device=x.device)
    attn_heads = attn.view(B, N, H, Dh).transpose(1, 2)
    v = qkv_t.view(B, N, 3, H, Dh)[:, :, 2].transpose(1, 2)
    if qk_int8:
        # Q and K re-quantised per head from the f32 projections (V's rows
        # are quantised too and not read)
        c8, cs = quantize_rows(qkv_f.view(M * 3 * H, Dh))
        c8 = c8.view(B, N, 3, H, Dh)
        cs = cs.view(B, N, 3, H)
        masked_attention(c8[:, :, 0].transpose(1, 2),
                         c8[:, :, 1].transpose(1, 2), v, pad_mask, scale,
                         out=attn_heads,
                         qk_scales=(cs[:, :, 0].transpose(1, 2),
                                    cs[:, :, 1].transpose(1, 2)))
    else:
        heads = qkv_t.view(B, N, 3, H, Dh)
        masked_attention(heads[:, :, 0].transpose(1, 2),
                         heads[:, :, 1].transpose(1, 2), v, pad_mask, scale,
                         out=attn_heads)
    a8, sa = quantize_rows(attn.view(M, d))
    _, h1, h8, sh = int8_gemm(a8, sa, qb.wp, qb.sp, qb.bp, "residual_ln",
                              residual=x2, ln_g=qb.ln1_g, ln_b=qb.ln1_b,
                              want_f32=True, want_q=True)
    _, m1, _, _ = int8_gemm(h8, sh, qb.w1, qb.s1, qb.b1, "relu",
                            want_f32=True)
    m8, sm = quantize_rows(m1)
    out, _, _, _ = int8_gemm(m8, sm, qb.w2, qb.s2, qb.b2, "residual_ln",
                             residual=h1, ln_g=qb.ln2_g, ln_b=qb.ln2_b,
                             out_dtype=x.dtype)
    return out.view(B, N, d)


# ------------------------------------------------ the two TPU entry points

def _fused_block_int8(qb: QuantBlock, x, pad_mask, num_heads: int,
                      scale: float, qk_int8: bool) -> torch.Tensor:
    """Counterpart of ``vidsum_tpu/ops/block_kernel_int8.py::
    _block_kernel_int8`` (one batch element per program, N >= 512)."""
    if x.device.type == "cpu":
        return int8_block_reference(qb, x, pad_mask, num_heads, scale,
                                    qk_int8)
    out = _block_chain_int8(qb, x, pad_mask, num_heads, scale, qk_int8)
    _fused_block_int8.launches += 1
    return out


_fused_block_int8.launches = 0


def _fused_block_int8_grouped(qb: QuantBlock, x, pad_mask, num_heads: int,
                              scale: float, qk_int8: bool) -> torch.Tensor:
    """Counterpart of ``vidsum_tpu/ops/block_kernel_int8.py::
    _block_kernel_int8_grouped`` (G = 1024//N elements per program,
    N < 512)."""
    if x.device.type == "cpu":
        return int8_block_reference(qb, x, pad_mask, num_heads, scale,
                                    qk_int8)
    out = _block_chain_int8(qb, x, pad_mask, num_heads, scale, qk_int8)
    _fused_block_int8_grouped.launches += 1
    return out


_fused_block_int8_grouped.launches = 0


# ------------------------------------------------------ routing arithmetic
# The TPU kernels' VMEM arithmetic, copied so that a request takes the same
# route here as in the JAX package (ROADMAP Queue A retunes it for the H100).

_VMEM_BUDGET = 12 * 1024 * 1024


def _working_set_bytes(B: int, N: int, d: int, itm: int, tile_q: int) -> int:
    grp = _pick_group(B, N)
    if grp > 1:
        rows = grp * N
        return (rows * d * (itm + 1)            # x resident + x8
                + 3 * 4 * rows * d              # q/k f32 + v epilogue
                + 2 * rows * d                  # v bf16
                + 9 * d * d                     # int8 weights
                + 4 * rows * 4 * d + 4 * N * N)  # m1 f32 + score tile
    return (N * d * (itm + 1 + 1)               # x + x8 + k8
            + 4 * N * d + 2 * N * d             # k f32 transient + v bf16
            + 9 * d * d
            + 4 * tile_q * N + 4 * tile_q * 4 * d)


def fused_block_int8_supported(B: int, N: int, d: int,
                               itemsize: int = 2) -> bool:
    """True when :func:`fused_encoder_block_int8` admits this shape (callers
    leave quantisation for the lossless flash route past it)."""
    if N % 128 != 0:
        return False
    return _working_set_bytes(B, N, d, itemsize,
                              _pick_tile(N)) <= _VMEM_BUDGET


def fused_encoder_block_int8(qblock: QuantBlock, x: torch.Tensor, pad_mask,
                             num_heads: int, scale: float, tile_q: int = 0,
                             qk_int8: Optional[bool] = None) -> torch.Tensor:
    """Run one quantised post-LN encoder block (``qblock`` from
    :func:`vidsum_tpu_torch.ops.quant.quantize_block`) on x (B, N, d);
    pad_mask (B, N) bool or None; N a multiple of 128. ``qk_int8`` also runs
    Q.K^T on int8 (default: ``VIDSUM_TPU_INT8_QK``, read at call time)."""
    if qk_int8 is None:
        qk_int8 = qk_int8_default()
    B, N, d = x.shape
    if not tile_q:
        tile_q = _pick_tile(N)
    if N % tile_q != 0:
        raise ValueError(f"N={N} must be a multiple of {tile_q}")
    vmem = _working_set_bytes(B, N, d, x.element_size(), tile_q)
    if vmem > _VMEM_BUDGET:
        raise ValueError(
            f"int8 fused block working set ~{vmem >> 20} MB exceeds VMEM "
            f"at N={N}, d={d}; use the bf16 ladder for this shape")
    if pad_mask is None:
        pad_mask = torch.zeros((B, N), dtype=torch.bool, device=x.device)
    if _pick_group(B, N) > 1:
        return _fused_block_int8_grouped(qblock, x, pad_mask, num_heads,
                                         scale, qk_int8)
    return _fused_block_int8(qblock, x, pad_mask, num_heads, scale, qk_int8)

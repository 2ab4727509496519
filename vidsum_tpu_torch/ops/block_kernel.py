# ported from vidsum_tpu/ops/block_kernel.py
"""The fused post-LN encoder block of the inference path, as a chain of
hand-written CUDA kernels.

The JAX package runs a whole block in one Pallas program per batch element
(``_block_kernel``, N >= 512) or per group of G = 1024//N elements
(``_block_kernel_grouped``, N < 512), with x, K, V and every weight in
VMEM. One block's weights are ~1.6 MB in bf16 at d=256, far past an H100
SM's 227 KB of shared memory, so here the block is five launches:

    QKV   gemm_bias_epilogue(x, Wqkv)              d -> 3d, rounded to x's dtype
    attn  masked_attention(Q, K, V)                 straight from the QKV buffer
    proj  gemm_bias_epilogue(attn, Wp) + x -> LN1   h1 in f32 (and x's dtype)
    fc1   gemm_bias_epilogue(h1, W1) -> ReLU        m1 in x's dtype
    fc2   gemm_bias_epilogue(m1, W2) + h1 -> LN2    out in x's dtype

The rounding points are the TPU kernel's: q per head, K/V, P, attn before
proj, h1 before fc1, m1 before fc2; residuals and LayerNorms in f32.
Grouping has no counterpart on the GPU beyond the row count B*N of the
row-wise products, so both TPU kernels map onto the same chain; the two
entry points :func:`_fused_block` and :func:`_fused_block_grouped` and
``_pick_group`` stay so that routing and launch counts map one to one.

Each wrapper runs its kernels on CUDA tensors and its plain PyTorch version
on CPU tensors; a CUDA tensor never falls back. ``launches`` on a wrapper
counts its launches.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from vidsum_tpu_torch.ops import _cuda
from vidsum_tpu_torch.ops.attention import masked_attention

TILE_Q = 128
LN_EPS = 1e-5
EPILOGUES = {"none": 0, "relu": 1, "residual_ln": 2}


# ------------------------------------------------------ block weights

@dataclasses.dataclass(frozen=True)
class BlockWeights:
    """One block's weights as the kernels take them: matrices in nn.Linear's
    (out, in) layout and in the activation dtype, vectors in f32."""

    wqkv: torch.Tensor
    bqkv: torch.Tensor
    wp: torch.Tensor
    bp: torch.Tensor
    ln1_g: torch.Tensor
    ln1_b: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    ln2_g: torch.Tensor
    ln2_b: torch.Tensor


def cached(module: torch.nn.Module, name, make: Callable):
    """``make(module)``, cached on the module under ``name`` per parameter
    version, so a forward re-packs (or re-quantises) only after the weights
    change."""
    key = tuple((p.data_ptr(), p._version) for p in module.parameters())
    cache = module.__dict__.setdefault("_packed_weights", {})
    hit = cache.get(name)
    if hit is not None and hit[0] == key:
        return hit[1]
    value = make(module)
    cache[name] = (key, value)
    return value


def block_weights(block, dtype: torch.dtype) -> BlockWeights:
    """Pack a :class:`~vidsum_tpu_torch.models.simnet.EncoderBlock` for the
    kernels, cached per dtype (:func:`cached`)."""
    def pack(block):
        sa, mlp = block.sa, block.mlp
        mat = lambda t: t.detach().to(dtype).contiguous()  # noqa: E731
        vec = lambda t: t.detach().float().contiguous()    # noqa: E731
        with torch.no_grad():
            return BlockWeights(
                wqkv=mat(torch.cat([sa.q.weight, sa.k.weight, sa.v.weight])),
                bqkv=vec(torch.cat([sa.q.bias, sa.k.bias, sa.v.bias])),
                wp=mat(sa.feature_projection.weight),
                bp=vec(sa.feature_projection.bias),
                ln1_g=vec(block.norm1.weight), ln1_b=vec(block.norm1.bias),
                w1=mat(mlp.fc1.weight), b1=vec(mlp.fc1.bias),
                w2=mat(mlp.fc2.weight), b2=vec(mlp.fc2.bias),
                ln2_g=vec(block.norm2.weight), ln2_b=vec(block.norm2.bias))

    return cached(block, dtype, pack)


# ------------------------------------------------------------ plain versions

def _rows_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., N, K) @ (out, K)^T in f32, one product per leading index, so a
    row's result does not depend on what else is in the batch."""
    wt = w.float().t()
    if x.dim() == 2:
        return torch.matmul(x.float(), wt)
    return torch.stack([torch.matmul(xi.float(), wt) for xi in x.unbind(0)])


def _layernorm_f32(x, g, b):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * g + b


def gemm_bias_epilogue_reference(x, w, bias, epilogue: str = "none",
                                 residual=None, ln_g=None, ln_b=None,
                                 want_t: bool = True, want_f32: bool = False
                                 ) -> Tuple[Optional[torch.Tensor],
                                            Optional[torch.Tensor]]:
    """Plain version of :func:`gemm_bias_epilogue`."""
    y = _rows_matmul(x, w) + bias
    if epilogue == "relu":
        y = torch.relu(y)
    elif epilogue == "residual_ln":
        y = _layernorm_f32(y + residual.float(), ln_g, ln_b)
    elif epilogue != "none":
        raise ValueError(f"unknown epilogue {epilogue!r}")
    return (y.to(x.dtype) if want_t else None), (y if want_f32 else None)


def encoder_block_reference(w: BlockWeights, x: torch.Tensor, pad_mask,
                            num_heads: int, scale: float) -> torch.Tensor:
    """The post-LN block in plain PyTorch with the TPU kernel's rounding
    points (``block_kernel.py::_block_kernel``): f32 products of operands
    in x's dtype, the softmax normalised by a reciprocal multiply."""
    B, N, d = x.shape
    Dh = d // num_heads
    dt = x.dtype
    qkv = (_rows_matmul(x, w.wqkv) + w.bqkv).to(dt).float()
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(B, N, num_heads, Dh)
               .transpose(1, 2) for i in range(3))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if pad_mask is not None:
        s = s.masked_fill(pad_mask[:, None, None, :], float("-inf"))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    attn = torch.matmul(p.to(dt).float(), v)
    attn = attn.transpose(1, 2).reshape(B, N, d).to(dt)
    h1 = _layernorm_f32(_rows_matmul(attn, w.wp) + w.bp + x.float(),
                        w.ln1_g, w.ln1_b)
    m1 = torch.relu(_rows_matmul(h1.to(dt), w.w1) + w.b1).to(dt)
    out = _layernorm_f32(_rows_matmul(m1, w.w2) + w.b2 + h1,
                         w.ln2_g, w.ln2_b)
    return out.to(dt)


# -------------------------------------------------------------- the kernel
# The bf16 products run csrc/gemm_bias_epilogue.cu's wgmma kernel, whose
# operand ring TMA fills; what TMA cannot take goes to its mma.sync fallback.
# The f32 products run its FMA kernel on csrc/fma_gemm.cuh's mainloop (the
# training GEMM's), by 16-byte loads, or by scalar loads where those cannot
# take the operands; their LayerNorm rows always take the row kernel.

def gemm_takes_wgmma(x: torch.Tensor, w: torch.Tensor) -> bool:
    """True when the bf16 product ``x . w^T`` can take the wgmma kernel:
    TMA needs 16-byte aligned bases and row strides, so K and both row
    strides a multiple of 8 elements and both data pointers on a 16-byte
    boundary. Else it takes the ``mma.sync`` fallback."""
    return (x.dtype == torch.bfloat16 and x.shape[1] % 8 == 0
            and x.stride(0) % 8 == 0 and w.stride(0) % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def gemm_takes_vec4(x: torch.Tensor, w: torch.Tensor) -> bool:
    """True when the f32 product ``x . w^T`` can take the FMA kernel's
    16-byte loads: K and both row strides a multiple of 4 elements and both
    data pointers on a 16-byte boundary. Else it takes the same kernel's
    scalar loads (the same bits, slower), counted as a fallback."""
    return (x.dtype == torch.float32 and x.shape[1] % 4 == 0
            and x.stride(0) % 4 == 0 and w.stride(0) % 4 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def gemm_f32_tile(M: int, N: int, sms: int) -> int:
    """The f32 FMA kernel's square CTA tile: 128 (8 x 8 outputs a thread)
    where that grid gives at least three in four of the ``sms`` SMs a CTA,
    else 64 (4 x 4 a thread: four times the CTAs, for small grids such as
    (8, 256)'s d -> 3d and LayerNorm products). Every output is the same
    FMAs in the same k order in both, so a row's bits do not depend on the
    choice. The rule follows both tiles' device times at (32, 512) and
    (8, 256) (``chip_smoke.py``'s gemm lines)."""
    return 128 if 4 * -(-M // 128) * -(-N // 128) >= 3 * sms else 64


def gemm_tile_n(N: int) -> int:
    """Columns of a wgmma CTA tile: 128 for N <= 128, else 256, so that a
    LayerNorm row of up to 256 columns lies in one tile."""
    return 128 if N <= 128 else 256


def gemm_cta_rows(M: int, N: int, sms: int) -> int:
    """Rows of a wgmma CTA: 128 (two consumer warpgroups), or 64 (one) where
    the grid of 64-row CTAs needs fewer waves over the ``sms`` SMs than the
    128-row grid takes twice over (each SM holds one CTA of either shape,
    and a 128-row CTA does twice a 64-row one's work): small grids, such as
    (8, 256)'s products, and the tail of a wave. Both shapes run the same
    products per 64 rows, so a row's bits do not depend on the choice."""
    cols = -(-N // gemm_tile_n(N))
    waves128 = -(-(-(-M // 128) * cols) // sms)
    waves64 = -(-(-(-M // 64) * cols) // sms)
    return 64 if waves64 < 2 * waves128 else 128


def gemm_bias_epilogue(x, w, bias, epilogue: str = "none", residual=None,
                       ln_g=None, ln_b=None, want_t: bool = True,
                       want_f32: bool = False
                       ) -> Tuple[Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """``Y = X . W^T + b`` with an epilogue (``"none"``, ``"relu"`` or
    ``"residual_ln"``), launched as ``csrc/gemm_bias_epilogue.cu``.

    x (M, K) and w (N, K) in one dtype, each with a unit column stride (rows
    may be strided); bias (N,) f32; ``residual`` (M, N) in x's dtype or f32,
    with ``ln_g``/``ln_b`` (N,) f32, for ``"residual_ln"`` (past 256
    columns, and in f32 always, the kernel normalises an f32 buffer in a
    second launch: :func:`~vidsum_tpu_torch.ops._cuda.ln_rows_path`).
    Returns
    ``(y in x's dtype or None, y in f32 or None)`` as ``want_t`` /
    ``want_f32`` ask. bf16 takes the wgmma kernel where
    :func:`gemm_takes_wgmma` holds, in :func:`gemm_cta_rows` x
    :func:`gemm_tile_n` CTAs, else the ``mma.sync`` fallback; f32 the FMA
    kernel's 16-byte loads where :func:`gemm_takes_vec4` holds, else its
    scalar loads, in :func:`gemm_f32_tile` CTAs. Fallbacks are counted by
    ``gemm_bias_epilogue.fallback_launches`` (``launches`` counts every
    call). On CPU tensors this is :func:`gemm_bias_epilogue_reference`."""
    if x.device.type == "cpu":
        return gemm_bias_epilogue_reference(x, w, bias, epilogue, residual,
                                            ln_g, ln_b, want_t, want_f32)
    M, K = x.shape
    N = w.shape[0]
    if w.shape != (N, K) or w.dtype != x.dtype:
        raise ValueError(f"w must be ({N}, {K}) in {x.dtype}")
    if x.stride(1) != 1 or w.stride(1) != 1 or x.stride(0) < K \
            or w.stride(0) < K:
        raise ValueError("x and w must have contiguous rows")
    if bias.shape != (N,) or bias.dtype != torch.float32:
        raise ValueError("bias must be (N,) float32")
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    res_t = res_f = None
    if epilogue == "residual_ln":
        if residual.shape != (M, N) or not residual.is_contiguous():
            raise ValueError("residual must be a contiguous (M, N) tensor")
        if residual.dtype == torch.float32:
            res_f = residual
        elif residual.dtype == x.dtype:
            res_t = residual
        else:
            raise ValueError("residual must be float32 or x's dtype")
        for t in (ln_g, ln_b):
            if t.shape != (N,) or t.dtype != torch.float32:
                raise ValueError("ln_g and ln_b must be (N,) float32")
    f32 = x.dtype == torch.float32
    # a LayerNorm row the CTA does not hold (all in f32) needs the f32
    # buffer, asked for or not
    need_f = want_f32 or (epilogue == "residual_ln"
                          and _cuda.ln_rows_path(N, f32) != "tile")
    # in f32 the two outputs are one tensor, returned in both slots
    both = f32 and want_t and need_f
    out_t = torch.empty((M, N), dtype=x.dtype, device=x.device) \
        if want_t and not both else None
    out_f = torch.empty((M, N), dtype=torch.float32, device=x.device) \
        if need_f else None
    wgmma = gemm_takes_wgmma(x, w)
    cta_rows = gemm_cta_rows(M, N, _cuda.sm_count(x.device)) if wgmma else 0
    tile_n = (gemm_f32_tile(M, N, _cuda.sm_count(x.device)) if f32
              else gemm_tile_n(N))
    lib = _cuda.load("gemm_bias_epilogue")
    err = lib.vs_gemm_bias_epilogue(
        _cuda.ptr(x), _cuda.ptr(w), _cuda.ptr(bias), _cuda.ptr(res_t),
        _cuda.ptr(res_f), _cuda.ptr(ln_g), _cuda.ptr(ln_b), _cuda.ptr(out_t),
        _cuda.ptr(out_f), M, N, K, x.stride(0), w.stride(0),
        EPILOGUES[epilogue], _cuda.dtype_code(x), cta_rows, tile_n,
        LN_EPS, _cuda.stream_of(x))
    _cuda.check(lib, err, "gemm_bias_epilogue")
    gemm_bias_epilogue.launches += 1
    if not (gemm_takes_vec4(x, w) if f32 else wgmma):
        gemm_bias_epilogue.fallback_launches += 1
    return (out_f if both else out_t), (out_f if want_f32 else None)


gemm_bias_epilogue.launches = 0
gemm_bias_epilogue.fallback_launches = 0


def _block_chain(w: BlockWeights, x: torch.Tensor, pad_mask,
                 num_heads: int, scale: float) -> torch.Tensor:
    """The five launches of one block on CUDA tensors."""
    B, N, d = x.shape
    Dh = d // num_heads
    x2 = x.reshape(B * N, d)
    qkv, _ = gemm_bias_epilogue(x2, w.wqkv, w.bqkv, "none")
    heads = qkv.view(B, N, 3, num_heads, Dh)
    q, k, v = (heads[:, :, i].transpose(1, 2) for i in range(3))
    attn = torch.empty((B, N, d), dtype=x.dtype, device=x.device)
    masked_attention(q, k, v, pad_mask, scale,
                     out=attn.view(B, N, num_heads, Dh).transpose(1, 2))
    h1_t, h1_f = gemm_bias_epilogue(attn.view(B * N, d), w.wp, w.bp,
                                    "residual_ln", residual=x2,
                                    ln_g=w.ln1_g, ln_b=w.ln1_b,
                                    want_t=True, want_f32=True)
    m1, _ = gemm_bias_epilogue(h1_t, w.w1, w.b1, "relu")
    out, _ = gemm_bias_epilogue(m1, w.w2, w.b2, "residual_ln", residual=h1_f,
                                ln_g=w.ln2_g, ln_b=w.ln2_b)
    return out.view(B, N, d)


# ------------------------------------------------ the two TPU entry points

def _fused_block(w: BlockWeights, x, pad_mask, num_heads: int,
                 scale: float) -> torch.Tensor:
    """Counterpart of ``vidsum_tpu/ops/block_kernel.py::_block_kernel``
    (one batch element per program, N >= 512)."""
    if x.device.type == "cpu":
        return encoder_block_reference(w, x, pad_mask, num_heads, scale)
    out = _block_chain(w, x, pad_mask, num_heads, scale)
    _fused_block.launches += 1
    return out


_fused_block.launches = 0


def _fused_block_grouped(w: BlockWeights, x, pad_mask, num_heads: int,
                         scale: float) -> torch.Tensor:
    """Counterpart of ``vidsum_tpu/ops/block_kernel.py::
    _block_kernel_grouped`` (G = 1024//N elements per program, N < 512)."""
    if x.device.type == "cpu":
        return encoder_block_reference(w, x, pad_mask, num_heads, scale)
    out = _block_chain(w, x, pad_mask, num_heads, scale)
    _fused_block_grouped.launches += 1
    return out


_fused_block_grouped.launches = 0


# ------------------------------------------------------ routing arithmetic
# _pick_group, _pick_tile, _working_set_bytes and the 12 MB budget are the
# TPU kernels' VMEM arithmetic, copied so that a request takes the same
# route here as in the JAX package. A later PR retunes them after measuring
# on the H100.

def _pick_group(B: int, N: int) -> int:
    if N >= 512:
        return 1
    g = max(1, min(B, 1024 // N))
    while g > 1 and B % g:
        g -= 1
    return g


def _pick_tile(N: int) -> int:
    cap = 512 if N <= 1024 else (256 if N <= 2048 else 128)
    for tile in (cap, 256, 128):
        if tile <= cap and N % tile == 0:
            return tile
    return TILE_Q


_VMEM_BUDGET = 12 * 1024 * 1024


def _working_set_bytes(B: int, N: int, d: int, itm: int, tile_q: int) -> int:
    grp = _pick_group(B, N)
    if grp > 1:
        rows = grp * N
        return (3 * rows * d * itm + 9 * d * d * itm
                + 4 * rows * d * 2 + 4 * rows * 4 * d + 4 * N * N)
    return (3 * N * d * itm + 9 * d * d * itm
            + 4 * tile_q * N + 4 * tile_q * 4 * d)


def fused_block_supported(B: int, N: int, d: int, itemsize: int = 4) -> bool:
    """True when :func:`fused_encoder_block` admits this shape (callers
    demote to the flash-attention route past it)."""
    if N % 128 != 0:
        return False
    return _working_set_bytes(B, N, d, itemsize,
                              _pick_tile(N)) <= _VMEM_BUDGET


def fused_encoder_block(block, x: torch.Tensor, pad_mask, num_heads: int,
                        scale: float) -> torch.Tensor:
    """Run one post-LN ``EncoderBlock`` on x (B, N, d); pad_mask (B, N) bool
    or None. N must be a multiple of 128."""
    B, N, d = x.shape
    tile_q = _pick_tile(N)
    if N % tile_q != 0:
        raise ValueError(f"N={N} must be a multiple of {tile_q}")
    ws = _working_set_bytes(B, N, d, x.element_size(), tile_q)
    if ws > _VMEM_BUDGET:
        raise ValueError(
            f"fused block working set ~{ws >> 20} MB is past the envelope at "
            f"N={N}, d={d}; use attn_impl='flash' for this shape")
    if pad_mask is None:
        pad_mask = torch.zeros((B, N), dtype=torch.bool, device=x.device)
    w = block_weights(block, x.dtype)
    if _pick_group(B, N) > 1:
        return _fused_block_grouped(w, x, pad_mask, num_heads, scale)
    return _fused_block(w, x, pad_mask, num_heads, scale)

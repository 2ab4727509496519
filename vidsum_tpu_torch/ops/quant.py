# ported from vidsum_tpu/ops/quant.py
"""The opt-in W8A8 int8 scoring scheme, its primitives and the dense int8
encoder block.

Scheme (the JAX package's, bit for bit; symmetric, no zero point):

- **Weights**: per output channel, ``s = absmax / 127`` over the channel's
  inputs. The JAX package keeps weights as (K, M) and reduces over axis 0;
  here they keep nn.Linear's (out, in) layout, so the absmax runs over dim 1
  and the codes are the JAX codes transposed.
- **Activations**: per row at each product's input, ``s = absmax / 127``
  over the row in f32, 1.0 for an all-zero row; codes
  ``clip(round(x * (1 / s)), -127, 127)``: a reciprocal, then a multiply,
  rounding half to even.
- **Products**: int8 x int8 summed exactly, dequantised by ``acc * (sx *
  sw)``, then the f32 bias added.
- **Attention**: Q.K^T in x's dtype (or int8 per head with ``qk_int8``),
  softmax in f32 normalised by a reciprocal multiply, P.V with P and V in
  x's dtype; LayerNorms and residuals in f32.

The path is lossy, opt-in (``attn_impl="int8_block"`` / ``"int8_dense"``)
and inference only. Every function here takes tensors on any device: on CPU
tensors the plain PyTorch versions run (integer products summed exactly in
f64: K * 127^2 < 2^53; f32 is not exact past 2^24, which K = 1,024 reaches),
on CUDA tensors :func:`quantize_rows` and :func:`int8_gemm` launch
``csrc/int8_gemm.cu`` and count their launches.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

from vidsum_tpu_torch.ops import _cuda
from vidsum_tpu_torch.ops.attention import attention_q8_reference

LN_EPS = 1e-5
EPILOGUES = {"none": 0, "relu": 1, "residual_ln": 2, "shift": 3}


def qk_int8_default() -> bool:
    """The ``qk_int8`` default: the environment variable
    ``VIDSUM_TPU_INT8_QK`` (``"1"`` = on), read at call time, as the JAX
    package reads it at trace time, so one setting steers both packages."""
    return os.environ.get("VIDSUM_TPU_INT8_QK", "0") == "1"


# ------------------------------------------------------------ plain versions

def quantize_rows_reference(x: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 along the last dim: ``(codes int8,
    scale f32 (..., 1))``. Divisions are tensor by tensor, so they are IEEE
    divisions on the CPU and on the card alike."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0.0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    q = torch.round(xf * torch.reciprocal(scale)).clamp(-127.0, 127.0)
    return q.to(torch.int8), scale


def _i8mm(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (N, K)^T int8, summed exactly (in f64), as f32."""
    return torch.matmul(a8.double(), w8.double().t()).float()


def _layernorm_f32(x, g, b):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * g + b


def int8_gemm_reference(xq, sx, wq, sw, bias, epilogue: str = "none",
                        residual=None, ln_g=None, ln_b=None,
                        out_dtype: Optional[torch.dtype] = None,
                        want_f32: bool = False, want_q: bool = False):
    """Plain version of :func:`int8_gemm`."""
    if epilogue == "shift":
        acc = torch.matmul(xq.double(), wq.double().t()).to(torch.int64)
        return (acc >> 8).to(torch.int32).to(torch.int8)
    y = _i8mm(xq, wq) * (sx.reshape(-1, 1) * sw) + bias
    if epilogue == "relu":
        y = torch.relu(y)
    elif epilogue == "residual_ln":
        y = _layernorm_f32(y + residual.float(), ln_g, ln_b)
    elif epilogue != "none":
        raise ValueError(f"unknown epilogue {epilogue!r}")
    q = s = None
    if want_q:
        q, s = quantize_rows_reference(y)
        s = s[:, 0]
    return (None if out_dtype is None else y.to(out_dtype),
            y if want_f32 else None, q, s)


# ------------------------------------------------------------- the kernels

def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 codes and scales ``(q int8 like x, scale f32 (..., 1))``
    of x (f32 or bf16). CUDA tensors launch ``vs_quantize_rows``
    (``csrc/int8_gemm.cu``); CPU tensors run
    :func:`quantize_rows_reference`."""
    if x.device.type == "cpu":
        return quantize_rows_reference(x)
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    M = x2.shape[0]
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s = torch.empty((M,), dtype=torch.float32, device=x.device)
    lib = _cuda.load("int8_gemm")
    err = lib.vs_quantize_rows(_cuda.ptr(x2), _cuda.ptr(q), _cuda.ptr(s), M,
                               K, _cuda.dtype_code(x2), _cuda.stream_of(x2))
    _cuda.check(lib, err, "quantize_rows")
    quantize_rows.launches += 1
    return q.view(x.shape), s.view(*x.shape[:-1], 1)


quantize_rows.launches = 0


def int8_gemm(xq, sx, wq, sw, bias, epilogue: str = "none", residual=None,
              ln_g=None, ln_b=None, out_dtype: Optional[torch.dtype] = None,
              want_f32: bool = False, want_q: bool = False):
    """``Y = dequant(Xq . Wq^T) + b`` with an epilogue, launched as
    ``vs_int8_gemm`` (``csrc/int8_gemm.cu``, int8 tensor cores).

    xq (M, K) and wq (N, K) int8, K % 32 == 0; sx (M,) or (M, 1) and sw (N,)
    f32 scales; bias (N,) f32. ``epilogue``: ``"none"``, ``"relu"``,
    ``"residual_ln"`` (``residual`` (M, N) in f32 or ``out_dtype``, with
    ``ln_g``/``ln_b`` (N,) f32; N <= 256) or ``"shift"`` (returns the int8
    ``(acc >> 8)``, the probe's epilogue; the scales and bias are not read).
    Returns ``(y in out_dtype or None, y f32 or None, codes or None,
    scales (M,) or None)``: ``want_q`` asks for the int8 codes of the
    residual + LayerNorm output, for the next product. On CPU tensors this
    is :func:`int8_gemm_reference`."""
    if xq.device.type == "cpu":
        return int8_gemm_reference(xq, sx, wq, sw, bias, epilogue, residual,
                                   ln_g, ln_b, out_dtype, want_f32, want_q)
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    M, K = xq.shape
    N = wq.shape[0]
    if (xq.dtype != torch.int8 or wq.dtype != torch.int8
            or wq.shape != (N, K)):
        raise ValueError(f"xq (M, K) and wq ({N}, {K}) must be int8")
    if not (xq.is_contiguous() and wq.is_contiguous()):
        raise ValueError("xq and wq must be contiguous")
    if K % 32:
        raise ValueError(f"the int8 GEMM takes K % 32 == 0, got K={K}")
    dev = xq.device
    if epilogue == "shift":
        out = torch.empty((M, N), dtype=torch.int8, device=dev)
        lib = _cuda.load("int8_gemm")
        err = lib.vs_int8_gemm(
            _cuda.ptr(xq), None, _cuda.ptr(wq), None, None, None, None, None,
            None, None, None, _cuda.ptr(out), None, M, N, K,
            EPILOGUES[epilogue], 0, LN_EPS, _cuda.stream_of(xq))
        _cuda.check(lib, err, "int8_gemm")
        int8_gemm.launches += 1
        return out
    sx = sx.reshape(M)
    for name, t, n in (("sx", sx, M), ("sw", sw, N), ("bias", bias, N)):
        if t.shape != (n,) or t.dtype != torch.float32 or not \
                t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({n},) float32")
    # the dtype of out_t and of a non-f32 residual
    dtype = out_dtype or (residual.dtype if residual is not None
                          else torch.float32)
    res_t = res_f = None
    if epilogue == "residual_ln":
        if N > 256:
            raise ValueError("the residual+LayerNorm epilogue takes N <= 256 "
                             "(d_model of the repo's configurations)")
        if residual.shape != (M, N) or not residual.is_contiguous():
            raise ValueError("residual must be a contiguous (M, N) tensor")
        if residual.dtype == torch.float32:
            res_f = residual
        elif residual.dtype == dtype:
            res_t = residual
        else:
            raise ValueError("residual must be float32 or out_dtype "
                             "(when out_dtype is given)")
        for t in (ln_g, ln_b):
            if t.shape != (N,) or t.dtype != torch.float32:
                raise ValueError("ln_g and ln_b must be (N,) float32")
    elif want_q:
        raise ValueError("want_q needs the residual_ln epilogue")
    both = out_dtype == torch.float32 and want_f32
    out_t = (torch.empty((M, N), dtype=dtype, device=dev)
             if out_dtype is not None and not both else None)
    out_f = (torch.empty((M, N), dtype=torch.float32, device=dev)
             if want_f32 else None)
    out_q = torch.empty((M, N), dtype=torch.int8, device=dev) \
        if want_q else None
    out_s = torch.empty((M,), dtype=torch.float32, device=dev) \
        if want_q else None
    lib = _cuda.load("int8_gemm")
    err = lib.vs_int8_gemm(
        _cuda.ptr(xq), _cuda.ptr(sx), _cuda.ptr(wq), _cuda.ptr(sw),
        _cuda.ptr(bias), _cuda.ptr(res_t), _cuda.ptr(res_f), _cuda.ptr(ln_g),
        _cuda.ptr(ln_b), _cuda.ptr(out_t), _cuda.ptr(out_f), _cuda.ptr(out_q),
        _cuda.ptr(out_s), M, N, K, EPILOGUES[epilogue],
        _cuda.DTYPE_CODES[str(dtype).replace("torch.", "")], LN_EPS,
        _cuda.stream_of(xq))
    _cuda.check(lib, err, "int8_gemm")
    int8_gemm.launches += 1
    return (out_f if both else out_t), out_f, out_q, out_s


int8_gemm.launches = 0


# ------------------------------------------------------------ the scheme

def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an nn.Linear weight (out, in):
    ``(wq int8 (out, in), scale f32 (out,))``, the JAX package's
    ``quantize_weight`` of the (in, out) weight, transposed."""
    wq, s = quantize_rows_reference(w.detach())
    return wq, s[:, 0]


def int8_linear(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                b: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ dequant(wq)^T + b`` in f32, the product on int8 (the JAX
    ``int8_linear``). x (..., K) in any float dtype; wq (M, K) int8."""
    shape = x.shape[:-1]
    xq, sx = quantize_rows(x.reshape(-1, x.shape[-1]))
    if b is None:
        b = torch.zeros(wq.shape[0], dtype=torch.float32, device=x.device)
    _, y, _, _ = int8_gemm(xq, sx, wq, sw, b.float().contiguous(),
                           want_f32=True)
    return y.view(*shape, wq.shape[0])


@dataclasses.dataclass(frozen=True)
class QuantBlock:
    """One encoder block's six products quantised (Q, K and V as one (3d, d)
    product: per-channel codes do not depend on their neighbours), biases
    and LayerNorm parameters in f32."""

    wqkv: torch.Tensor
    sqkv: torch.Tensor
    bqkv: torch.Tensor
    wp: torch.Tensor
    sp: torch.Tensor
    bp: torch.Tensor
    ln1_g: torch.Tensor
    ln1_b: torch.Tensor
    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    ln2_g: torch.Tensor
    ln2_b: torch.Tensor


def quantize_block(block) -> QuantBlock:
    """Quantise one :class:`~vidsum_tpu_torch.models.simnet.EncoderBlock`'s
    six matmul weights (the JAX ``quantize_block``)."""
    sa, mlp = block.sa, block.mlp
    vec = lambda t: t.detach().float().contiguous()  # noqa: E731
    with torch.no_grad():
        wqkv, sqkv = quantize_weight(torch.cat(
            [sa.q.weight, sa.k.weight, sa.v.weight]))
        wp, sp = quantize_weight(sa.feature_projection.weight)
        w1, s1 = quantize_weight(mlp.fc1.weight)
        w2, s2 = quantize_weight(mlp.fc2.weight)
        return QuantBlock(
            wqkv=wqkv.contiguous(), sqkv=sqkv.contiguous(),
            bqkv=vec(torch.cat([sa.q.bias, sa.k.bias, sa.v.bias])),
            wp=wp.contiguous(), sp=sp.contiguous(),
            bp=vec(sa.feature_projection.bias),
            ln1_g=vec(block.norm1.weight), ln1_b=vec(block.norm1.bias),
            w1=w1.contiguous(), s1=s1.contiguous(), b1=vec(mlp.fc1.bias),
            w2=w2.contiguous(), s2=s2.contiguous(), b2=vec(mlp.fc2.bias),
            ln2_g=vec(block.norm2.weight), ln2_b=vec(block.norm2.bias))


def int8_block(qb: QuantBlock, x: torch.Tensor, pad_mask, num_heads: int,
               scale: float, qk_int8: bool, quant=quantize_rows,
               gemm=int8_gemm) -> torch.Tensor:
    """The quantised post-LN block (``int8_encoder_block_xla``) with its
    row quantizer and int8 product given: the kernels' wrappers, or their
    plain versions (the plain version of TPU kernels 13/14). x (B, N, d);
    returns x's dtype."""
    B, N, d = x.shape
    H, Dh, M = num_heads, d // num_heads, B * N
    dt = x.dtype
    x2 = x.reshape(M, d)
    # one row quantization of x feeds all three of Q/K/V
    xq, sx = quant(x2)
    _, qkv, _, _ = gemm(xq, sx, qb.wqkv, qb.sqkv, qb.bqkv, want_f32=True)
    heads = qkv.view(B, N, 3, H, Dh).permute(2, 0, 3, 1, 4)  # 3, B, H, N, Dh
    q, k, v = heads[0], heads[1], heads[2].to(dt)
    if qk_int8:
        q8, sq = quant(q)
        k8, sk = quant(k)
        attn = attention_q8_reference(q8, k8, v, sq[..., 0], sk[..., 0],
                                      pad_mask, scale, torch.float32)
    else:
        s = torch.matmul(q.to(dt).float(),
                         k.to(dt).float().transpose(-1, -2)) * scale
        if pad_mask is not None:
            s = s.masked_fill(pad_mask[:, None, None, :], float("-inf"))
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e * (1.0 / e.sum(dim=-1, keepdim=True))
        attn = torch.matmul(p.to(dt).float(), v.float())
    attn = attn.transpose(1, 2).reshape(M, d)
    aq, sa = quant(attn)
    _, h1, hq, sh = gemm(aq, sa, qb.wp, qb.sp, qb.bp, "residual_ln",
                         residual=x2, ln_g=qb.ln1_g, ln_b=qb.ln1_b,
                         want_f32=True, want_q=True)
    _, m1, _, _ = gemm(hq, sh, qb.w1, qb.s1, qb.b1, "relu", want_f32=True)
    mq, sm = quant(m1)
    out, _, _, _ = gemm(mq, sm, qb.w2, qb.s2, qb.b2, "residual_ln",
                        residual=h1, ln_g=qb.ln2_g, ln_b=qb.ln2_b,
                        out_dtype=dt)
    return out.view(B, N, d)


def int8_encoder_block_dense(qb: QuantBlock, x: torch.Tensor, pad_mask,
                             num_heads: int, scale: float,
                             qk_int8: Optional[bool] = None) -> torch.Tensor:
    """The dense int8 route (``int8_encoder_block_xla``): on CUDA the row
    quantizer and the six products launch ``csrc/int8_gemm.cu`` and the
    attention is plain PyTorch (the integer Q.K^T dot exact in f64), as XLA
    runs the JAX one. x (B, N, d) float; returns x's dtype."""
    if qk_int8 is None:
        qk_int8 = qk_int8_default()
    return int8_block(qb, x, pad_mask, num_heads, scale, qk_int8)

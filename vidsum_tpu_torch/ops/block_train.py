# ported from vidsum_tpu/ops/block_train.py
"""The trainable post-LN encoder block: forward and recompute backward as a
chain of hand-written CUDA kernels, with the JAX package's counter-hash
dropout bit for bit.

The JAX package runs the whole block in one Pallas program per batch element
(``_fwd_kernel`` / ``_bwd_kernel``, N >= 512) or per group of G = 1024//N
elements (``_fwd_kernel_grouped`` / ``_bwd_kernel_grouped``, N < 512); the
backward recomputes the forward from x (no activation is stored) and
accumulates the 16 parameter grads across its sequential grid. Here both
pairs map onto one chain of f32 kernels in ``csrc/block_train.cu`` (its
attention from ``csrc/attention_core.cuh``, shared with
``ops/attention_train.py``), because the dropout bits (:func:`_hash_keep`)
depend only on absolute coordinates (seed, site, batch index, row, column),
not on how elements are grouped:

    forward   QKV GEMM -> attention (hash dropout on P, site = head) ->
              proj GEMM -> drop(32) + x, LN1 -> fc1 GEMM, ReLU, drop(33) ->
              fc2 GEMM -> drop(34) + h1, LN2
    backward  the forward again, keeping its f32 intermediates; LN2 bwd;
              dWf2, da1 (drop 33, ReLU'), dWf1, dh1; LN1 bwd; dWp, dattn;
              attention bwd (D = rowsum(dO o O), dQ per query tile, dK/dV per
              key tile); dWqkv, dx. dW products are X^T . dY over all B*N
              rows with split-K partials summed in a fixed order, and the
              bias/LN grads are deterministic column sums: no atomics, so two
              backward runs give identical bits.

Every product is exact f32 (the TPU kernels pin f32 operands,
``block_train.py:195``): bf16 x and cotangents are widened on entry and the
outputs rounded to x's dtype on exit.

The four TPU entry points keep their names and a launch counter each; on CPU
tensors they run the plain version (:func:`block_reference_with_masks`, and
autograd of it for the backward), on CUDA tensors the kernel chain, never a
fallback. :func:`fused_block_train` is the ``torch.autograd.Function`` a
model calls; it packs the block's weights with ``torch.cat`` inside the
autograd graph, so the grads of the packed matrices reach each parameter.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vidsum_tpu_torch.ops import _cuda
from vidsum_tpu_torch.ops.attention import attention_layout_ok
from vidsum_tpu_torch.ops.block_kernel import (
    _layernorm_f32, _pick_group, _pick_tile,
)

TILE = 128
LN_EPS = 1e-5

# dropout sites: head h hashes with site h; the others start at 32
S_ATTN, S_RES1, S_MLP, S_RES2 = 0, 32, 33, 34
MAX_HASH_HEADS = 32

# the 16 parameters of a block, in the JAX package's flat order
PARAM_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp",
               "ln1s", "ln1b", "wf1", "bf1", "wf2", "bf2", "ln2s", "ln2b")

_M32 = 0xFFFFFFFF


class TrainWeights(NamedTuple):
    """A block's weights as the chain takes them, all f32: matrices in
    nn.Linear's (out, in) layout, Q/K/V packed into one (3d, d) matrix."""

    wqkv: torch.Tensor
    bqkv: torch.Tensor
    wp: torch.Tensor
    bp: torch.Tensor
    ln1s: torch.Tensor
    ln1b: torch.Tensor
    wf1: torch.Tensor
    bf1: torch.Tensor
    wf2: torch.Tensor
    bf2: torch.Tensor
    ln2s: torch.Tensor
    ln2b: torch.Tensor


def train_weights(block) -> TrainWeights:
    """Pack an ``EncoderBlock`` inside the autograd graph (unlike the
    inference cache ``block_kernel.block_weights``, which detaches)."""
    sa, mlp = block.sa, block.mlp
    return TrainWeights(
        torch.cat([sa.q.weight, sa.k.weight, sa.v.weight]).float(),
        torch.cat([sa.q.bias, sa.k.bias, sa.v.bias]).float(),
        sa.feature_projection.weight.float(),
        sa.feature_projection.bias.float(),
        block.norm1.weight.float(), block.norm1.bias.float(),
        mlp.fc1.weight.float(), mlp.fc1.bias.float(),
        mlp.fc2.weight.float(), mlp.fc2.bias.float(),
        block.norm2.weight.float(), block.norm2.bias.float())


# ------------------------------------------------------------ dropout bits

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): the product is split in
    16-bit halves of c so that no intermediate leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _keep_bits(seed: int, site, b, rows, cols, rate: float) -> torch.Tensor:
    """Keep mask of ``_hash_keep`` over broadcast int64 tensors of site,
    absolute batch index, row and column. torch has no uint32 ``>>`` or
    ``>=`` on the CPU, so the uint32 arithmetic runs in int64 masked to 32
    bits."""
    base = (((int(seed) * 0x9E3779B1) & _M32)
            + _mul32(site * 131071 + 17, 0x85EBCA77)
            + _mul32(b + 1, 0x27220A95)) & _M32
    return _fmix_keep(base ^ _mul32(rows, 0xC2B2AE3D)
                      ^ _mul32(cols, 0x27D4EB2F), rate)


def _fmix_keep(x: torch.Tensor, rate: float) -> torch.Tensor:
    """The murmur-style finalizer and threshold every hash family of the
    JAX package shares (``parallel/ring_attention.py::_fmix_keep``), on
    int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= _threshold(rate)


def _threshold(rate: float) -> int:
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def _keep_scale(rate: float) -> float:
    """1 / (1 - rate) rounded to f32, as JAX's weak-typed constant is."""
    return float(np.float32(1.0 / (1.0 - rate))) if rate > 0.0 else 1.0


def _hash_keep(seed: int, site: int, b: int, row0: int, shape,
               rate: float) -> torch.Tensor:
    """Keep mask for a (T, C) tile whose rows start at ``row0``, equal bit
    for bit to ``vidsum_tpu/ops/block_train.py::_hash_keep``."""
    T, C = shape
    rows = torch.arange(T, dtype=torch.int64) + row0
    cols = torch.arange(C, dtype=torch.int64)
    return _keep_bits(seed, torch.tensor(site), torch.tensor(b),
                      rows[:, None], cols[None, :], rate)


def _drop(x, keep, rate: float):
    return torch.where(keep, x * _keep_scale(rate), 0.0) if rate > 0.0 else x


# ---------------------------------------------------------- plain version

def block_reference_with_masks(x, w: TrainWeights, pad_mask, seed: int,
                               num_heads: int, scale: float, rate: float):
    """The block in plain PyTorch with the identical hash masks, f32
    products, output in x's dtype (``block_train.py::
    block_reference_with_masks``). ``pad_mask`` (B, N) bool, True at padded
    keys."""
    B, N, d = x.shape
    H, Dh = num_heads, d // num_heads
    dev = x.device
    xf = x.float()
    bi = torch.arange(B, dtype=torch.int64, device=dev)
    ni = torch.arange(N, dtype=torch.int64, device=dev)

    def keep(site, cols):
        ci = torch.arange(cols, dtype=torch.int64, device=dev)
        return _keep_bits(seed, torch.as_tensor(site, device=dev),
                          bi[:, None, None], ni[None, :, None],
                          ci[None, None, :], rate)

    qkv = torch.matmul(xf, w.wqkv.t()) + w.bqkv
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(B, N, H, Dh)
               .transpose(1, 2) for i in range(3))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    s = s.masked_fill(pad_mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    heads = torch.arange(H, dtype=torch.int64, device=dev)
    keep_attn = _keep_bits(seed, S_ATTN * 8 + heads[None, :, None, None],
                           bi[:, None, None, None], ni[None, None, :, None],
                           ni[None, None, None, :], rate)
    attn = torch.matmul(_drop(p, keep_attn, rate), v)
    attn = attn.transpose(1, 2).reshape(B, N, d)
    proj = torch.matmul(attn, w.wp.t()) + w.bp
    h1 = _layernorm_f32(_drop(proj, keep(S_RES1, d), rate) + xf, w.ln1s,
                        w.ln1b)
    a1 = torch.matmul(h1, w.wf1.t()) + w.bf1
    m1d = _drop(torch.relu(a1), keep(S_MLP, a1.shape[-1]), rate)
    m2 = torch.matmul(m1d, w.wf2.t()) + w.bf2
    out = _layernorm_f32(_drop(m2, keep(S_RES2, d), rate) + h1, w.ln2s,
                         w.ln2b)
    return out.to(x.dtype)


def block_reference_backward(x, w: TrainWeights, pad_mask, seed: int, do,
                             num_heads: int, scale: float, rate: float
                             ) -> Tuple[torch.Tensor, TrainWeights]:
    """Autograd of :func:`block_reference_with_masks`: (dx in x's dtype,
    grads of the packed weights). ``do`` is rounded to x's dtype first, as
    the JAX VJP does."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_()
        ws = TrainWeights(*(t.detach().requires_grad_() for t in w))
        out = block_reference_with_masks(xs, ws, pad_mask, seed, num_heads,
                                         scale, rate)
        grads = torch.autograd.grad(out, (xs, *ws), do.to(out.dtype))
    return grads[0], TrainWeights(*grads[1:])


# ----------------------------------------------------- the kernel launches

class _Drop(NamedTuple):
    seed: int
    rows: int     # N: row m of a (B*N, .) tensor is (m // N, m % N)
    thr: int
    kscale: float


GEMM_TILE = 128   # bt_gemm's CTA tile is GEMM_TILE x GEMM_TILE


def gemm_splits(M: int, N: int, K: int, sms: int) -> int:
    """K splits of a plain-epilogue ``bt_gemm``: a grid of fewer tiles than
    ``sms`` is split as far as one wave of 2 CTAs an SM holds (the kernel's
    launch bounds keep two on each; a split that spills into a second wave
    measured slower than both half and twice it), each split at least 256
    deep. At (32, 512), d 256 the forward's and the dX products' grids fill
    the card unsplit; the dW products over K = 16,384 rows split 16 (d x 4d,
    4d x d), 64 (d x d) and 22 (3d x d) ways."""
    tiles = -(-M // GEMM_TILE) * -(-N // GEMM_TILE)
    if tiles >= sms:
        return 1
    return max(1, min(2 * sms // tiles, K // 256))


def _gemm(a, b, *, ta=False, tb=False, bias=None, addend=None,
          epilogue="bias", dr: Optional[_Drop] = None, site: int = 0,
          aux=None, keep_pre=False, splits: Optional[int] = None):
    """``op(a) . op(b)`` (op = transpose where ``ta``/``tb``) for contiguous
    2-D f32 tensors, with an epilogue: ``"bias"`` (+ bias, + addend),
    ``"relu_drop"`` (+ bias, ReLU, the site's dropout; with ``keep_pre`` also
    returns the pre-ReLU values) or ``"drop_relu_bwd"`` (the site's dropout,
    then zero where ``aux`` <= 0). Products with few output tiles and a long
    k split it (:func:`gemm_splits`, or ``splits`` where given), with
    partials summed in a fixed order."""
    M, K = (a.shape[1], a.shape[0]) if ta else a.shape
    N = b.shape[0] if tb else b.shape[1]
    if (b.shape[1] if tb else b.shape[0]) != K:
        raise ValueError(f"inner dims differ: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    sam, sak = (1, M) if ta else (K, 1)
    sbk, sbn = (1, K) if tb else (N, 1)
    code = {"bias": 0, "relu_drop": 1, "drop_relu_bwd": 2}[epilogue]
    if splits is None:
        splits = (gemm_splits(M, N, K, _cuda.sm_count(a.device))
                  if code == 0 else 1)
    c = torch.empty((M, N), dtype=torch.float32, device=a.device)
    pre = torch.empty_like(c) if keep_pre else None
    partial = (torch.empty((splits, M, N), dtype=torch.float32,
                           device=a.device) if splits > 1 else None)
    dr = dr or _Drop(0, 1, 0, 1.0)
    lib = _cuda.load("block_train")
    err = lib.vs_bt_gemm(
        _cuda.ptr(a), _cuda.ptr(b), _cuda.ptr(bias), _cuda.ptr(addend),
        _cuda.ptr(aux), _cuda.ptr(c), _cuda.ptr(pre), _cuda.ptr(partial),
        M, N, K, sam, sak, sbk, sbn, code, splits, dr.seed, site, dr.rows,
        dr.thr, dr.kscale, _cuda.stream_of(a))
    _cuda.check(lib, err, "block_train gemm")
    _gemm.launches += 1
    return (c, pre) if keep_pre else c


_gemm.launches = 0


def _drop_res_ln(p, resid, g, beta, site: int, dr: _Drop, keep: bool):
    M, d = p.shape
    out = torch.empty_like(p)
    xhat = torch.empty_like(p) if keep else None
    inv = torch.empty((M,), dtype=torch.float32, device=p.device) \
        if keep else None
    lib = _cuda.load("block_train")
    err = lib.vs_bt_drop_res_ln(
        _cuda.ptr(p), _cuda.ptr(resid), _cuda.ptr(g), _cuda.ptr(beta),
        _cuda.ptr(out), _cuda.ptr(xhat), _cuda.ptr(inv), M, d, dr.rows,
        dr.seed, site, dr.thr, dr.kscale, LN_EPS, _cuda.stream_of(p))
    _cuda.check(lib, err, "block_train drop_res_ln")
    return out, xhat, inv


def _ln_bwd_drop(dy, xhat, inv, g, site: int, dr: _Drop):
    M, d = dy.shape
    dz, dmask = torch.empty_like(dy), torch.empty_like(dy)
    lib = _cuda.load("block_train")
    err = lib.vs_bt_ln_bwd_drop(
        _cuda.ptr(dy), _cuda.ptr(xhat), _cuda.ptr(inv), _cuda.ptr(g),
        _cuda.ptr(dz), _cuda.ptr(dmask), M, d, dr.rows, dr.seed, site,
        dr.thr, dr.kscale, _cuda.stream_of(dy))
    _cuda.check(lib, err, "block_train ln_bwd_drop")
    return dz, dmask


def _colsum(a, b=None):
    """(sum of a's rows, sum of a*b's rows or None), in a fixed order."""
    M, C = a.shape
    chunks = -(-M // 256)
    partial = torch.empty((2, chunks, C), dtype=torch.float32,
                          device=a.device)
    s = torch.empty((C,), dtype=torch.float32, device=a.device)
    sp = torch.empty_like(s) if b is not None else None
    lib = _cuda.load("block_train")
    err = lib.vs_bt_colsum(_cuda.ptr(a), _cuda.ptr(b), _cuda.ptr(partial),
                           _cuda.ptr(s), _cuda.ptr(sp), M, C,
                           _cuda.stream_of(a))
    _cuda.check(lib, err, "block_train colsum")
    return s, sp


def _check_attention_operands(rows: dict, *others) -> None:
    """The attention kernels read each ``rows`` tensor as (B*N, width) rows
    at row stride ``width`` (the fused QKV buffer, o and its cotangent) and
    the others (mask, lse) as contiguous: raise on any other layout or on
    one that fails :func:`attention_layout_ok`; the kernels' outputs are
    allocated here in that layout."""
    for name, (t, width) in rows.items():
        if t.dim() != 2 or t.shape[1] != width or t.stride() != (width, 1):
            raise ValueError(f"{name} must be a ({t.shape[0]}, {width}) "
                             f"row-major buffer, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if not all(t.is_contiguous() for t in others) or not attention_layout_ok(
            *(t for t, _ in rows.values()), *others):
        raise ValueError("the f32 attention kernels stage 16-byte chunks: "
                         "every operand must start on a 16-byte boundary "
                         "with strides a multiple of 4 elements")


def _pad_heads(t, heads: int, Dh: int, Dp: int):
    """(rows, heads * Dh) row-major buffer -> (rows, heads * Dp) with each
    head's columns zero-padded to Dp (``t`` itself where Dp == Dh)."""
    if Dp == Dh:
        return t
    return _cuda.pad_head_dim(t.view(t.shape[0], heads, Dh), Dp).view(
        t.shape[0], heads * Dp)


def _unpad_heads(t, heads: int, Dh: int, Dp: int):
    """The inverse of :func:`_pad_heads`: each head's first Dh columns, as
    a new contiguous (rows, heads * Dh) buffer."""
    if Dp == Dh:
        return t
    return t.view(t.shape[0], heads, Dp)[..., :Dh].reshape(t.shape[0],
                                                           heads * Dh)


def _attention_fwd(qkv, mask8, B, H, N, scale, dr: _Drop, keep: bool):
    """(o, lse, kept only with ``keep``) of the attention over the fused QKV
    buffer. A head_dim off ``_cuda.HEAD_DIMS`` (one past 128 included: the
    kernels run it in 128-column slices) runs on a copy of the buffer
    with every head zero-padded to ``_cuda.kernel_head_dim`` (exact; the
    output is sliced back)."""
    d = qkv.shape[1] // 3
    Dh = d // H
    Dp = _cuda.kernel_head_dim(Dh, "the training kernels")
    qkv = _pad_heads(qkv, 3 * H, Dh, Dp)
    o = torch.empty((B * N, H * Dp), dtype=torch.float32, device=qkv.device)
    lse = (torch.empty((B, H, N), dtype=torch.float32, device=qkv.device)
           if keep else None)
    _check_attention_operands({"qkv": (qkv, 3 * H * Dp)}, mask8)
    lib = _cuda.load("block_train")
    err = lib.vs_bt_attention_fwd(
        _cuda.ptr(qkv), _cuda.ptr(mask8), _cuda.ptr(o), _cuda.ptr(lse), B,
        H, N, Dp, scale, dr.seed, dr.thr, dr.kscale, _cuda.stream_of(qkv))
    _cuda.check(lib, err, "block_train attention_fwd")
    return _unpad_heads(o, H, Dh, Dp), lse


def _attention_bwd(qkv, o, do, lse, mask8, B, H, N, scale, dr: _Drop):
    d = o.shape[1]
    Dh = d // H
    Dp = _cuda.kernel_head_dim(Dh, "the training kernels")
    qkv = _pad_heads(qkv, 3 * H, Dh, Dp)
    o, do = (_pad_heads(t, H, Dh, Dp) for t in (o, do))
    D = torch.empty_like(lse)
    dqkv = torch.empty_like(qkv)
    _check_attention_operands({"qkv": (qkv, 3 * H * Dp), "o": (o, H * Dp),
                               "do": (do, H * Dp)}, mask8, lse)
    lib = _cuda.load("block_train")
    err = lib.vs_bt_attention_bwd(
        _cuda.ptr(qkv), _cuda.ptr(o), _cuda.ptr(do), _cuda.ptr(lse),
        _cuda.ptr(mask8), _cuda.ptr(D), _cuda.ptr(dqkv), B, H, N, Dp,
        scale, dr.seed, dr.thr, dr.kscale, _cuda.stream_of(qkv))
    _cuda.check(lib, err, "block_train attention_bwd")
    return _unpad_heads(dqkv, 3 * H, Dh, Dp)


def _check_cuda_inputs(x, w: TrainWeights, num_heads: int) -> None:
    B, N, d = x.shape
    if N % TILE:
        raise ValueError(f"N={N} must be a multiple of {TILE}")
    if d % num_heads:
        raise ValueError(f"d_model {d} does not split over {num_heads} heads")
    _cuda.kernel_head_dim(d // num_heads, "the training kernels")
    for t in w:
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError("packed weights must be contiguous f32 on x's "
                             "device")


def _forward_chain(x, mask, seed: int, w: TrainWeights, num_heads: int,
                   scale: float, rate: float, keep: bool = False):
    """The forward launches on CUDA tensors. With ``keep`` (the backward's
    recompute) the f32 intermediates the backward needs are returned too."""
    _check_cuda_inputs(x, w, num_heads)
    B, N, d = x.shape
    H = num_heads
    x32 = x.reshape(B * N, d).float().contiguous()
    mask8 = _cuda.aligned16(
        mask.to(device=x.device, dtype=torch.uint8).contiguous())
    dr = _Drop(int(seed), N, _threshold(rate), _keep_scale(rate))
    qkv = _gemm(x32, w.wqkv, tb=True, bias=w.bqkv)
    o, lse = _attention_fwd(qkv, mask8, B, H, N, scale, dr, keep)
    proj = _gemm(o, w.wp, tb=True, bias=w.bp)
    h1, xhat1, inv1 = _drop_res_ln(proj, x32, w.ln1s, w.ln1b, S_RES1, dr,
                                   keep)
    m1d, a1 = _gemm(h1, w.wf1, tb=True, bias=w.bf1, epilogue="relu_drop",
                    dr=dr, site=S_MLP, keep_pre=True)
    m2 = _gemm(m1d, w.wf2, tb=True, bias=w.bf2)
    out, xhat2, inv2 = _drop_res_ln(m2, h1, w.ln2s, w.ln2b, S_RES2, dr, keep)
    out = out.view(B, N, d).to(x.dtype)
    if not keep:
        return out
    saved = dict(x32=x32, mask8=mask8, dr=dr, qkv=qkv, o=o, lse=lse,
                 h1=h1, xhat1=xhat1, inv1=inv1, a1=a1, m1d=m1d, xhat2=xhat2,
                 inv2=inv2)
    return out, saved


def _backward_chain(x, mask, seed: int, w: TrainWeights, do,
                    num_heads: int, scale: float, rate: float):
    """The backward launches on CUDA tensors: recompute, then the grads of x
    (in x's dtype) and of the packed weights (f32)."""
    B, N, d = x.shape
    H = num_heads
    _, t = _forward_chain(x, mask, seed, w, H, scale, rate, keep=True)
    dr = t["dr"]
    do32 = do.to(x.dtype).reshape(B * N, d).float().contiguous()

    dz2, dm2 = _ln_bwd_drop(do32, t["xhat2"], t["inv2"], w.ln2s, S_RES2, dr)
    dln2b, dln2s = _colsum(do32, t["xhat2"])
    dbf2, _ = _colsum(dm2)
    dwf2 = _gemm(dm2, t["m1d"], ta=True)
    da1 = _gemm(dm2, w.wf2, epilogue="drop_relu_bwd", dr=dr, site=S_MLP,
                aux=t["a1"])
    dbf1, _ = _colsum(da1)
    dwf1 = _gemm(da1, t["h1"], ta=True)
    dh1 = _gemm(da1, w.wf1, addend=dz2)

    dz1, dproj = _ln_bwd_drop(dh1, t["xhat1"], t["inv1"], w.ln1s, S_RES1, dr)
    dln1b, dln1s = _colsum(dh1, t["xhat1"])
    dbp, _ = _colsum(dproj)
    dwp = _gemm(dproj, t["o"], ta=True)
    dattn = _gemm(dproj, w.wp)

    dqkv = _attention_bwd(t["qkv"], t["o"], dattn, t["lse"], t["mask8"], B,
                          H, N, scale, dr)
    dwqkv = _gemm(dqkv, t["x32"], ta=True)
    dbqkv, _ = _colsum(dqkv)
    dx = _gemm(dqkv, w.wqkv, addend=dz1)
    grads = TrainWeights(dwqkv, dbqkv, dwp, dbp, dln1s, dln1b, dwf1, dbf1,
                         dwf2, dbf2, dln2s, dln2b)
    return dx.view(B, N, d).to(x.dtype), grads


# ------------------------------------------------ the four TPU entry points

def _fwd_kernel(x, mask, seed: int, w: TrainWeights, num_heads: int,
                scale: float, rate: float) -> torch.Tensor:
    """Counterpart of ``vidsum_tpu/ops/block_train.py::_fwd_kernel`` (one
    batch element per program, N >= 512)."""
    if x.device.type == "cpu":
        return block_reference_with_masks(x, w, mask, seed, num_heads,
                                          scale, rate)
    out = _forward_chain(x, mask, seed, w, num_heads, scale, rate)
    _fwd_kernel.launches += 1
    return out


_fwd_kernel.launches = 0


def _fwd_kernel_grouped(x, mask, seed: int, w: TrainWeights, num_heads: int,
                        scale: float, rate: float) -> torch.Tensor:
    """Counterpart of ``vidsum_tpu/ops/block_train.py::_fwd_kernel_grouped``
    (G = 1024//N elements per program, N < 512)."""
    if x.device.type == "cpu":
        return block_reference_with_masks(x, w, mask, seed, num_heads,
                                          scale, rate)
    out = _forward_chain(x, mask, seed, w, num_heads, scale, rate)
    _fwd_kernel_grouped.launches += 1
    return out


_fwd_kernel_grouped.launches = 0


def _bwd_kernel(x, mask, seed: int, w: TrainWeights, do, num_heads: int,
                scale: float, rate: float):
    """Counterpart of ``vidsum_tpu/ops/block_train.py::_bwd_kernel``:
    (dx, grads of the packed weights)."""
    if x.device.type == "cpu":
        return block_reference_backward(x, w, mask, seed, do, num_heads,
                                        scale, rate)
    out = _backward_chain(x, mask, seed, w, do, num_heads, scale, rate)
    _bwd_kernel.launches += 1
    return out


_bwd_kernel.launches = 0


def _bwd_kernel_grouped(x, mask, seed: int, w: TrainWeights, do,
                        num_heads: int, scale: float, rate: float):
    """Counterpart of ``vidsum_tpu/ops/block_train.py::
    _bwd_kernel_grouped``."""
    if x.device.type == "cpu":
        return block_reference_backward(x, w, mask, seed, do, num_heads,
                                        scale, rate)
    out = _backward_chain(x, mask, seed, w, do, num_heads, scale, rate)
    _bwd_kernel_grouped.launches += 1
    return out


_bwd_kernel_grouped.launches = 0


# ------------------------------------------------------ routing arithmetic
# The TPU kernels' VMEM arithmetic, copied so that a training shape takes
# the same route here as in the JAX package.

_pick_train_group = _pick_group
_pick_fwd_tile = _pick_bwd_tile = _pick_tile


def fused_block_train_supported(B: int, N: int, d: int,
                                num_heads: int) -> bool:
    """True when the JAX package's train kernels take this shape (the
    backward working set fits its 88 MB VMEM estimate); past it the JAX
    package demotes to the flash-attention training kernels."""
    if N % 128 != 0:
        return False
    g = _pick_train_group(B, N)
    if g > 1:
        rows = g * N
        est = (8 * rows * d * 4
               + num_heads * g * N * N * 5
               + 2 * rows * 4 * d * 4
               + 2 * 9 * d * d * 4)
    else:
        tile = _pick_bwd_tile(N)
        est = (8 * N * d * 4
               + num_heads * tile * N * 5
               + 2 * tile * 4 * d * 4
               + 2 * 9 * d * d * 4)
    return est <= 88 * 1024 * 1024


# ------------------------------------------------------- autograd Function

class _FusedBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, seed, num_heads, scale, rate, *w):
        w = TrainWeights(*w)
        B, N, _ = x.shape
        grouped = _pick_train_group(B, N) > 1
        fwd = _fwd_kernel_grouped if grouped else _fwd_kernel
        out = fwd(x, mask, seed, w, num_heads, scale, rate)
        ctx.save_for_backward(x, mask, *w)
        ctx.cfg = (seed, num_heads, scale, rate, grouped)
        return out

    @staticmethod
    def backward(ctx, do):
        x, mask, *w = ctx.saved_tensors
        seed, num_heads, scale, rate, grouped = ctx.cfg
        bwd = _bwd_kernel_grouped if grouped else _bwd_kernel
        dx, grads = bwd(x, mask, seed, TrainWeights(*w), do.contiguous(),
                        num_heads, scale, rate)
        return (dx, None, None, None, None, None, *grads)


def fused_block_train(x: torch.Tensor, block, pad_mask, seed: int,
                      num_heads: int, scale: float,
                      rate: float) -> torch.Tensor:
    """Trainable fused encoder block on x (B, N, d), N a multiple of 128;
    ``pad_mask`` (B, N) bool, True at padded keys, or None; ``seed`` the
    layer's dropout seed in [0, 2**31)."""
    if num_heads > MAX_HASH_HEADS:
        raise ValueError(f"dropout site encoding supports <= "
                         f"{MAX_HASH_HEADS} heads")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    B, N, _ = x.shape
    if pad_mask is None:
        pad_mask = torch.zeros((B, N), dtype=torch.bool, device=x.device)
    return _FusedBlockTrain.apply(x, pad_mask.to(torch.bool), int(seed),
                                  num_heads, float(scale), float(rate),
                                  *train_weights(block))

"""PGL-SUM's row-wise steps between its products, on ``csrc/row_norms.cu``:

- :func:`fuse_layernorm` -- ``LN(n(a) + n(b) + x)`` with ``n(v) = v /
  max(|v|_2, 1e-12)`` row by row: the global and local attention branches
  fused by ``add``, the residual, ``norm_y`` (two launches: the fusion, then
  the LayerNorm rows in place);
- :func:`layernorm_` -- ``LN(a)`` in place: ``norm_linear``.

The LayerNorm is ``common.cuh``'s ``layernorm_rows_kernel``, the serving
GEMMs' LayerNorm rows. PGL-SUM has no TPU kernel (the JAX package has no
PGL-SUM); these are the published model's ``F.normalize`` and
``nn.LayerNorm``. Each wrapper runs the kernels on CUDA tensors and its
plain PyTorch version on CPU tensors; ``launches`` on a wrapper counts its
kernel launches. A row's result does not depend on the other rows (one warp
a row, sums in a fixed order).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vidsum_tpu_torch.ops import _cuda

L2_EPS = 1e-12
MAX_COLS = 1024


def fuse_layernorm_reference(a, b, x, g, beta, eps: float) -> torch.Tensor:
    """Plain version of :func:`fuse_layernorm`."""
    z = (F.normalize(a.float(), p=2, dim=-1, eps=L2_EPS)
         + F.normalize(b.float(), p=2, dim=-1, eps=L2_EPS)) + x.float()
    return F.layer_norm(z, z.shape[-1:], g, beta, eps)


def layernorm_reference(a, g, beta, eps: float) -> torch.Tensor:
    """Plain version of :func:`layernorm_` (not in place)."""
    return F.layer_norm(a.float(), a.shape[-1:], g, beta, eps)


def _launch(a, b, x, out, g, beta, eps: float) -> None:
    M, N = a.shape
    if N > MAX_COLS:
        raise ValueError(f"row_norms takes rows of up to {MAX_COLS} "
                         f"columns, got {N}")
    for t in (a, b, x, out):
        if t is not None and (t.shape != (M, N) or not t.is_contiguous()
                              or t.dtype != torch.float32):
            raise ValueError("rows must be contiguous (M, N) float32")
    for t in (g, beta):
        if t.shape != (N,) or t.dtype != torch.float32:
            raise ValueError("g and beta must be (N,) float32")
    lib = _cuda.load("row_norms")
    err = lib.vs_row_norms(_cuda.ptr(a), _cuda.ptr(b), _cuda.ptr(x),
                           _cuda.ptr(g), _cuda.ptr(beta), _cuda.ptr(out), M,
                           N, int(out is not None), float(eps),
                           _cuda.stream_of(a))
    _cuda.check(lib, err, "row_norms")


def fuse_layernorm(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                   g: torch.Tensor, beta: torch.Tensor, eps: float
                   ) -> torch.Tensor:
    """``LN(n(a) + n(b) + x)`` row by row; a, b, x (M, N) contiguous f32,
    g and beta (N,) f32, N <= 1,024. Returns a new (M, N) f32 tensor."""
    if a.device.type == "cpu":
        return fuse_layernorm_reference(a, b, x, g, beta, eps)
    out = torch.empty_like(a)
    _launch(a, b, x, out, g, beta, eps)
    fuse_layernorm.launches += 2
    return out


fuse_layernorm.launches = 0


def layernorm_(a: torch.Tensor, g: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    """``LN(a)`` row by row, in place; a (M, N) contiguous f32, N <=
    1,024. Returns a."""
    if a.device.type == "cpu":
        return a.copy_(layernorm_reference(a, g, beta, eps))
    _launch(a, None, None, None, g, beta, eps)
    layernorm_.launches += 1
    return a


layernorm_.launches = 0

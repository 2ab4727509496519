# ported from scripts/probe_int8_mxu.py
"""Probe: do int8 products run faster than bf16 ones on this card?

    python -m vidsum_tpu_torch.tools.probe_int8_mma [--m 2048] [--n 2048]
        [--k 2048] [--reps 50]

The JAX probe times a tiled Pallas matmul in bf16 and in int8 on the TPU
(TPU kernel 18: ``_mm_kernel_bf16``, ``_mm_kernel_int8``). Its two entry
points here run the port's own hand-written kernels on the card:

- :func:`mm_bf16` (18a): ``dot(x, w)`` with f32 accumulation, rounded to
  bf16: ``ops/block_kernel.gemm_bias_epilogue`` (``mma.sync`` m16n8k16) with
  a zero f32 bias, which adds nothing;
- :func:`mm_int8` (18b): ``dot(x, w)`` with s32 accumulation, then
  ``(acc >> 8)`` truncated to int8 (arithmetic shift, then the low 8 bits):
  ``ops/quant.int8_gemm`` with its shift epilogue (``mma.sync`` m16n8k32).

W is passed as (N, K), K-contiguous, the layout both kernels take. Each
entry point counts its launches and runs its plain PyTorch version on CPU
tensors. :func:`main` prints one JSON line: ms, TOPS and the speed-up over
``torch.matmul`` in bf16 for both, with ``torch.matmul`` and
``torch._int_mm`` timed as yardsticks only. The answer (int8 against bf16
on the same hand-written GEMM design) says whether making the int8 scoring
path fast is worth a later PR on this card.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from vidsum_tpu_torch.ops.block_kernel import gemm_bias_epilogue
from vidsum_tpu_torch.ops.quant import int8_gemm


def mm_bf16_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16 . w (N, K)^T bf16 summed in f32, rounded to bf16."""
    return torch.matmul(x.float(), w.float().t()).to(torch.bfloat16)


def mm_int8_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) int8 . w (N, K)^T int8 summed exactly, ``(acc >> 8)``
    truncated to int8."""
    acc = torch.matmul(x.double(), w.double().t()).to(torch.int64)
    return (acc >> 8).to(torch.int32).to(torch.int8)


def mm_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """TPU kernel 18a (``scripts/probe_int8_mxu.py:63 _mm_kernel_bf16``)."""
    if x.device.type == "cpu":
        return mm_bf16_reference(x, w)
    zero = torch.zeros(w.shape[0], dtype=torch.float32, device=x.device)
    out, _ = gemm_bias_epilogue(x, w, zero, "none")
    mm_bf16.launches += 1
    return out


mm_bf16.launches = 0


def mm_int8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """TPU kernel 18b (``scripts/probe_int8_mxu.py:69 _mm_kernel_int8``)."""
    if x.device.type == "cpu":
        return mm_int8_reference(x, w)
    out = int8_gemm(x, None, w, None, None, "shift")
    mm_int8.launches += 1
    return out


mm_int8.launches = 0


def _median_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def inputs(M: int, N: int, K: int, seed: int = 0):
    """The probe's operands on the card: bf16 normal and int8 uniform in
    [-127, 127], made from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xb = torch.randn((M, K), generator=g, device="cuda").bfloat16()
    wb = torch.randn((N, K), generator=g, device="cuda").bfloat16()
    xi = torch.randint(-127, 128, (M, K), generator=g, device="cuda",
                       dtype=torch.int8)
    wi = torch.randint(-127, 128, (N, K), generator=g, device="cuda",
                       dtype=torch.int8)
    return xb, wb, xi, wi


def measure(M: int = 2048, N: int = 2048, K: int = 2048, reps: int = 50,
            seed: int = 0) -> dict:
    """Median CUDA-event ms and TOPS of both kernels and both yardsticks at
    (M, K) . (N, K)^T on the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("the int8 probe measures the CUDA card; none is "
                           "available")
    xb, wb, xi, wi = inputs(M, N, K, seed)
    ops = 2.0 * M * N * K
    out = {"device": torch.cuda.get_device_name(0),
           "shape": f"{M}x{K}x{N}"}
    cases = {
        "bf16_kernel": lambda: mm_bf16(xb, wb),
        "int8_kernel": lambda: mm_int8(xi, wi),
        "bf16_torch_matmul": lambda: torch.matmul(xb, wb.t()),
        "int8_torch_int_mm": lambda: torch._int_mm(xi, wi.t()),
    }
    for name, fn in cases.items():
        ms = _median_ms(fn, reps)
        out[name] = {"ms": ms, "tops": ops / ms / 1e9}
    base = out["bf16_torch_matmul"]["ms"]
    for name in ("bf16_kernel", "int8_kernel", "int8_torch_int_mm"):
        out[name]["speedup_vs_bf16_matmul"] = base / out[name]["ms"]
    out["int8_over_bf16_kernel"] = (out["bf16_kernel"]["ms"]
                                    / out["int8_kernel"]["ms"])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=2048)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.m, args.n, args.k, args.reps)))


if __name__ == "__main__":
    main()

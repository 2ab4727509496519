"""Device policy of the port's entry points: ``device=None`` means the CUDA
card, and a machine without one raises instead of falling back to the CPU.
The CPU runs only when the caller asks for it (``device="cpu"``), which is
how the tests run the plain PyTorch versions of the kernels."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; vidsum_tpu_torch runs on the GPU by "
            "default. Pass device='cpu' to run the plain PyTorch path.")
    return dev


def dtype_of(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt

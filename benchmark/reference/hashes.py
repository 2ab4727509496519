"""Frozen copy of the counter-hash dropout bits that SimNet's training routes
document (ROADMAP.md, "Same dropout bits"): a keep bit is a murmur-style
finalizer of (seed, site or head, batch index, row, column), thresholded at
``rate * 2**32``. Two families share the finalizer and differ in their base:

- block family (the fused training block): sites are the head ``h`` for
  the attention weights and 32 / 33 / 34 for the first residual, the MLP's
  ReLU output and the second residual;
- attention family (the flash training attention past the block's
  envelope): the base hashes ``b * 1024 + h + 1``.

uint32 arithmetic runs in int64 masked to 32 bits, each product split in
16-bit halves so that no intermediate leaves int64.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
SITE_RES1, SITE_MLP, SITE_RES2 = 32, 33, 34


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def threshold(rate: float) -> int:
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def keep_scale(rate: float) -> float:
    """1 / (1 - rate) rounded to float32, the factor a kept value takes."""
    return float(np.float32(1.0 / (1.0 - rate))) if rate > 0.0 else 1.0


def _finalize(x: torch.Tensor, rate: float) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= threshold(rate)


def block_keep(seed: int, site, b, rows, cols, rate: float) -> torch.Tensor:
    """Keep bits of the block family over broadcast int64 tensors."""
    base = (((int(seed) * 0x9E3779B1) & M32)
            + mul32(site * 131071 + 17, 0x85EBCA77)
            + mul32(b + 1, 0x27220A95)) & M32
    return _finalize(base ^ mul32(rows, 0xC2B2AE3D)
                     ^ mul32(cols, 0x27D4EB2F), rate)


def attention_keep(seed: int, b, h, rows, cols, rate: float) -> torch.Tensor:
    """Keep bits of the attention family over broadcast int64 tensors."""
    base = (((int(seed) * 0x9E3779B1) & M32)
            + mul32(b * 1024 + h + 1, 0x85EBCA77)) & M32
    return _finalize(base ^ mul32(rows, 0xC2B2AE3D)
                     ^ mul32(cols, 0x27D4EB2F), rate)

# ported from vidsum_tpu/serve/mesh.py (the single-device length cap only;
# replica batches and the sequence-parallel long route arrive with the
# multi-GPU slice)
"""The length arithmetic serving needs without a mesh."""

from __future__ import annotations

from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.device import dtype_of
from vidsum_tpu_torch.ops.attention import flash_forward_supported


def _single_chip_max_len(cfg: ModelConfig, bucket: int) -> int:
    """Largest bucketed length the single-device kernel ladder carries."""
    dh = cfg.d_model // cfg.num_heads
    itemsize = dtype_of(cfg.compute_dtype).itemsize
    n = bucket
    while n < (1 << 21) and flash_forward_supported(n + bucket, dh,
                                                    itemsize):
        n += bucket
    return n

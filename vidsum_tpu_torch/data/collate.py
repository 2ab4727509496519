# ported from vidsum_tpu/data/collate.py (the length bucket serving uses;
# the training collate arrives with the data slice)
"""Length buckets: sequences are padded up to a multiple of
``DataConfig.length_bucket`` (128) with the sentinel 1000, so a whole run
touches a handful of shapes and the kernels see 128-multiple lengths."""

from __future__ import annotations

from typing import Optional


def bucket_length(n: int, bucket: int = 128, max_len: Optional[int] = None) -> int:
    """Round ``n`` up to a multiple of ``bucket`` (clamped to ``max_len``)."""
    padded = ((n + bucket - 1) // bucket) * bucket
    if max_len is not None:
        padded = min(padded, max_len)
    return max(padded, bucket if max_len is None else min(bucket, max_len))

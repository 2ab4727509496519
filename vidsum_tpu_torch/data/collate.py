# ported from vidsum_tpu/data/collate.py (the training collate; the pretrain
# collate arrives with the pretrain slice)
"""Batch collation with length buckets: sequences are padded up to a
multiple of ``DataConfig.length_bucket`` (128) with the sentinel 1000
(reference ``src/data/dataset.py:139-161`` pads to the batch max), so a run
touches a handful of shapes and the kernels see 128-multiple lengths."""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def bucket_length(n: int, bucket: int = 128, max_len: Optional[int] = None) -> int:
    """Round ``n`` up to a multiple of ``bucket`` (clamped to ``max_len``)."""
    padded = ((n + bucket - 1) // bucket) * bucket
    if max_len is not None:
        padded = min(padded, max_len)
    return max(padded, bucket if max_len is None else min(bucket, max_len))


def pad_batch(features: Sequence[np.ndarray], targets: Sequence[np.ndarray],
              pad_value: float = 1000.0, bucket: int = 128,
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad (N_i, D) features and (N_i,) targets to a shared bucketed length.
    Returns (features (B, N, D), targets (B, N), pad_mask (B, N) bool, True
    at padding); targets are padded with ``pad_value`` like the reference's
    ``collate_fn_train`` (the loss masks them out)."""
    B = len(features)
    max_n = max(f.shape[0] for f in features)
    N = bucket_length(max_n, bucket)
    D = features[0].shape[1]
    out_f = np.full((B, N, D), pad_value, dtype=np.float32)
    out_t = np.full((B, N), pad_value, dtype=np.float32)
    mask = np.ones((B, N), dtype=bool)
    for i, (f, t) in enumerate(zip(features, targets)):
        n = f.shape[0]
        out_f[i, :n] = f
        out_t[i, :n] = t
        mask[i, :n] = False
    return out_f, out_t, mask


def make_batches(n_items: int, batch_size: int, *, shuffle: bool,
                 rng: Optional[np.random.Generator] = None
                 ) -> Iterator[List[int]]:
    """Yield index batches; the last may be smaller. (The JAX package's
    ``drop_last``, for pretraining, and ``pad_to_batch`` with
    ``item_weights``, for its device mesh, arrive with those slices.)"""
    idx = np.arange(n_items)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    for start in range(0, n_items, batch_size):
        yield idx[start:start + batch_size].tolist()

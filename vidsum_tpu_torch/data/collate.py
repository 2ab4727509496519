# ported from vidsum_tpu/data/collate.py
"""Batch collation with length buckets: sequences are padded up to a
multiple of ``DataConfig.length_bucket`` (128) with the sentinel 1000
(reference ``src/data/dataset.py:139-161`` pads to the batch max), so a run
touches a handful of shapes and the kernels see 128-multiple lengths."""

from __future__ import annotations

import itertools
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


def pad_batch_pretrain(features: Sequence[np.ndarray],
                       video_reps: Sequence[np.ndarray],
                       pad_value: float = 1000.0, bucket: int = 128,
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The pretrain collate (reference ``collate_fn_pretrain``,
    dataset.py:157-161): frame features padded to a shared bucketed length
    with ``pad_value``, the (B, 512) video reps stacked, and the pad mask
    (B, N) bool, True at padding."""
    B = len(features)
    max_n = max(f.shape[0] for f in features)
    N = bucket_length(max_n, bucket)
    D = features[0].shape[1]
    out_f = np.full((B, N, D), pad_value, dtype=np.float32)
    mask = np.ones((B, N), dtype=bool)
    for i, f in enumerate(features):
        out_f[i, :f.shape[0]] = f
        mask[i, :f.shape[0]] = False
    reps = np.stack([np.asarray(v, dtype=np.float32) for v in video_reps])
    return out_f, reps, mask


def make_batches(n_items: int, batch_size: int, *, shuffle: bool,
                 rng: Optional[np.random.Generator] = None,
                 drop_last: bool = False,
                 pad_to_batch: bool = False) -> Iterator[List[int]]:
    """Yield index batches; the last may be smaller, or with ``drop_last``
    (pretraining, the reference's ``DataLoader(drop_last=True)``) is left
    out. With ``pad_to_batch`` (a device mesh, whose shards need equal
    rows) the last partial batch is filled by cycling its own indices:
    its length bucket stays the reference's smaller final batch's, and the
    repeats are exact duplicates that :func:`item_weights` weighs 0."""
    idx = np.arange(n_items)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    for start in range(0, n_items, batch_size):
        chunk = idx[start:start + batch_size].tolist()
        if len(chunk) < batch_size:
            if drop_last:
                return
            if pad_to_batch:
                chunk = chunk + list(itertools.islice(
                    itertools.cycle(chunk), batch_size - len(chunk)))
        yield chunk


def item_weights(batch_idx: List[int]) -> np.ndarray:
    """(B,) f32: 1.0 at the first occurrence of each index, 0.0 at repeats.
    An epoch's order is a permutation, so a repeat can only be
    ``pad_to_batch``'s fill; weighing it 0 makes the padded batch's loss
    and gradients the unpadded smaller batch's."""
    seen: set = set()
    w = np.empty(len(batch_idx), dtype=np.float32)
    for j, i in enumerate(batch_idx):
        w[j] = 0.0 if i in seen else 1.0
        seen.add(i)
    return w

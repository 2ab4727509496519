# ported from vidsum_tpu/ops/knapsack.py (NumPy and native paths; the
# on-device knapsack arrives with the device-eval slice)
"""0/1 knapsack shot selection.

Behaviour (reference: ``src/evaluation/knapsack_implementation.py:1-30``):
given capacity ``W`` (frames), shot lengths ``wt`` and shot values ``val``,
build the DP table with ``max(val[i-1]+K[i-1][w-wt], K[i-1][w])`` and
backtrack with the strict inequality ``K[i][w] != K[i-1][w]``, emitting
selected shot indices in ascending order. Every table entry is the same
float64 add/compare as the reference's Python-float loop, so the selected
set is bit-for-bit the reference's.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from vidsum_tpu_torch import native

# the C++ fast path; set to None to force the NumPy DP
_knapsack_native = native.knapsack_native


def knapsack(W: int, wt: Sequence[int], val: Sequence[float],
             use_native: bool = True) -> List[int]:
    """Select shot indices maximizing total value under a frame budget."""
    n = len(wt)
    W = int(W)
    if W < 0:
        raise ValueError("negative knapsack capacity")
    wt_arr = np.asarray(wt, dtype=np.int64)
    val_arr = np.asarray(val, dtype=np.float64)
    if wt_arr.shape != val_arr.shape:
        raise ValueError("wt and val must have equal length")
    if n and wt_arr.min() < 0:
        raise ValueError("negative shot length")
    if n and not np.isfinite(val_arr).all():
        # NaN values poison the backtrack (NaN != NaN selects every shot and
        # drives the capacity negative) — fail loudly instead.
        raise ValueError("non-finite shot value")

    if _knapsack_native is not None and use_native and native.available():
        return _knapsack_native(W, wt_arr, val_arr)

    # K[i] = best value with first i shots; rows kept for backtracking.
    K = np.zeros((n + 1, W + 1), dtype=np.float64)
    for i in range(1, n + 1):
        w_i = int(wt_arr[i - 1])
        prev = K[i - 1]
        row = prev.copy()
        if w_i <= W:
            cand = val_arr[i - 1] + prev[: W + 1 - w_i]
            np.maximum(cand, prev[w_i:], out=row[w_i:])
        K[i] = row

    selected: List[int] = []
    w = W
    for i in range(n, 0, -1):
        if K[i, w] != K[i - 1, w]:
            selected.insert(0, i - 1)
            w -= int(wt_arr[i - 1])
    return selected

# ported from vidsum_tpu/ops/knapsack.py
"""0/1 knapsack shot selection.

Behaviour (reference: ``src/evaluation/knapsack_implementation.py:1-30``):
given capacity ``W`` (frames), shot lengths ``wt`` and shot values ``val``,
build the DP table with ``max(val[i-1]+K[i-1][w-wt], K[i-1][w])`` and
backtrack with the strict inequality ``K[i][w] != K[i-1][w]``, emitting
selected shot indices in ascending order. Every table entry is the same
float64 add/compare as the reference's Python-float loop, so the selected
set is bit-for-bit the reference's.

:func:`knapsack_device` is the same DP on tensors, batched over videos, on
their device (the ``eval_impl="device"`` path; the JAX ``knapsack_jax``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

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


def knapsack_device(W: int, wt: torch.Tensor, val: torch.Tensor,
                    budget=None) -> torch.Tensor:
    """The DP of :func:`knapsack` on ``wt`` / ``val`` (V, S), batched over
    the V videos, on their device (the JAX ``knapsack_jax``, vmapped).
    Returns the selection mask (V, S) bool.

    ``W`` is the table's width (a static bound); ``budget`` (V,) is each
    video's capacity, clipped to [0, W] (default W). The table is float64,
    as the host DP's: the JAX package accumulates double-float pairs only
    because the TPU has no float64. Each entry is the host DP's add and
    compare (include wins a tie, ``>=``), and the backtrack keeps the host's
    strict ``K[i][w] != K[i-1][w]``, so the picks are the host oracle's by
    construction for equal ``val``. That comparison is all the backtrack
    reads, so the forward keeps it per entry as a bool (S, V, W+1) instead
    of the rows. Padded shots (weight 0, value 0) never change a row, so
    they are never taken."""
    dev = val.device
    wt = wt.to(device=dev, dtype=torch.int64)
    val = val.to(torch.float64)
    V, S = wt.shape
    Wp1 = int(W) + 1
    cols = torch.arange(Wp1, device=dev)
    prev = torch.zeros((V, Wp1), dtype=torch.float64, device=dev)
    changed = torch.empty((S, V, Wp1), dtype=torch.bool, device=dev)
    for i in range(S):
        w_i = wt[:, i:i + 1]
        inc = val[:, i:i + 1] + torch.gather(
            prev, 1, (cols[None, :] - w_i).clamp(0, Wp1 - 1))
        use = (cols[None, :] >= w_i) & (inc >= prev)
        row = torch.where(use, inc, prev)
        torch.ne(row, prev, out=changed[i])
        prev = row
    w = (torch.full((V,), Wp1 - 1, device=dev) if budget is None
         else torch.as_tensor(budget, device=dev).to(torch.int64)
         .clamp(0, Wp1 - 1))
    taken = torch.zeros((V, S), dtype=torch.bool, device=dev)
    v_idx = torch.arange(V, device=dev)
    for i in range(S - 1, -1, -1):
        take = changed[i, v_idx, w]
        taken[:, i] = take
        w = torch.where(take, w - wt[:, i], w)
    return taken

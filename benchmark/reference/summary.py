"""Plain DSNet-style summary selection, written from the published
evaluation (``src/evaluation/generate_summary.py``,
``knapsack_implementation.py``): per-sample scores expanded to every
original frame as a step function, each shot scored by the float32 mean of
its frames, shots picked by a 0/1 knapsack under ``budget_ratio`` of the
frames, and the picked shots' frames set to 1.
"""

from __future__ import annotations

from typing import List

import numpy as np


def frame_scores(scores: np.ndarray, n_frames: int,
                 picks: np.ndarray) -> np.ndarray:
    """Sample i's score covers frames [picks[i], picks[i + 1]), the last up
    to ``n_frames``; frames past the scored samples score 0."""
    bounds = np.asarray(picks, dtype=np.int64)
    if bounds[-1] != n_frames:
        bounds = np.concatenate([bounds, [n_frames]])
    out = np.zeros(n_frames, dtype=np.float32)
    for i in range(len(bounds) - 1):
        val = np.float32(scores[i]) if i < len(scores) else np.float32(0)
        out[max(bounds[i], 0):min(bounds[i + 1], n_frames)] = val
    return out


def knapsack(capacity: int, weights: List[int],
             values: List[float]) -> List[int]:
    """Indices (ascending) that maximise the value under the capacity; ties
    take the item, and the backtrack takes an item where its row changed."""
    n = len(weights)
    table = np.zeros((n + 1, capacity + 1), dtype=np.float64)
    for i in range(1, n + 1):
        w, v = weights[i - 1], values[i - 1]
        table[i] = table[i - 1]
        if w <= capacity:
            cand = v + table[i - 1, :capacity + 1 - w]
            table[i, w:] = np.where(cand >= table[i - 1, w:], cand,
                                    table[i - 1, w:])
    picked, c = [], capacity
    for i in range(n, 0, -1):
        if table[i, c] != table[i - 1, c]:
            picked.append(i - 1)
            c -= weights[i - 1]
    return picked[::-1]


def summary(scores: np.ndarray, change_points: np.ndarray, n_frames: int,
            picks: np.ndarray, budget_ratio: float) -> np.ndarray:
    """The binary frame summary (int8, one entry per frame up to the last
    shot's end)."""
    fs = frame_scores(scores, n_frames, picks)
    lengths = [int(e - s + 1) for s, e in change_points]
    values = [fs[s:e + 1].mean().item() for s, e in change_points]
    last = int(change_points[-1][1])
    chosen = knapsack(int((last + 1) * budget_ratio), lengths, values)
    out = np.zeros(last + 1, dtype=np.int8)
    for i in chosen:
        out[change_points[i][0]:change_points[i][1] + 1] = 1
    return out

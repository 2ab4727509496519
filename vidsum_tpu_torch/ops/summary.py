# ported from vidsum_tpu/ops/summary.py
"""Machine-summary generation: score upsampling, shot-mean scoring, knapsack
shot selection.

Behavior contract (reference: ``src/evaluation/generate_summary.py:6-57`` and
``src/evaluation/compute_metrics.py:19-39``): per video, expand per-pick scores
to the original frame count as a step function (appending ``n_frames`` as the
final boundary when missing, zero-filling past the last score), average frame
scores per shot (inclusive shot bounds), select shots by 0/1 knapsack under a
15% budget of ``final_shot_end + 1`` frames, and emit a binary frame vector.

The step-function edge cases, the float32 shot means materialized as Python
floats (``.item()``), and the knapsack DP are reproduced exactly so selected
shots match the reference bit-for-bit.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from vidsum_tpu_torch.ops.knapsack import knapsack


def upsample(scores: np.ndarray, n_frames: int, positions: np.ndarray) -> np.ndarray:
    """Expand per-pick scores to per-frame scores as a step function.

    Reference: ``src/evaluation/compute_metrics.py:19-39`` (identical logic is
    inlined at ``generate_summary.py:25-35``).
    """
    scores = np.asarray(scores)
    n_frames = int(np.asarray(n_frames).reshape(()))
    positions = np.asarray(positions).reshape(-1)
    frame_scores = np.zeros((n_frames,), dtype=np.float32)
    if positions.dtype != int:
        positions = positions.astype(np.int32)
    if positions[-1] != n_frames:
        positions = np.concatenate([positions, [n_frames]])
    # vectorized equivalent of the reference fill loop: segment i spans
    # [positions[i], positions[i+1]) and takes scores[i] (0 past the end).
    n_seg = len(positions) - 1
    seg_vals = np.zeros((n_seg,), dtype=np.float32)
    m = min(n_seg, len(scores))
    seg_vals[:m] = np.asarray(scores[:m], dtype=np.float32)
    starts = np.clip(positions[:-1], 0, n_frames)
    ends = np.clip(positions[1:], 0, n_frames)
    for i in range(n_seg):  # segments can overlap arbitrarily; keep fill order
        frame_scores[starts[i]:ends[i]] = seg_vals[i]
    return frame_scores


def shot_scores(frame_scores: np.ndarray, shot_bound: np.ndarray):
    """Per-shot mean importance + shot lengths (inclusive bounds).

    Reference: ``generate_summary.py:37-42``. Means are float32 reductions
    materialized as Python floats, matching ``.mean().item()``.
    """
    lengths: List[int] = []
    values: List[float] = []
    for shot in shot_bound:
        s, e = int(shot[0]), int(shot[1])
        lengths.append(e - s + 1)
        values.append(frame_scores[s:e + 1].mean().item())
    return lengths, values


def generate_summary(all_shot_bound: Sequence[np.ndarray],
                     all_scores: Sequence[np.ndarray],
                     all_nframes: Sequence[int],
                     all_positions: Sequence[np.ndarray],
                     budget_ratio: float = 0.15) -> List[np.ndarray]:
    """Binary frame-level summaries for a batch of videos.

    Reference: ``src/evaluation/generate_summary.py:6-57``.
    """
    all_summaries = []
    for shot_bound, scores, n_frames, positions in zip(
            all_shot_bound, all_scores, all_nframes, all_positions):
        shot_bound = np.asarray(shot_bound)
        n_frames = int(np.asarray(n_frames).reshape(()))

        frame_scores = upsample(scores, n_frames, np.asarray(positions))
        lengths, values = shot_scores(frame_scores, shot_bound)

        final_shot = shot_bound[-1]
        budget = int((int(final_shot[1]) + 1) * budget_ratio)
        selected = knapsack(budget, lengths, values)

        summary = np.zeros(int(final_shot[1]) + 1, dtype=np.int8)
        for shot in selected:
            summary[int(shot_bound[shot][0]):int(shot_bound[shot][1]) + 1] = 1
        all_summaries.append(summary)
    return all_summaries

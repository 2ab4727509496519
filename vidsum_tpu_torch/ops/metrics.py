# ported from vidsum_tpu/ops/metrics.py
"""Summary-quality metrics: F-score vs user summaries, Kendall-tau /
Spearman-rho vs per-annotator scores, and the per-epoch eval entry point.

- :func:`evaluate_summary`: reference
  ``src/evaluation/evaluation_metrics.py:4-33``, per-user overlap F1 x 100
  reduced by 'max' or 'avg'.
- :func:`evaluate_scores`: reference
  ``src/evaluation/compute_correlation.py:4-15``.
- :func:`eval_metrics`: reference
  ``src/evaluation/compute_metrics.py:42-92``, mean F/tau/rho over videos.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy import stats

from vidsum_tpu_torch.ops.device_eval import device_generate_summary
from vidsum_tpu_torch.ops.summary import generate_summary, upsample


def evaluate_summary(predicted_summary: np.ndarray, user_summary: np.ndarray,
                     eval_method: str = "avg") -> float:
    """Overlap F-score (x100) between machine and user summaries."""
    max_len = max(len(predicted_summary), user_summary.shape[1])
    S = np.zeros(max_len, dtype=int)
    G = np.zeros(max_len, dtype=int)
    S[: len(predicted_summary)] = predicted_summary

    s_total = S.sum()  # np.int64, like the reference's builtin sum(S)
    if int(s_total) == 0:
        # an empty machine summary scores 0 (the reference divides by zero)
        return 0.0

    f_scores = []
    for user in range(user_summary.shape[0]):
        G[:] = 0
        G[: user_summary.shape[1]] = user_summary[user]
        n_overlap = (S & G).sum()
        # keep np.float64 scalars (not Python floats): CPython >= 3.12's
        # builtin sum() applies Neumaier compensation to Python floats but
        # left-folds numpy scalars, and the reference sums np.float64s, so
        # Python floats here would flip the 'avg' reduction's last bit
        precision = n_overlap / s_total
        recall = n_overlap / G.sum()
        if precision + recall == 0:
            f_scores.append(0)
        else:
            f_scores.append(2 * precision * recall * 100 / (precision + recall))

    if eval_method == "max":
        return max(f_scores)
    return sum(f_scores) / len(f_scores)


def evaluate_scores(predicted_scores: np.ndarray,
                    user_scores: np.ndarray) -> Tuple[float, float]:
    """Mean Kendall-tau and Spearman-rho of the prediction vs each
    annotator."""
    kendall, spearman = [], []
    pred_rank = stats.rankdata(-np.asarray(predicted_scores))
    for i in range(user_scores.shape[0]):
        user_rank = stats.rankdata(-user_scores[i])
        spearman.append(stats.spearmanr(pred_rank, user_rank)[0])
        kendall.append(stats.kendalltau(pred_rank, user_rank)[0])
    return sum(kendall) / len(kendall), sum(spearman) / len(spearman)


def eval_metrics(score_dict: Dict[str, np.ndarray], user_dict: Dict[str, object],
                 eval_method: str = "avg",
                 budget_ratio: float = 0.15,
                 impl: str = "host", *,
                 device=None) -> Tuple[float, float, float]:
    """Mean (F-score, Kendall-tau, Spearman-rho) over the videos of
    ``score_dict``; ``user_dict`` values are
    :class:`~vidsum_tpu_torch.data.datasets.UserSummaries`.

    ``impl`` ``"host"`` builds the summaries with the float64 NumPy / C++
    pipeline (the oracle), ``"device"`` with one batched pass on ``device``
    (default: the CUDA card) through
    :func:`~vidsum_tpu_torch.ops.device_eval.device_generate_summary`, which
    selects the same frames. The correlations run on the host either way."""
    if impl not in ("host", "device"):
        raise ValueError(f"eval impl must be 'host' or 'device', got {impl!r}")
    keys = list(score_dict.keys())
    all_scores = [score_dict[k] for k in keys]
    users = [user_dict[k] for k in keys]
    args = ([u.change_points for u in users], all_scores,
            [u.n_frames for u in users], [u.picks for u in users])
    if impl == "device":
        all_summaries = device_generate_summary(
            *args, budget_ratio=budget_ratio, device=device)
    else:
        all_summaries = generate_summary(*args, budget_ratio=budget_ratio)

    all_f, all_kendall, all_spearman = [], [], []
    for summary, scores, user in zip(all_summaries, all_scores, users):
        frame_scores = upsample(scores, user.n_frames, np.asarray(user.picks))
        all_f.append(evaluate_summary(summary, user.user_summary, eval_method))
        if user.user_scores is None:
            k = s = float("nan")
        else:
            k, s = evaluate_scores(frame_scores, user.user_scores)
        all_kendall.append(k)
        all_spearman.append(s)
    return (float(np.mean(all_f)), float(np.mean(all_kendall)),
            float(np.mean(all_spearman)))

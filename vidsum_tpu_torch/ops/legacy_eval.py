# ported from vidsum_tpu/ops/legacy_eval.py
"""Legacy h5-direct F-score evaluation.

Behaviour (reference: ``src/evaluation/compute_fscores.py:16-54``, present
but left out of the package's exports at ``evaluation/__init__.py:1-2``):
score a dict of per-video scores by reading ``user_summary /
change_points / n_frames / picks`` straight from an eccv16-schema h5 file
keyed ``video_<idx>``, rather than from :class:`UserSummaries` records.
``h5py`` is imported by :func:`f1_score` only.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from vidsum_tpu_torch.data.paths import ECCV16_PATH
from vidsum_tpu_torch.ops.metrics import evaluate_summary
from vidsum_tpu_torch.ops.summary import generate_summary


def f1_score(score_dict: Dict[str, np.ndarray], data_root: str,
             dataset: str, eval_method: str = "avg",
             budget_ratio: float = 0.15) -> float:
    """Mean overlap F-score over the videos in ``score_dict``, reading the
    eval metadata from the dataset's eccv16 h5 file."""
    import h5py

    path = os.path.join(data_root, ECCV16_PATH[dataset])
    all_scores, all_user, all_sb, all_n, all_pos = [], [], [], [], []
    with h5py.File(path, "r") as f:
        for name, scores in score_dict.items():
            g = f[name]
            all_scores.append(np.asarray(scores))
            all_user.append(np.asarray(g["user_summary"]))
            all_sb.append(np.asarray(g["change_points"]))
            all_n.append(int(np.asarray(g["n_frames"]).reshape(())))
            all_pos.append(np.asarray(g["picks"]))

    summaries = generate_summary(all_sb, all_scores, all_n, all_pos,
                                 budget_ratio=budget_ratio)
    f_scores = [evaluate_summary(s, u, eval_method)
                for s, u in zip(summaries, all_user)]
    return float(np.mean(f_scores))

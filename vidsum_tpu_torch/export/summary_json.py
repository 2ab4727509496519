# ported from vidsum_tpu/export/summary_json.py
"""Summary export: model scores -> selected-frame JSON.

Behaviour (reference: ``src/generate_summary_image.py:39-80``): run the
model over a val dataset one video at a time (padded to
``cfg.data.length_bucket``), sigmoid the scores, build knapsack summaries,
and write ``summary.json`` mapping ``video_<i>`` (the enumeration index, a
reference quirk, not the h5 key) to the list of selected original-frame
indices, indented by 8.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List

import numpy as np

from vidsum_tpu_torch.config import Config
from vidsum_tpu_torch.data.collate import pad_batch
from vidsum_tpu_torch.ops.summary import generate_summary


def summaries_for_dataset(fwd: Callable, model, val_set, cfg: Config
                          ) -> Dict[str, List[int]]:
    """Per-video selected-frame indices keyed ``video_<enumeration index>``.
    ``fwd`` is ``train.steps.make_eval_forward``'s."""
    all_scores, users = [], []
    for i in range(len(val_set)):
        feats, target, user = val_set[i]
        n = feats.shape[0]
        x, _, mask = pad_batch([feats], [target], pad_value=cfg.data.pad_value,
                               bucket=cfg.data.length_bucket)
        pred = fwd(model, x, mask).float().cpu().numpy()[0, :n]
        all_scores.append(pred)
        users.append(user)

    summaries = generate_summary(
        [u.change_points for u in users], all_scores,
        [u.n_frames for u in users], [u.picks for u in users],
        budget_ratio=cfg.eval.budget_ratio)
    return {f"video_{i}": np.nonzero(s)[0].tolist()
            for i, s in enumerate(summaries)}


def write_summary_json(fwd: Callable, model, val_set, cfg: Config,
                       path: str = "summary.json") -> Dict[str, List[int]]:
    result = summaries_for_dataset(fwd, model, val_set, cfg)
    with open(path, "w") as f:
        json.dump(result, f, indent=8)
    return result

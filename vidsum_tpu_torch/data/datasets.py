# ported from vidsum_tpu/data/datasets.py (UserSummaries only; the h5
# datasets arrive with the data slice)
"""Per-video eval metadata."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class UserSummaries:
    """Per-video eval metadata (reference: dataset.py:146-154).
    ``user_scores`` is None for the eccv16-layout archives, which carry no
    per-annotator scores; tau/rho are then reported nan."""
    user_summary: np.ndarray    # (U, F) binary
    user_scores: Optional[np.ndarray]  # (U, F) or None
    change_points: np.ndarray   # (S, 2) inclusive bounds
    n_frames: int
    picks: np.ndarray           # (n_steps,) original-frame indices
    name: str

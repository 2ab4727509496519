# ported from vidsum_tpu/ops/segmentation.py
"""Video segmentation dispatch: uniform or KTS.

Reference: ``src/data/preprocess/segmentations/create_segments.py:7-63`` and
``uniform.py:4-19``. The reference's uniform mode returns segment *start
indices* (a 1-D array), not (S, 2) bounds; kept as is, with
:func:`starts_to_bounds` as the bridge to the eval pipeline's layout.
"""

from __future__ import annotations

import numpy as np

from vidsum_tpu_torch.ops.kts import kts_segmentation


def uniform_segmentation(n_frames: int, sec_per_seg: int = 2,
                         fps: int = 2) -> np.ndarray:
    """Uniform segment start indices: arange(0, n_frames, fps*sec_per_seg)."""
    return np.arange(start=0, stop=n_frames, step=fps * sec_per_seg)


def starts_to_bounds(starts: np.ndarray, n_frames: int) -> np.ndarray:
    """Convert 1-D start indices to inclusive (start, end) shot bounds."""
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.concatenate([starts[1:] - 1, [n_frames - 1]])
    return np.stack([starts, ends], axis=1)


def kts_seg(features: np.ndarray, num_seg: int, v_max: float,
            kernel: str = "dot") -> np.ndarray:
    """KTS change points from frame features via a dot-product Gram matrix
    (reference: ``create_segments.py:23-49``)."""
    if kernel != "dot":
        raise NotImplementedError(kernel)
    similarities = np.dot(features, features.T)
    segments, _costs = kts_segmentation(similarities, num_seg, v_max)
    return segments


def get_segment_fn(mode: str = "uniform"):
    """Segmentation dispatcher (reference: ``create_segments.py:7-21``)."""
    if mode == "uniform":
        return uniform_segmentation
    if mode == "kts":
        return kts_seg
    raise NotImplementedError(mode)

# ported from vidsum_tpu/preprocess/annotations.py
"""Raw-annotation readers for TVSum and SumMe.

Behavior contract (reference: ``src/data/preprocess/get_annotation.py``):
- TVSum ships one MATLAB-v7.3 file; each field is an h5 reference array that
  must be dereferenced per video (``get_tv_annotation``, :10-69``). Fields:
  category, gt_score (n_frames,), nframes, title, user_anno (20 users),
  video id.
- SumMe ships one ``<video>.mat`` per video (``get_summe_annotation``,
  :72-97``): gt_score (n_frames,), nFrames, user_score → (U, n_frames),
  segments.

The reference's TVSum path famously calls the SumMe reader
(``make_dataset.py:46``) — fixed here, both readers are explicit.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class VideoAnnotation:
    video_id: str
    gt_score: np.ndarray          # (n_frames,)
    n_frames: int
    user_anno: np.ndarray         # (U, n_frames); TVSum: 1-5 importance,
                                  # SumMe: 0/1 selections
    title: str = ""
    category: str = ""
    segments: Optional[np.ndarray] = None  # SumMe-provided user segments


def _deref_str(f, ref) -> str:
    return "".join(chr(c) for c in np.asarray(f[ref]).reshape(-1))


def read_tvsum_annotations(mat_path: str) -> Dict[str, VideoAnnotation]:
    """Read the ydata-tvsum50.mat (MATLAB v7.3) annotation file."""
    import h5py

    out: Dict[str, VideoAnnotation] = {}
    with h5py.File(mat_path, "r") as f:
        root = f["tvsum50"]
        n = root["video"].shape[0]
        for i in range(n):
            video_id = _deref_str(f, root["video"][i][0])
            gt = np.asarray(f[root["gt_score"][i][0]],
                            dtype=np.float32).reshape(-1)
            n_frames = int(np.asarray(f[root["nframes"][i][0]]).reshape(-1)[0])
            # stored (n_frames, U); expose (U, n_frames)
            anno = np.asarray(f[root["user_anno"][i][0]], dtype=np.float32)
            if anno.shape[0] == n_frames:
                anno = anno.T
            out[video_id] = VideoAnnotation(
                video_id=video_id, gt_score=gt, n_frames=n_frames,
                user_anno=anno,
                title=_deref_str(f, root["title"][i][0]),
                category=_deref_str(f, root["category"][i][0]))
    return out


def read_summe_annotations(gt_dir: str) -> Dict[str, VideoAnnotation]:
    """Read the SumMe GT directory of per-video .mat files."""
    from scipy import io

    out: Dict[str, VideoAnnotation] = {}
    for path in sorted(glob.glob(os.path.join(gt_dir, "*.mat"))):
        mat = io.loadmat(path)
        name = os.path.basename(path).rsplit(".", 1)[0]
        out[name] = VideoAnnotation(
            video_id=name,
            gt_score=np.asarray(mat["gt_score"], np.float32).reshape(-1),
            n_frames=int(np.asarray(mat["nFrames"]).reshape(-1)[0]),
            user_anno=np.asarray(mat["user_score"], np.float32).T,
            title=name,
            segments=np.asarray(mat["segments"]) if "segments" in mat else None)
    return out

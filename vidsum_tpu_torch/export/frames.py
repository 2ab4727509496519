# ported from vidsum_tpu/export/frames.py
"""Frame-image export helpers.

Behaviour (reference: ``src/generate_summary_image.py:23-36,123-166``):
``reduce_fps_and_save`` decodes a video, keeps every ``orig_fps // fps``-th
frame, converts BGR to RGB and writes ``movies/<video_name>/<i>.jpg``;
``generate_video_frames`` applies it to every video under a directory tree.
PIL and cv2 are imported where they are used.
"""

from __future__ import annotations

import glob
import logging
import os

import numpy as np

from vidsum_tpu_torch.preprocess import reduce_fps as _rf

logger = logging.getLogger(__name__)


def reduce_fps_and_save(video_path: str, fps: int = 2,
                        out_root: str = "movies") -> int:
    """Dump fps-reduced frames as JPEGs; returns the number written."""
    from PIL import Image

    name = os.path.basename(video_path).rsplit(".", 1)[0]
    out_dir = os.path.join(out_root, name)
    os.makedirs(out_dir, exist_ok=True)
    frames, _picks, _n = _rf.reduce_fps(video_path, fps=fps)
    for i, frame in enumerate(frames):
        Image.fromarray(np.asarray(frame)).save(
            os.path.join(out_dir, f"{i}.jpg"))
    return len(frames)


def generate_video_frames(video_dataset_path: str, fps: int = 2,
                          out_root: str = "movies") -> None:
    """Dump frames for every video under a directory (recursive)."""
    logger.info("Generating video frames as jpg")
    for path in glob.glob(video_dataset_path + "/**/*", recursive=True):
        if os.path.isfile(path):
            reduce_fps_and_save(path, fps=fps, out_root=out_root)

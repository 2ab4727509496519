# ported from vidsum_tpu/preprocess/reduce_fps.py
"""Video fps reduction via OpenCV.

Behavior contract (reference: ``src/data/preprocess/reduce_fps.py:7-56``):
decode with ``cv2.VideoCapture``, keep every ``orig_fps // fps``-th frame up
to ``n_frames * fps // orig_fps`` frames total, swap BGR→RGB, and return
``(frames (T, H, W, 3) uint8, picked original indices, original n_frames)``
— the ``picks`` / ``n_frames`` metadata the eval pipeline consumes.

:func:`iter_reduced_frames` is the lazy form — identical grab/retrieve
cadence, one frame in memory at a time — so the raw-video pipeline can
resize and ship each chunk to the device while later frames still decode
(the host-to-card copies ride under decode). :func:`reduce_fps` is a thin
eager wrapper over it. ``cv2`` is imported inside
:func:`iter_reduced_frames`; a caller without it (the card's machine) hands
the pipeline a :class:`ReducedStream` of its own frames instead.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class ReducedStream:
    """Lazily decoded reduced-fps video: ``frames`` yields contiguous RGB
    uint8 frames in pick order; metadata is available before decoding."""

    frames: Iterator[np.ndarray]
    n_frames: int      # original frame count (container metadata)
    step: int          # orig_fps // fps; pick i is original frame i*step
    final_count: int   # expected kept frames (n_frames * fps // orig_fps)
    height: int
    width: int
    cap: object = None  # cv2.VideoCapture when backed by a real decoder

    def picks(self, kept: int) -> np.ndarray:
        """Original-frame indices of the first ``kept`` yielded frames —
        THE picks contract (pick i is original frame i*step; the
        ``np.asarray`` of a Python int list reproduces the reference's
        eager loop exactly, including the float64 empty-list dtype
        corner)."""
        return np.asarray([i * self.step for i in range(kept)])

    def close(self) -> None:
        """Release the decoder immediately (otherwise it is released when
        the generator is exhausted or garbage-collected; a generator
        closed before its first next() never enters its body, so the
        capture handle is also released directly — release is
        idempotent)."""
        close = getattr(self.frames, "close", None)
        if close is not None:  # plain iterators (tests) have no close()
            close()
        if self.cap is not None:
            self.cap.release()


def iter_reduced_frames(video_path: str, fps: int = 2) -> ReducedStream:
    import cv2 as cv

    cap = cv.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_path}")
    n_frames = int(cap.get(cv.CAP_PROP_FRAME_COUNT))
    orig_fps = int(cap.get(cv.CAP_PROP_FPS))
    if orig_fps < fps:
        raise ValueError(f"video fps {orig_fps} below target {fps}")
    height = int(cap.get(cv.CAP_PROP_FRAME_HEIGHT))
    width = int(cap.get(cv.CAP_PROP_FRAME_WIDTH))

    final_count = n_frames * fps // orig_fps
    step = orig_fps // fps

    def gen() -> Iterator[np.ndarray]:
        idx = 0
        kept = 0
        ok = True
        try:
            while ok and kept != final_count:
                cap.grab()
                if idx % step == 0:
                    ok, bgr = cap.retrieve()
                    if not ok:
                        break
                    yield np.ascontiguousarray(bgr[:, :, ::-1])
                    kept += 1
                idx += 1
        finally:
            cap.release()

    return ReducedStream(frames=gen(), n_frames=n_frames, step=step,
                         final_count=final_count, height=height, width=width,
                         cap=cap)


def reduce_fps(video_path: str, fps: int = 2
               ) -> Tuple[np.ndarray, np.ndarray, int]:
    rs = iter_reduced_frames(video_path, fps)
    # fill a preallocated buffer (not list+stack): full-res frame stacks are
    # the peak-memory item of dataset builds, and stacking would double it
    arr = np.zeros((max(rs.final_count, 0), rs.height, rs.width, 3),
                   dtype=np.uint8)
    kept = 0
    try:
        for f in rs.frames:
            arr[kept] = f
            kept += 1
    finally:
        rs.close()
    return arr[:kept], rs.picks(kept), rs.n_frames

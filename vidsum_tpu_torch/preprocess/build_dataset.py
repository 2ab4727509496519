# ported from vidsum_tpu/preprocess/build_dataset.py
"""Offline dataset builder: raw videos + annotations → DSNet-schema h5.

Replaces the reference's ``src/data/preprocess/make_dataset.py`` orchestrator
(which executes at import with a hardcoded home path, calls the SumMe reader
on TVSum data at :46, and tars a temp dir whose feature extraction is
commented out — see SURVEY.md §2.3). This builder runs only when invoked,
writes the ``features / gtscore / user_summary / user_scores / change_points
/ n_frames / picks`` schema the training/eval stack reads
(``src/data/dataset.py:93-99``), and also emits the ``video/<name>.npy``
R3D-18 embeddings pretraining consumes.

Pipeline per video: OpenCV fps reduction → batched GoogLeNet pool5 on the
card → KTS (or uniform) shot segmentation in pick coordinates scaled
to original frames (the DSNet convention) → per-user ground-truth summaries
via the same 15%-knapsack machinery used at eval time. ``h5py`` and ``cv2``
are imported inside :func:`build_dataset` and the decoder; the card's
machine has neither, so there the extraction and the entry fields
(:func:`entry_from_features`) run without them.
"""

from __future__ import annotations

import glob
import io
import logging
import os
import pickle
import tarfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from vidsum_tpu_torch.ops.knapsack import knapsack
from vidsum_tpu_torch.ops.kts import change_points_from_cps, kts_segmentation
from vidsum_tpu_torch.ops.segmentation import (
    starts_to_bounds, uniform_segmentation,
)
from vidsum_tpu_torch.preprocess import reduce_fps as _rf
from vidsum_tpu_torch.preprocess.annotations import VideoAnnotation
from vidsum_tpu_torch.preprocess.extract import FeatureExtractor
from vidsum_tpu_torch.preprocess.transforms import resize_shorter_side

logger = logging.getLogger(__name__)

ACCEPTED_VIDEO_FORMATS = ("mp4", "mkv", "mpeg", "avi", "webm")


def segment_video(features: np.ndarray, n_frames: int, picks: np.ndarray,
                  mode: str = "kts", fps: int = 2,
                  max_cp: Optional[int] = None) -> np.ndarray:
    """Shot bounds (S, 2) inclusive, in ORIGINAL frame coordinates."""
    n_picks = features.shape[0]
    if mode == "uniform":
        starts = uniform_segmentation(n_picks, fps=fps)
        bounds = starts_to_bounds(starts, n_picks)
    elif mode == "kts":
        gram = features @ features.T
        ncp = max_cp if max_cp is not None else max(n_picks // 25, 1)
        cps, _ = kts_segmentation(gram, ncp, vmax=1.0)
        bounds = change_points_from_cps(cps, n_picks)
    else:
        raise ValueError(mode)
    # pick coords → original frame coords (DSNet convention)
    ratio = n_frames / n_picks
    starts = np.round(bounds[:, 0] * ratio).astype(np.int64)
    ends = np.concatenate([starts[1:] - 1, [n_frames - 1]])
    return np.stack([starts, ends], axis=1)


def user_summaries_from_scores(user_anno: np.ndarray,
                               change_points: np.ndarray, n_frames: int,
                               budget_ratio: float = 0.15) -> np.ndarray:
    """Binary per-user summaries from per-frame user scores via the same
    shot-knapsack used at eval (how the eccv16 files were constructed)."""
    U = user_anno.shape[0]
    out = np.zeros((U, n_frames), dtype=np.int8)
    lengths = (change_points[:, 1] - change_points[:, 0] + 1).tolist()
    budget = int(n_frames * budget_ratio)
    for u in range(U):
        scores = user_anno[u][:n_frames]
        values = [float(scores[s:e + 1].mean()) for s, e in change_points]
        for shot in knapsack(budget, lengths, values):
            s, e = change_points[shot]
            out[u, s:e + 1] = 1
    return out


def build_video_entry(frames: np.ndarray, picks: np.ndarray, n_frames: int,
                      annotation: Optional[VideoAnnotation],
                      google: FeatureExtractor,
                      r3d: Optional[FeatureExtractor] = None,
                      seg_mode: str = "kts", fps: int = 2) -> Dict:
    """All h5 fields for one video (+ optional 'video_rep')."""
    features = google.frames(frames)
    video_rep = r3d.clip(frames) if r3d is not None else None
    return entry_from_features(features, video_rep, picks, n_frames,
                               annotation, seg_mode, fps)


def entry_from_features(features: np.ndarray, video_rep,
                        picks: np.ndarray, n_frames: int,
                        annotation: Optional[VideoAnnotation],
                        seg_mode: str = "kts", fps: int = 2) -> Dict:
    """h5 fields from already-extracted features (the streaming build path
    — :func:`build_video_entry` is the eager array-in wrapper)."""
    change_points = segment_video(features, n_frames, picks, seg_mode, fps)
    entry: Dict = {
        "features": features.astype(np.float32),
        "change_points": change_points,
        "n_frames": np.int64(n_frames),
        "picks": picks.astype(np.int64),
        "n_steps": np.int64(len(picks)),
    }
    if annotation is not None:
        gt = annotation.gt_score[:n_frames]
        entry["gtscore"] = gt[np.minimum(picks, len(gt) - 1)].astype(np.float32)
        user_scores = annotation.user_anno[:, :n_frames].astype(np.float32)
        if np.isin(user_scores, (0.0, 1.0)).all():
            user_summary = user_scores.astype(np.int8)  # SumMe: binary already
        else:
            user_summary = user_summaries_from_scores(user_scores,
                                                      change_points, n_frames)
        entry["user_scores"] = user_scores
        entry["user_summary"] = user_summary
    if video_rep is not None:
        entry["video_rep"] = video_rep
    return entry


def write_packaging_tar(tar_path: str,
                        packaging: Dict[str, Dict],
                        video_reps: List[Tuple[str, np.ndarray]]) -> None:
    """The reference's dataset *packaging* artifact (optional — VERDICT r3
    #7): a ``.tar.gz`` holding an ``annotations`` pickle (one dict per
    video: the annotation fields plus ``n_steps`` / ``picks`` /
    ``change_points``, ``make_dataset.py:100-113``) and the R3D-18 clip
    embeddings under ``features/video/<name>.npy``
    (``make_dataset.py:146-174``).

    Deliberate divergences from ``make_dataset.py:109-130`` (PARITY.md
    "packaging path"): members use RELATIVE arcnames (``make_tar:118-128``
    walks a ``tempfile.mkdtemp()`` and adds files under their absolute
    ``/tmp/...`` paths — unusable members, and nothing in the reference
    ever reads the tar back); the archive is written in-memory from the
    build loop instead of via a temp-dir + ``shutil.rmtree`` dance; and
    the annotations pickle is included for BOTH datasets (the reference's
    TVSum variant has the pickling commented out and is crash-prone:
    import-time execution, hardcoded home path, SumMe reader on TVSum
    data, ``make_dataset.py:46,189``)."""
    os.makedirs(os.path.dirname(tar_path) or ".", exist_ok=True)

    def add_bytes(tar, name, payload: bytes):
        info = tarfile.TarInfo(name)
        info.size = len(payload)
        tar.addfile(info, io.BytesIO(payload))

    with tarfile.open(tar_path, "w:gz") as tar:
        add_bytes(tar, "annotations", pickle.dumps(packaging))
        for name, rep in video_reps:
            buf = io.BytesIO()
            np.save(buf, rep)
            add_bytes(tar, f"features/video/{name}.npy", buf.getvalue())


def _packaging_record(entry: Dict,
                      annotation: Optional[VideoAnnotation]) -> Dict:
    """One video's ``annotations``-pickle dict: the reference's namedtuple
    ``_asdict()`` fields (``get_annotation.py:19,81``) plus the three
    extras ``make_dataset.py:104-106`` adds."""
    rec: Dict = {
        "n_steps": int(entry["n_steps"]),
        "picks": entry["picks"],
        "change_points": entry["change_points"],
        "n_frame": int(entry["n_frames"]),
    }
    if annotation is not None:
        rec.update(
            gt_score=annotation.gt_score,
            title=annotation.title,
            user_anno=annotation.user_anno,
            video_id=annotation.video_id,
            category=annotation.category,
        )
    return rec


def build_dataset(video_dir: str, out_h5: str,
                  annotations: Optional[Dict[str, VideoAnnotation]] = None,
                  fps: int = 2, seg_mode: str = "kts",
                  google_weights: Optional[str] = None,
                  r3d_weights: Optional[str] = None,
                  with_video_rep: bool = False,
                  video_rep_dir: Optional[str] = None,
                  tar_path: Optional[str] = None, *, device=None) -> int:
    """Build a DSNet-schema h5 from a directory of videos. Returns the number
    of videos written; keys are ``video_0 … video_{n-1}`` in sorted filename
    order, with the source name recorded in ``video_name``. ``tar_path``
    additionally writes the reference's packaging artifact
    (:func:`write_packaging_tar`). The extractors run on ``device``
    (default: the CUDA card)."""
    import h5py

    google = FeatureExtractor("google", weights=google_weights, device=device)
    r3d = (FeatureExtractor("r3d18", weights=r3d_weights, device=device)
           if with_video_rep else None)

    paths = sorted(p for p in glob.glob(os.path.join(video_dir, "*"))
                   if p.rsplit(".", 1)[-1].lower() in ACCEPTED_VIDEO_FORMATS)
    os.makedirs(os.path.dirname(out_h5) or ".", exist_ok=True)
    if video_rep_dir:
        os.makedirs(video_rep_dir, exist_ok=True)

    written = 0
    packaging: Dict[str, Dict] = {}
    video_reps: List[Tuple[str, np.ndarray]] = []
    with h5py.File(out_h5, "w") as f:
        for i, path in enumerate(paths):
            name = os.path.basename(path).rsplit(".", 1)[0]
            anno = annotations.get(name) if annotations else None
            # streaming decode: the raw reduced-fps frame stack (tens of
            # GB for an hour of 1080p) is never materialized — each frame
            # is resized as it decodes, GoogLeNet features accumulate per
            # batch, and only the small 112-side resize is kept for R3D
            rs = _rf.iter_reduced_frames(path, fps=fps)
            r3d_buf: list = []

            def tee(frames_iter, sink):
                for fr in frames_iter:
                    if r3d is not None:
                        sink.append(resize_shorter_side(fr, 112))
                    yield fr

            try:
                features = google.frames_stream(tee(rs.frames, r3d_buf))
            finally:
                rs.close()
            if features.shape[0] == 0:
                logger.warning("skipping empty video %s", path)
                continue
            picks, n_frames = rs.picks(features.shape[0]), rs.n_frames
            video_rep = (r3d.clip_resized(np.stack(r3d_buf))
                         if r3d is not None else None)
            del r3d_buf
            entry = entry_from_features(features, video_rep, picks, n_frames,
                                        anno, seg_mode, fps)
            key = f"video_{i}"
            g = f.create_group(key)
            for field, value in entry.items():
                if field == "video_rep":
                    continue
                g[field] = value
            g["video_name"] = np.bytes_(name)
            if r3d is not None and video_rep_dir:
                np.save(os.path.join(video_rep_dir, f"{key}.npy"),
                        entry["video_rep"])
            if tar_path:
                packaging[name] = _packaging_record(entry, anno)
                if "video_rep" in entry:
                    video_reps.append((name, entry["video_rep"]))
            written += 1
            logger.info("wrote %s (%s): %d picks / %d frames", key, name,
                        len(picks), n_frames)
    if tar_path:
        write_packaging_tar(tar_path, packaging, video_reps)
        logger.info("wrote packaging tar %s (%d videos)", tar_path, written)
    return written

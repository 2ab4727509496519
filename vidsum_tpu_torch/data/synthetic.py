# ported from vidsum_tpu/data/synthetic.py
"""Synthetic DSNet-layout fixtures.

Tiny h5 datasets with the key schema the real DSNet files carry
(``features, gtscore, user_summary, user_scores, change_points, n_frames,
picks``; the reference reads them at ``src/data/dataset.py:93-99``), with
``gtscore`` a sigmoid of a fixed linear probe of the features so that a
short training run can show learning. The numbers are the JAX package's:
the same draws from the same ``numpy.random.default_rng(seed)``. ``h5py``
is imported by :func:`make_synthetic_h5` only.
"""

from __future__ import annotations

import os

import numpy as np


def make_synthetic_h5(path: str, n_videos: int = 6, n_users: int = 5,
                      min_picks: int = 60, max_picks: int = 120,
                      frame_step: int = 15, feature_dim: int = 1024,
                      seed: int = 0, layout: str = "summarizer") -> None:
    """Write a DSNet-schema h5 file with learnable scores.

    ``layout="summarizer"`` is the clean schema. ``layout="eccv16"`` has the
    real archives' quirks: ``picks`` stored ``(n_steps, 1)`` int64
    (reference ``compute_metrics.py:24``; the readers flatten it),
    ``user_summary`` / ``gtsummary`` float64 0/1, ``change_points``
    alternating int64/int32 across videos, the extra keys real files carry
    (``n_steps``, ``gtsummary``, ``n_frame_per_seg``, ``video_name``), and
    no ``user_scores`` (only the ``summarizer_dataset_*`` files carry it),
    so tau/rho are nan.
    """
    import h5py

    if layout not in ("summarizer", "eccv16"):
        raise ValueError(f"unknown layout {layout!r}")
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # a fixed linear probe makes gtscore a deterministic function of features
    probe = rng.normal(size=(feature_dim,)).astype(np.float32) / np.sqrt(
        feature_dim)

    with h5py.File(path, "w") as f:
        for vi in range(n_videos):
            n_picks = int(rng.integers(min_picks, max_picks + 1))
            picks = np.arange(n_picks) * frame_step
            n_frames = int(picks[-1] + rng.integers(1, frame_step + 1))

            feats = rng.normal(size=(n_picks, feature_dim)).astype(np.float32)
            logits = feats @ probe
            gtscore = (1 / (1 + np.exp(-logits))).astype(np.float32)

            # contiguous shots covering [0, n_frames)
            n_shots = int(rng.integers(4, 9))
            cuts = np.sort(rng.choice(np.arange(1, n_frames),
                                      size=n_shots - 1, replace=False))
            bounds = np.concatenate([[0], cuts, [n_frames]])
            change_points = np.stack([bounds[:-1], bounds[1:] - 1], axis=1)

            frame_scores = np.repeat(gtscore, frame_step)[:n_frames]
            user_scores = np.clip(
                frame_scores[None] + 0.1 * rng.normal(size=(n_users,
                                                            n_frames)),
                0, None).astype(np.float32)
            thresh = np.quantile(frame_scores, 0.85)
            base_summary = (frame_scores >= thresh).astype(np.int8)
            user_summary = np.stack([
                base_summary ^ (rng.random(n_frames) < 0.05).astype(np.int8)
                for _ in range(n_users)])

            g = f.create_group(f"video_{vi}")
            g["features"] = feats
            g["gtscore"] = gtscore
            if layout == "summarizer":
                g["user_summary"] = user_summary
                g["user_scores"] = user_scores
                g["change_points"] = change_points
                g["n_frames"] = np.int64(n_frames)
                g["picks"] = picks
            else:  # the eccv16 archives' byte layout
                g["user_summary"] = user_summary.astype(np.float64)
                cp_dtype = np.int64 if vi % 2 == 0 else np.int32
                g["change_points"] = change_points.astype(cp_dtype)
                g["n_frames"] = np.int64(n_frames)
                g["picks"] = picks.reshape(-1, 1).astype(np.int64)
                g["n_steps"] = np.int64(n_picks)
                g["gtsummary"] = base_summary[
                    np.clip(picks, 0, n_frames - 1)].astype(np.float64)
                g["n_frame_per_seg"] = (change_points[:, 1]
                                        - change_points[:, 0]
                                        + 1).astype(np.int64)
                g["video_name"] = np.bytes_(f"synthetic_{vi}.mp4")


def make_synthetic_pretrain_tree(root: str, n_videos: int = 8,
                                 min_frames: int = 40, max_frames: int = 90,
                                 feature_dim: int = 1024,
                                 rep_dim: int = 512, seed: int = 0) -> None:
    """Write the ``frames/*.npy`` + ``video/*.npy`` tree of the pretraining
    data (reference: dataset.py:40-60)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "frames"), exist_ok=True)
    os.makedirs(os.path.join(root, "video"), exist_ok=True)
    proj = rng.normal(size=(feature_dim, rep_dim)).astype(np.float32)
    for vi in range(n_videos):
        n = int(rng.integers(min_frames, max_frames + 1))
        feats = rng.normal(size=(n, feature_dim)).astype(np.float32)
        rep = (feats.mean(0) @ proj).astype(np.float32)
        np.save(os.path.join(root, "frames", f"video_{vi}.npy"), feats)
        np.save(os.path.join(root, "video", f"video_{vi}.npy"), rep)

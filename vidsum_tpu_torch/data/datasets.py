# ported from vidsum_tpu/data/datasets.py
"""The finetune datasets over the DSNet h5 files, per-video eval metadata,
and the pretraining datasets.

Behaviour (reference: ``src/data/dataset.py``): a ``val`` split of
:class:`TSDataset` loads ``features, gtscore, user_summary, user_scores,
change_points, n_frames, picks`` per video of the experiment dataset,
wrapping the eval metadata in :class:`UserSummaries` (dataset.py:85-103). A
``train`` split concatenates all ``"+"``-joined datasets, restricts only the
experiment dataset to the fold's keys, and drops videos with <=
``min_frames`` frames (dataset.py:105-119). Everything is loaded eagerly
into numpy arrays (a whole dataset's features fit in memory); ``h5py`` is
imported when a dataset is built, never by importing this module.

The pretraining datasets hold ``(frame features (n, D) f32, video rep (512,)
f32)`` pairs: :class:`PreTrainDataset` from a ``frames/*.npy`` +
``video/<name>.npy`` tree (numpy only), :class:`PreTrainDatasetReady` from
the DSNet h5 files' features with ``video/<dataset>/<key>.npy`` reps.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional, Sequence

import numpy as np

from vidsum_tpu_torch.data.paths import h5_name
from vidsum_tpu_torch.data.splits import split_keys_to_names


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


class TSDataset:
    """Finetune dataset over DSNet h5 files. Items are ``(features (n, D)
    f32, gtscore (n,) f32)`` in the train split and ``(features, gtscore,
    UserSummaries)`` in the val split."""

    def __init__(self, root: str, ex_dataset: str, datasets: str,
                 keys: Optional[Sequence[str]] = None, split: str = "train",
                 min_frames: int = 50, path_scheme: str = "summarizer"):
        import h5py

        self.root = root
        self.split = split
        self.ex_dataset = ex_dataset
        self.datasets = datasets.split("+")

        self.features: List[np.ndarray] = []
        self.targets: List[np.ndarray] = []
        self.user_summaries: List[UserSummaries] = []

        wanted = split_keys_to_names(list(keys)) if keys else None

        if split == "val":
            path = os.path.join(root, h5_name(ex_dataset, path_scheme))
            with h5py.File(path, "r") as f:
                for name in (wanted if wanted else list(f.keys())):
                    g = f[name]
                    self.features.append(g["features"][...].astype(np.float32))
                    self.targets.append(g["gtscore"][...].astype(np.float32))
                    self.user_summaries.append(UserSummaries(
                        user_summary=np.asarray(g["user_summary"]),
                        user_scores=(np.asarray(g["user_scores"])
                                     if "user_scores" in g else None),
                        change_points=np.asarray(g["change_points"]),
                        n_frames=int(np.asarray(g["n_frames"]).reshape(())),
                        # the eccv16 archives store picks (n_steps, 1)
                        picks=np.asarray(g["picks"]).reshape(-1),
                        name=name))
        else:
            for dataset in self.datasets:
                path = os.path.join(root, h5_name(dataset, path_scheme))
                with h5py.File(path, "r") as f:
                    names = (wanted if wanted and dataset == ex_dataset
                             else list(f.keys()))
                    for name in names:
                        g = f[name]
                        feats = g["features"][...].astype(np.float32)
                        if feats.shape[0] > min_frames:
                            self.features.append(feats)
                            self.targets.append(
                                g["gtscore"][...].astype(np.float32))

    def __len__(self) -> int:
        return len(self.features)

    def __getitem__(self, idx: int):
        if self.split == "train":
            return self.features[idx], self.targets[idx]
        return self.features[idx], self.targets[idx], self.user_summaries[idx]


class PreTrainDataset:
    """Frame-feature + video-embedding pairs from a ``.npy`` tree: every
    ``frames/<name>.*`` file in sorted order, with ``video/<name>.npy``
    (``<name>`` is the file name up to its first dot)."""

    def __init__(self, root: str):
        self.items = []
        for frame_path in sorted(glob.glob(os.path.join(root, "frames", "*"))):
            video_name = os.path.basename(frame_path).split(".")[0]
            feats = np.load(frame_path).astype(np.float32)
            rep = np.load(os.path.join(root, "video", f"{video_name}.npy"))
            self.items.append((feats, rep.astype(np.float32)))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int):
        return self.items[idx]


class PreTrainDatasetReady:
    """Frame features straight from the DSNet h5 files of each
    ``"+"``-joined dataset (keys in file order) with the per-key video reps
    ``video/<dataset>/<key>.npy``."""

    def __init__(self, root: str, datasets: str,
                 path_scheme: str = "summarizer"):
        import h5py

        self.items = []
        for dataset in datasets.split("+"):
            rep_dir = os.path.join(root, "video", dataset)
            with h5py.File(os.path.join(root, h5_name(dataset, path_scheme)),
                           "r") as f:
                for key in f.keys():
                    feats = f[key]["features"][...].astype(np.float32)
                    rep = np.load(os.path.join(rep_dir, f"{key}.npy"))
                    self.items.append((feats, rep.astype(np.float32)))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int):
        return self.items[idx]

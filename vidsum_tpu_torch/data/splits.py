# ported from vidsum_tpu/data/splits.py
"""DSNet 5-fold split configs.

Reference: ``src/splits_dsnet/*.yaml`` loaded at ``src/train.py:205-212``: a
list of ``{train_keys, test_keys}`` folds whose entries are
``<path>/eccv16_dataset_<ds>_google_pool5.h5/video_N`` strings; the data
layer keeps only the trailing ``video_N`` component
(``src/data/dataset.py:133-136``). The bundled ``splits_dsnet/*.json`` are
byte-identical copies of the JAX package's. As in the reference,
``tvsum.json`` and ``summe.json`` hold the same (SumMe) keys; whatever file
is named is loaded.
"""

from __future__ import annotations

import os
from pathlib import PurePosixPath
from typing import Dict, List

from vidsum_tpu_torch.utils.io import load_json, load_yaml

SPLIT_DIR = os.path.join(os.path.dirname(__file__), "splits_dsnet")


def split_keys_to_names(keys: List[str]) -> List[str]:
    """``..._pool5.h5/video_7`` -> ``video_7`` (dataset.py:133-136)."""
    return [PurePosixPath(k).name for k in keys]


def load_splits(path: str) -> List[Dict[str, List[str]]]:
    """Load a split file (.json, or .yaml through ``yaml``) into a list of
    fold dicts."""
    if path.endswith(".json"):
        return load_json(path)
    return load_yaml(path)


def builtin_split_path(dataset: str) -> str:
    """Path to the bundled DSNet split file of ``tvsum``, ``summe``,
    ``tvsum_aug`` or ``summe_aug``."""
    return os.path.join(SPLIT_DIR, f"{dataset}.json")

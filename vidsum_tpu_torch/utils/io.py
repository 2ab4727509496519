# ported from vidsum_tpu/utils/io.py
"""Config-file loaders (reference: ``src/utils/utils.py:28-42``). ``yaml``
is imported only by :func:`load_yaml`: the JSON split files need nothing
beyond the standard library."""

from __future__ import annotations

import json


def load_yaml(path: str):
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)

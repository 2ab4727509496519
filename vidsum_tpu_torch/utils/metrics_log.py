# ported from vidsum_tpu/utils/metrics_log.py
"""Structured metrics logging: one JSON line per record with a timestamp
(``ts``), so runs are machine-readable; an optional wandb sink is imported
only when asked for and only if importable (the reference imports wandb but
never initialises it, ``src/train.py:3,104``)."""

from __future__ import annotations

import json
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None,
                 use_wandb: bool = False, wandb_name: str = ""):
        self.path = path
        self._fh = open(path, "a") if path else None
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project="vidsum_tpu", name=wandb_name or None)
            except Exception:
                self._wandb = None

    def log(self, record: Dict, step: Optional[int] = None) -> None:
        record = {"ts": time.time(), **record}
        if step is not None:
            record["step"] = step
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self._wandb:
            self._wandb.log(record, step=step)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
        if self._wandb:
            self._wandb.finish()

# ported from vidsum_tpu/utils/meters.py
"""Running accumulators (reference: ``src/utils/utils.py:15-25``)."""

from __future__ import annotations


class AverageMeter:
    """Sum/count accumulator with the reference's ``update(val, num)`` API."""

    def __init__(self) -> None:
        self.val = 0.0
        self.num = 0

    def update(self, val: float, num: int = 1) -> None:
        self.val += val
        self.num += num

    def avg(self) -> float:
        return self.val / self.num

    def reset(self) -> None:
        self.val = 0.0
        self.num = 0

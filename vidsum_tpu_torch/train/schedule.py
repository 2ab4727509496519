# ported from vidsum_tpu/train/schedule.py
"""Learning-rate schedules.

Behaviour (reference: ``src/schedular.py:4-25``): linear warm-up over
``warmup_epochs * steps_per_epoch`` steps, then cosine decay to 0 over the
remaining steps, as a multiplier on the base learning rate.

Reference quirks kept:
- ``steps_per_epoch`` comes from a hardcoded 13,000-sample numerator, not the
  dataset's length (``src/pretrain.py:37``); callers pass it in.
- The scheduler's ``update()`` runs *after* the optimizer step
  (``src/pretrain.py:70``) and applies ``scale(step)`` before incrementing,
  so the learning rates the updates see are ``[base, base * scale(0) = 0,
  base * scale(1), ...]``: the first update takes the base rate and the
  second takes 0. :func:`reference_pretrain_schedule` gives that sequence
  as a function of the number of updates already taken.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_warmup_scale(step: int, warmup_steps: int,
                        total_steps: int) -> float:
    """The reference's ``get_scale`` (schedular.py:13-18)."""
    if warmup_steps > step:
        return step / warmup_steps
    decay_steps = total_steps - warmup_steps
    ratio = (step - warmup_steps) / decay_steps
    return 0.5 * (1 + math.cos(ratio * math.pi))


def reference_pretrain_schedule(base_lr: float, steps_per_epoch: int,
                                warmup_epochs: int, epochs: int
                                ) -> Callable[[int], float]:
    """The learning rate of update ``count`` (the number of updates taken
    before it), with the reference's off-by-one: ``base_lr`` at 0, then
    ``base_lr * scale(count - 1)`` (0 at count 1)."""
    total = steps_per_epoch * epochs
    warmup = warmup_epochs * steps_per_epoch
    decay_steps = max(total - warmup, 1)

    def schedule(count: int) -> float:
        if count == 0:
            return base_lr
        prev = count - 1
        if prev < warmup:
            scale = prev / warmup
        else:
            scale = 0.5 * (1 + math.cos((prev - warmup) / decay_steps
                                        * math.pi))
        return base_lr * scale

    return schedule

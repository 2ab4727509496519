"""The numbers that decide ``correct``: each is a gap between what the
system under test produced and what the plain reference computes from the
same inputs, and each has a limit of its own in the cell's traffic file.

Training: the first three steps' losses (relative gap), and per leaf the
norm of the first gradient as the optimizer took it and the norm of the
parameters' change over the three steps, the gap between the two sides'
norms measured against the reference's norm of that leaf or of the median
leaf, whichever is larger (see :func:`training` for which leaf). Leaves
whose reference gradient is under a thousandth of the median leaf's (a
key's bias under softmax has none) move by round-off alone and are left
out.

Serving: the largest gap of a served score from the reference's, and the
number of requests whose summary differs from the one the reference
selects from the served scores themselves.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List

LEAF_FLOOR = 1e-3


def worst(values: Iterable[float]) -> float:
    """The largest value; infinite when any is not finite."""
    vals = list(values)
    if not vals or any(not math.isfinite(v) for v in vals):
        return math.inf
    return max(vals)


def moving_leaves(grad_raw: Dict[str, float]) -> List[str]:
    med = statistics.median(grad_raw.values())
    return [k for k, v in grad_raw.items() if v >= LEAF_FLOOR * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> List[float]:
    med = statistics.median(ref[k] for k in leaves)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves]


def training(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (three floats), ``grad`` and
    ``delta`` (leaf name -> norm); ``ref`` also ``grad_raw``. A cell's
    traffic file names which of these numbers it compares (its
    ``limits``): ``loss`` (the worst of the three steps) or ``loss_first``
    (the first step's, where the later steps' losses swing from seed to
    seed); ``grad`` (the worst leaf) or ``grad_median`` (the median
    leaf's gap, where the worst leaf swings); ``update_median`` (the
    median leaf's gap: a leaf of a few hundred entries swings, since
    Adam's first steps move an entry whose gradient is within rounding of
    0 by a whole learning rate either way)."""
    leaves = moving_leaves(ref["grad_raw"])
    losses = [abs(a - b) / abs(b)
              for a, b in zip(prog["losses"], ref["losses"])]
    grad = leaf_gaps(prog["grad"], ref["grad"], leaves)
    update = leaf_gaps(prog["delta"], ref["delta"], leaves)
    return {"loss": worst(losses), "loss_first": worst(losses[:1]),
            "grad": worst(grad), "grad_median": median(grad),
            "update_median": median(update)}


def median(values: List[float]) -> float:
    """The median; infinite when any value is not finite."""
    if not values or any(not math.isfinite(v) for v in values):
        return math.inf
    return statistics.median(values)


def training_readings(prog: dict, ref: dict) -> dict:
    """The readings behind :func:`training` that no cell compares, for
    setting its limits: each step's loss gap, the worst leaf's change and
    the worst leaves, and the leaves left out."""
    leaves = moving_leaves(ref["grad_raw"])
    grad = leaf_gaps(prog["grad"], ref["grad"], leaves)
    update = leaf_gaps(prog["delta"], ref["delta"], leaves)
    return {"loss_steps": [abs(a - b) / abs(b) for a, b in
                           zip(prog["losses"], ref["losses"])],
            "update_worst": worst(update),
            "grad_worst_leaf": leaves[grad.index(max(grad))],
            "update_worst_leaf": leaves[update.index(max(update))],
            "left_out": sorted(set(ref["grad_raw"]) - set(leaves))}

"""Operation counts of PGL-SUM's forward (``reference/pglsum.py``), from a
configuration and the true (unpadded) lengths of the videos a call covers.

Only the arithmetic the model needs is counted: padded rows, and the
segments' padding, are not, so a count is the same whatever route does the
work. A product of an (m, k) by a (k, n) matrix counts 2mkn. The position
bias's sines and cosines, the softmax and the normalisations are not
counted as work.

A video of T rows at width d, ``num_segments`` S of length t_m (the last
ones shorter or empty: ``segment_lengths``):

- attention: ``4 d T^2`` (global Q.K^T and P.V over all heads) plus
  ``4 (d / S) sum t_m^2`` (local);
- per row: global Q/K/V ``6 d^2`` and ``out`` ``2 d^2``, local Q/K/V
  ``6 d^2 / S`` and ``out`` ``2 d^2 / S``, ``linear_1`` ``2 d^2``,
  ``linear_2`` ``2 d``.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np


def segment_lengths(T: int, segments: int) -> List[int]:
    """Rows of each segment of a T-row video: ceil(T / S) each, the last
    ones what is left (possibly none)."""
    size = -(-T // segments)
    return [max(0, min(size, T - m * size)) for m in range(segments)]


def attention_forward(cfg: dict, lengths: Iterable[int]) -> float:
    """Q.K^T and P.V of the global and local attention, all heads, valid
    queries x keys."""
    d, S = cfg["in_features"], cfg["num_segments"]
    total = 0.0
    for T in lengths:
        T = int(T)
        total += 4.0 * d * T * T
        total += 4.0 * (d // S) * sum(t * t for t in segment_lengths(T, S))
    return total


def dense_forward(cfg: dict, lengths: Iterable[int]) -> float:
    """Every product of a row: the branches' projections, the regressor."""
    d, S = cfg["in_features"], cfg["num_segments"]
    per_row = 10 * d * d + 8 * d * (d // S) + 2 * d
    return float(per_row * np.asarray(list(lengths), np.float64).sum())


def model_forward(cfg: dict, lengths: Iterable[int]) -> float:
    lengths = list(lengths)
    return dense_forward(cfg, lengths) + attention_forward(cfg, lengths)

"""Operation counts of SimNet's work, from a configuration and the true
(unpadded) lengths of the videos or clips a call covers.

Only the arithmetic the model needs is counted: padded rows and keys, and
work a kernel does twice (the backward's recompute), are not, so a count is
the same whatever kernel or route does the work. A product of an (m, k) by
a (k, n) matrix counts 2mkn.

Per frame of a video of n frames, one layer's forward has the Q/K/V, output
and MLP products, ``2 * d * d * (4 + 2 * mlp_scale)``, and its attention
``4 * d * n`` (Q.K^T and P.V over the n unpadded keys, all heads). A
backward costs twice its forward, except the embed's, which needs no input
gradient and so costs once its forward (its weight gradient).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

VIDEO_REP_DIM = 512


def _lens(lengths: Iterable[int]) -> np.ndarray:
    return np.asarray(list(lengths), dtype=np.float64)


def attention_forward(cfg: dict, lengths: Iterable[int]) -> float:
    """Q.K^T and P.V of every layer, all heads, valid queries x keys."""
    n = _lens(lengths)
    return float(cfg["num_layers"] * 4 * cfg["d_model"] * (n * n).sum())


def block_forward(cfg: dict, lengths: Iterable[int]) -> float:
    """Every encoder block's forward: products and attention."""
    n = _lens(lengths)
    d, m = cfg["d_model"], cfg["mlp_scale"]
    dense = cfg["num_layers"] * 2 * d * d * (4 + 2 * m) * n.sum()
    return float(dense) + attention_forward(cfg, lengths)


def embed_forward(cfg: dict, lengths: Iterable[int]) -> float:
    n = _lens(lengths).sum()
    return float(2 * cfg["in_features"] * cfg["d_model"] * n)


def head_forward(cfg: dict, lengths: Iterable[int]) -> float:
    n = _lens(lengths).sum()
    return float(2 * cfg["d_model"] * cfg["num_classes"] * n)


def model_forward(cfg: dict, lengths: Iterable[int]) -> float:
    """The scorer's forward: embed, blocks, head."""
    lengths = list(lengths)
    return (embed_forward(cfg, lengths) + block_forward(cfg, lengths)
            + head_forward(cfg, lengths))


def block_train(cfg: dict, lengths: Iterable[int]) -> float:
    """Forward and backward of every encoder block."""
    return 3 * block_forward(cfg, lengths)


def attention_train(cfg: dict, lengths: Iterable[int]) -> float:
    """Forward and backward of every layer's attention (the backward's
    dV, dP, dQ and dK products: twice the forward)."""
    return 3 * attention_forward(cfg, lengths)


def video_transform_forward(cfg: dict, lengths: Iterable[int]) -> float:
    """The pretraining's frozen video transform (d -> 512)."""
    return float(2 * cfg["d_model"] * VIDEO_REP_DIM * _lens(lengths).sum())


def pretrain_losses_forward(cfg: dict, lengths: Iterable[int]) -> float:
    """The frames' cosine similarities and the score-weighted mixture of
    the pretraining losses."""
    n = _lens(lengths)
    return float((2 * VIDEO_REP_DIM * n * (n + 1)).sum())


def train_step(cfg: dict, lengths: Iterable[int],
               pretrain: bool = False) -> float:
    """A training step's model operations over the batch's true lengths:
    forward and backward of blocks, head and (pretraining) losses; the
    embed's forward and weight gradient; the frozen video transform's
    forward and input gradient."""
    lengths = list(lengths)
    total = (2 * embed_forward(cfg, lengths) + block_train(cfg, lengths)
             + 3 * head_forward(cfg, lengths))
    if pretrain:
        total += (2 * video_transform_forward(cfg, lengths)
                  + 3 * pretrain_losses_forward(cfg, lengths))
    return total

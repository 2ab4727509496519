"""Plain float32 PGL-SUM, written from the equations of the public code
(e-apostolidis/PGL-SUM, ``model/layers/summarizer.py`` and
``model/layers/attention.py``; Apostolidis et al., "Combining Global and
Local Attention with Positional Encoding for Video Summarization", IEEE ISM
2021), under its module tree and state-dict names, one video at a time as
the published model runs:

- ``SelfAttention``: per head h, ``E_h = Q_h K_h^T + P_T`` (no scaling;
  ``P_T`` the absolute position bias below), ``Y_h = softmax(E_h) V_h``, the
  heads concatenated and through ``out`` (no biases anywhere);
- ``MultiAttention``: a global ``SelfAttention`` over the whole video, and
  ``num_segments`` local ones (4 heads each, their own weights) over
  segments of ``ceil(T / num_segments)`` rows, positions restarting at 0;
  each segment's rows of the global output and its local output are
  L2-normalised row by row and added (fusion ``add``);
- ``PGLSum``: ``Y = LN_y(F + X)``, ``Z = LN_lin(ReLU(linear_1(Y)))``,
  ``score = sigmoid(linear_2(Z))``, LayerNorm eps 1e-6; dropout (0.5 in
  training) is absent at inference.

``P_T[p, 2j] = sin(p / f ** (2j / d))``, ``P_T[p, 2j + 1] = cos(...)`` for
``j < T // 2`` with ``f`` = 10,000 and ``d`` = 1,024 (the input width, also
in the local branch), the power taken in float32 as the public code takes
it (past ``2j`` ~ 9,860 it overflows to inf: sin 0 and cos 0); the last
column of an odd ``T`` is 0. Products run with TF32 off unless a caller asks
for it (the benchmark's control). The heads are looped over as the public
code loops over them. Nothing of the system under test is imported.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter's name and shape, in the public module order (each
    ``SelfAttention`` registers ``Wk``, ``Wq``, ``Wv``, then ``out``)."""
    d = cfg["in_features"]
    shapes = {}

    def self_attention(pre: str, out_size: int, heads: int) -> None:
        for w in ("Wk", "Wq", "Wv"):
            for h in range(heads):
                shapes[f"{pre}.{w}.{h}.weight"] = (out_size // heads, d)
        shapes[f"{pre}.out.weight"] = (d, out_size)

    self_attention("attention.attention", d, cfg["num_heads"])
    for m in range(cfg["num_segments"]):
        self_attention(f"attention.local_attention.{m}",
                       d // cfg["num_segments"], cfg["local_heads"])
    shapes["linear_1.weight"] = (d, d)
    shapes["linear_1.bias"] = (d,)
    shapes["linear_2.weight"] = (1, d)
    shapes["linear_2.bias"] = (1,)
    for ln in ("norm_y", "norm_linear"):
        shapes[ln + ".weight"] = (d,)
        shapes[ln + ".bias"] = (d,)
    return shapes


class SelfAttention(nn.Module):
    def __init__(self, input_size: int, output_size: int, freq: int,
                 heads: int):
        super().__init__()
        self.input_size, self.freq, self.heads = input_size, freq, heads
        self.Wk, self.Wq, self.Wv = (nn.ModuleList(), nn.ModuleList(),
                                     nn.ModuleList())
        for _ in range(heads):
            for w in (self.Wk, self.Wq, self.Wv):
                w.append(nn.Linear(input_size, output_size // heads,
                                   bias=False))
        self.out = nn.Linear(output_size, input_size, bias=False)

    def absolute_position(self, T: int) -> torch.Tensor:
        """The (T, T) bias, built as the public code builds it."""
        dev = self.out.weight.device
        pos = torch.arange(T, device=dev)
        i = torch.arange(T // 2, device=dev)
        pos = pos.reshape(T, 1).repeat_interleave(i.shape[0], dim=1)
        i = i.repeat(T, 1)
        ap = torch.zeros(T, T, device=dev)
        ap[pos, 2 * i] = torch.sin(
            pos / self.freq ** ((2 * i) / self.input_size))
        ap[pos, 2 * i + 1] = torch.cos(
            pos / self.freq ** ((2 * i) / self.input_size))
        return ap

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ap = self.absolute_position(x.shape[0])
        outputs = []
        for head in range(self.heads):
            K = self.Wk[head](x)
            Q = self.Wq[head](x)
            V = self.Wv[head](x)
            energies = torch.matmul(Q, K.transpose(1, 0)) + ap
            att = torch.softmax(energies, dim=-1)
            outputs.append(torch.matmul(att, V))
        return self.out(torch.cat(outputs, dim=1))


class MultiAttention(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, segs = cfg["in_features"], cfg["num_segments"]
        self.num_segments = segs
        self.attention = SelfAttention(d, d, cfg["pos_freq"],
                                       cfg["num_heads"])
        self.local_attention = nn.ModuleList(
            [SelfAttention(d, d // segs, cfg["pos_freq"], cfg["local_heads"])
             for _ in range(segs)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.attention(x)
        size = math.ceil(x.shape[0] / self.num_segments)
        for m in range(self.num_segments):
            lo, hi = m * size, (m + 1) * size
            local_x = x[lo:hi]
            if local_x.shape[0] == 0:
                continue
            local = self.local_attention[m](local_x)
            y[lo:hi] = (F.normalize(y[lo:hi].clone(), p=2, dim=1)
                        + F.normalize(local, p=2, dim=1))
        return y


class PGLSum(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["in_features"]
        self.attention = MultiAttention(cfg)
        self.linear_1 = nn.Linear(d, d)
        self.linear_2 = nn.Linear(d, 1)
        self.norm_y = nn.LayerNorm(d, eps=LN_EPS)
        self.norm_linear = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """One video's features (T, d) -> its sigmoid scores (T,)."""
        y = self.norm_y(self.attention(x) + x)
        z = self.norm_linear(torch.relu(self.linear_1(y)))
        return torch.sigmoid(self.linear_2(z))[:, 0]


def build(cfg: dict, weights: Dict[str, torch.Tensor], device
          ) -> PGLSum:
    """The reference module on ``device`` with ``weights`` (public names)."""
    model = PGLSum(cfg).to(device)
    model.load_state_dict(weights)
    return model.eval()


def scores(model: PGLSum, x: torch.Tensor, tf32: bool = False
           ) -> torch.Tensor:
    """``model``'s scores of one video ``x`` (T, d), with TF32 products
    only where ``tf32`` asks for them (the control's precision)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.no_grad():
            return model(x.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was

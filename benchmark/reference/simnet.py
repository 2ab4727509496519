"""Plain float32 SimNet, written from the published scorer
(BerserkerMother/Video-Summarization ``src/model/simnet.py``): a Linear
embed ``in_features -> d_model`` plus the sinusoidal positional encoding,
``num_layers`` post-LN encoder blocks (multi-head self-attention scaled by
``d_model ** -0.5`` with a key pad mask, then ``LN(drop(x') + x)``; a ReLU
MLP of ``mlp_scale * d_model``), and a Linear head to one logit.

Parameters are a dict keyed by the published state-dict names
(``embedding_layer.feature_transform.weight``,
``encoder.module_list.{i}.sa.q.weight``, ``...mlp.fc1.weight``,
``...norm1.weight``, ``final_layer.weight``, ...).

Attention runs in blocks of query rows, so that a 14,400-frame video fits;
with autograd on, each block is checkpointed and recomputed in the backward.
Training dropout follows a :class:`DropoutPlan`: which bits are kept is the
system's documented contract (``hashes.py`` and the draw order below), not
something this module reads from the system under test.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import hashes

LN_EPS = 1e-5
# elements of one block of attention scores (B x H x rows x N)
BLOCK_ELEMS = 1 << 26


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter's name and shape, in the published module order."""
    d, f = cfg["d_model"], cfg["in_features"]
    hidden = cfg["mlp_scale"] * d
    shapes = {"embedding_layer.feature_transform.weight": (d, f),
              "embedding_layer.feature_transform.bias": (d,)}
    for i in range(cfg["num_layers"]):
        pre = f"encoder.module_list.{i}."
        for lin in ("sa.q", "sa.k", "sa.v", "sa.feature_projection"):
            shapes[pre + lin + ".weight"] = (d, d)
            shapes[pre + lin + ".bias"] = (d,)
        shapes[pre + "mlp.fc1.weight"] = (hidden, d)
        shapes[pre + "mlp.fc1.bias"] = (hidden,)
        shapes[pre + "mlp.fc2.weight"] = (d, hidden)
        shapes[pre + "mlp.fc2.bias"] = (d,)
        for ln in ("norm1", "norm2"):
            shapes[pre + ln + ".weight"] = (d,)
            shapes[pre + ln + ".bias"] = (d,)
    shapes["final_layer.weight"] = (cfg["num_classes"], d)
    shapes["final_layer.bias"] = (cfg["num_classes"],)
    return shapes


def positional_encoding(n: int, d: int, device) -> torch.Tensor:
    """sin at even and cos at odd columns of pos * 10000 ** (-2i / d)."""
    angle = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=device) * math.log(10000.0) / d)
    pos = torch.arange(0, n, dtype=torch.float32, device=device)[:, None]
    pe = torch.zeros((n, d), device=device)
    pe[:, 0::2] = torch.sin(pos * angle)
    pe[:, 1::2] = torch.cos(pos * angle)
    return pe


class DropoutPlan:
    """Training dropout of one forward, drawn from a CPU ``torch.Generator``
    as the system documents it (``SimNet.forward_steps``): each layer's seed
    is ``torch.randint(0, 2**31 - 1)`` of the generator, drawn as the layer
    starts.

    ``route`` ``"block"``: every site takes the block family's hash bits
    with the layer's seed (attention weights at site h, the residuals at
    32 / 34, the MLP at 33) and kept values are multiplied by
    float32(1 / (1 - rate)). ``"flash"``: the attention weights take the
    attention family's bits with the layer's seed; the residual and MLP
    sites keep where a uniform draw lies below ``1 - rate`` and kept values
    are divided by ``1 - rate``, drawn in the order res1, mlp, res2 of each
    layer. On a card the draws come from a card generator seeded by one
    ``torch.randint(0, 2**63 - 1)`` of the CPU generator, taken at the first
    draw; on the CPU from the CPU generator itself."""

    def __init__(self, route: str, rate: float, generator: torch.Generator,
                 device):
        if route not in ("block", "flash"):
            raise ValueError(f"unknown dropout route {route!r}")
        self.route, self.rate, self.gen = route, rate, generator
        self.device = torch.device(device)
        self._draw_gen = None

    def layer_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.gen))

    def draw(self, shape) -> torch.Tensor:
        if self._draw_gen is None:
            if self.device.type == "cuda":
                seed = int(torch.randint(0, 2**63 - 1, (1,),
                                         generator=self.gen))
                self._draw_gen = torch.Generator(
                    device=self.device).manual_seed(seed)
            else:
                self._draw_gen = self.gen
        return torch.rand(shape, generator=self._draw_gen,
                          device=self._draw_gen.device)


def _linear(p, name, x):
    return torch.matmul(x, p[name + ".weight"].t()) + p[name + ".bias"]


def _attention_rows(q, k, v, key_pad, scale, keep):
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    s = s.masked_fill(key_pad[:, None, None, :], float("-inf"))
    prob = torch.softmax(s, dim=-1)
    if keep is not None:
        mask, factor = keep
        prob = torch.where(mask, prob * factor, 0.0)
    return torch.matmul(prob, v)


def attention(q, k, v, key_pad, scale: float,
              keep_fn: Optional[Callable] = None) -> torch.Tensor:
    """Softmax attention over (B, H, N, Dh) in blocks of query rows;
    ``keep_fn(r0, rows)`` gives the (mask, factor) of a block's weights."""
    B, H, N, _ = q.shape
    rows = max(1, min(N, BLOCK_ELEMS // (B * H * N)))
    grad = torch.is_grad_enabled()
    out = []
    for r0 in range(0, N, rows):
        r = min(rows, N - r0)

        def run(qb, kk, vv, r0=r0, r=r):
            keep = keep_fn(r0, r) if keep_fn is not None else None
            return _attention_rows(qb, kk, vv, key_pad, scale, keep)

        qb = q[:, :, r0:r0 + r]
        out.append(checkpoint(run, qb, k, v, use_reentrant=False) if grad
                   else run(qb, k, v))
    return torch.cat(out, dim=2)


def _attention_keep_fn(plan: DropoutPlan, seed: int, B: int, H: int, N: int,
                       device):
    ar = lambda n, off=0: torch.arange(  # noqa: E731
        n, dtype=torch.int64, device=device) + off
    factor = hashes.keep_scale(plan.rate)

    def keep(r0, rows):
        b, h = ar(B)[:, None, None, None], ar(H)[None, :, None, None]
        qi = ar(rows, r0)[None, None, :, None]
        ki = ar(N)[None, None, None, :]
        if plan.route == "block":
            mask = hashes.block_keep(seed, h, b, qi, ki, plan.rate)
        else:
            mask = hashes.attention_keep(seed, b, h, qi, ki, plan.rate)
        return mask, factor

    return keep


def forward(p: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor,
            pad_mask: torch.Tensor, plan: Optional[DropoutPlan] = None):
    """Scores (B, N) (the logits, before any sigmoid) and the last hidden
    states (B, N, d) of x (B, N, in_features) with pad_mask (B, N) bool,
    True at padded frames. ``plan`` None is the eval forward."""
    B, N, _ = x.shape
    d, H = cfg["d_model"], cfg["num_heads"]
    Dh = d // H
    scale = d ** -0.5 if cfg["scale_by_d_model"] else Dh ** -0.5
    dev = x.device
    h = _linear(p, "embedding_layer.feature_transform", x)
    h = h + positional_encoding(N, d, dev)[None]
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)  # noqa
    for i in range(cfg["num_layers"]):
        pre = f"encoder.module_list.{i}."
        q, k, v = (_linear(p, pre + "sa." + n, h).view(B, N, H, Dh)
                   .transpose(1, 2) for n in ("q", "k", "v"))
        seed = (plan.layer_seed() if plan is not None and plan.rate > 0.0
                else None)
        keep_fn = (_attention_keep_fn(plan, seed, B, H, N, dev)
                   if seed is not None else None)
        a = attention(q, k, v, pad_mask, scale, keep_fn)
        a = _linear(p, pre + "sa.feature_projection",
                    a.transpose(1, 2).reshape(B, N, d))

        def drop(t, site):
            if plan is None or plan.rate == 0.0:
                return t
            if plan.route == "block":
                cols = ar(t.shape[-1])[None, None, :]
                mask = hashes.block_keep(seed, torch.tensor(site),
                                         ar(B)[:, None, None],
                                         ar(N)[None, :, None], cols,
                                         plan.rate)
                return torch.where(mask, t * hashes.keep_scale(plan.rate),
                                   0.0)
            keep = 1.0 - plan.rate
            mask = plan.draw(tuple(t.shape)) < keep
            return torch.where(mask.to(t.device), t / keep, 0.0)

        h = F.layer_norm(drop(a, hashes.SITE_RES1) + h, (d,),
                         p[pre + "norm1.weight"], p[pre + "norm1.bias"],
                         LN_EPS)
        m = drop(torch.relu(_linear(p, pre + "mlp.fc1", h)), hashes.SITE_MLP)
        m = _linear(p, pre + "mlp.fc2", m)
        h = F.layer_norm(drop(m, hashes.SITE_RES2) + h, (d,),
                         p[pre + "norm2.weight"], p[pre + "norm2.bias"],
                         LN_EPS)
    scores = _linear(p, "final_layer", h)[..., 0]
    return scores, h

"""PGL-SUM, the global-plus-local attention scorer, as a PyTorch module.

Behaviour (Apostolidis et al., "Combining Global and Local Attention with
Positional Encoding for Video Summarization", IEEE ISM 2021; public code
e-apostolidis/PGL-SUM, ``model/layers/summarizer.py`` and
``model/layers/attention.py``; the equations below were written from that
code). One video is X (T, d), d = ``cfg.in_features`` (1,024):

- global branch: ``num_heads`` heads of d / heads over the whole video,
  ``E_h = Q_h K_h^T + P_T`` (no scaling), ``Y_h = softmax(E_h) V_h``, the
  heads concatenated through ``out``; no biases;
- local branch: segment m of ``num_segments`` is rows ``[m s, min((m+1) s,
  T))``, s = ceil(T / num_segments) (a segment may be empty); each has its
  own ``local_heads`` heads over d / num_segments columns and its own
  ``out`` (d x d / num_segments), and runs the global branch's equations on
  its own rows with positions restarting at 0 (``P_{t_m}``);
- ``P_T[p, 2j] = sin(p / f ** (2j / d))``, ``P_T[p, 2j + 1] = cos(...)``
  for j < T // 2, 0 elsewhere (the last column of an odd T), f =
  ``pos_freq``, the power in float32 (``ops.attention.position_bias``);
- ``F = n(G) + n(L)`` row by row, ``n(v) = v / max(|v|_2, 1e-12)``
  (fusion ``add``); ``Y = LN_y(F + X)``; ``Z = LN_lin(ReLU(Y W1^T +
  b1))``; logit ``Z w2^T + b2`` (``make_eval_forward`` applies the
  sigmoid); LayerNorm eps 1e-6.

Module names follow the public state dict
(``attention.attention.W{q,k,v}.{h}``, ``attention.attention.out``,
``attention.local_attention.{m}...``, ``linear_1``, ``linear_2``,
``norm_y``, ``norm_linear``), so a published checkpoint loads by name.

``forward(x, pad_mask, attn_impl=)`` takes a padded batch (B, N, d) whose
pad mask leaves each video's first T rows: every video gets its own T, its
own segment boundaries and its own bias, and rows past T are never read as
keys. Routes:

    ``"dense"``                   plain PyTorch, one video at a time (the
                                  CPU default)
    ``"flash"``, ``"fused_block"`` the kernel route (the CUDA default)

The kernel route runs every product through ``gemm_bias_epilogue`` (the
port's f32 GEMM), the attention of both branches through
``ops.attention.masked_attention_posbias`` (``fma_fwd_posbias_kernel``: the
bias computed per score from each element's length, nothing of size T x T
allocated) and the fusion and LayerNorms through ``ops.row_norms``; the
local branch gathers each video's segments into ``num_segments x B``
attention elements of ceil(N / num_segments) rows, its products one launch
per segment's weights over all videos, and gathers the outputs back. No
step mixes rows of two videos, so a video's scores do not depend on the
batch it is served in. On CPU tensors the same route runs the wrappers'
plain versions. Inference only, in f32: training, bf16, the int8 routes, a
caller's attention (``attn_fn``, the ring), the relative encoding and the
other fusions raise ``ValueError``.

While spans are kept (``utils.profiling``), a forward records
``pglsum.forward`` (from the batch on the device to the forward's last
launch). Counters on the class: ``PGLSum.forwards``; ``PGLSum.launches``,
the kernel route's launches of the port's kernels and GEMMs (counted on
the CPU too, where the wrappers run their plain versions; the index and
gather steps between them are torch's); ``PGLSum.segments()``, the
non-empty segments scored: a forward leaves its count on its device and
only the read waits for it, so counting adds no synchronisation to a
forward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.device import resolve_device
from vidsum_tpu_torch.ops.attention import (
    attention_posbias_reference, masked_attention_posbias, position_bias_den,
)
from vidsum_tpu_torch.ops.block_kernel import cached, gemm_bias_epilogue
from vidsum_tpu_torch.ops.row_norms import (
    fuse_layernorm, fuse_layernorm_reference, layernorm_, layernorm_reference,
)
from vidsum_tpu_torch.utils import profiling

ATTN_IMPLS = ("dense", "flash", "fused_block")
LN_EPS = 1e-6
# the bias table's least length, so that den[j] is always read from the
# same table (a 16,384-row video needs 8,192 entries)
DEN_MIN = 8192


def check_config(cfg: ModelConfig) -> None:
    """The settings PGL-SUM takes (the published ones and other widths):
    ``ValueError`` for anything else."""
    if cfg.arch != "pglsum":
        raise ValueError(f"PGLSum needs cfg.arch 'pglsum', got {cfg.arch!r}")
    if cfg.pos_enc != "absolute":
        raise ValueError(f"PGLSum implements the absolute position "
                         f"encoding only, got pos_enc {cfg.pos_enc!r}")
    if cfg.fusion != "add":
        raise ValueError(f"PGLSum implements fusion 'add' only, got "
                         f"{cfg.fusion!r}")
    if cfg.compute_dtype != "float32":
        raise ValueError(f"PGLSum scores in float32 only, got "
                         f"{cfg.compute_dtype!r}")
    d = cfg.in_features
    if cfg.d_model != d:
        raise ValueError(f"PGLSum's width is its input's: d_model "
                         f"{cfg.d_model} != in_features {d}")
    if d % cfg.num_heads or d % cfg.num_segments or (
            (d // cfg.num_segments) % cfg.local_heads):
        raise ValueError(f"in_features {d} must divide into num_heads "
                         f"{cfg.num_heads}, and into num_segments "
                         f"{cfg.num_segments} of local_heads "
                         f"{cfg.local_heads}")


class SelfAttention(nn.Module):
    """One multi-head attention of PGL-SUM: per-head ``Wk``, ``Wq``,
    ``Wv`` (d -> out_size / heads, no bias) and ``out`` (out_size -> d)."""

    def __init__(self, input_size: int, output_size: int, heads: int):
        super().__init__()
        self.heads = heads
        self.Wk, self.Wq, self.Wv = (nn.ModuleList(), nn.ModuleList(),
                                     nn.ModuleList())
        for _ in range(heads):
            for w in (self.Wk, self.Wq, self.Wv):
                w.append(nn.Linear(input_size, output_size // heads,
                                   bias=False))
        self.out = nn.Linear(output_size, input_size, bias=False)

    def packed_qkv(self) -> torch.Tensor:
        """(3 out_size, d): the q heads, then k's, then v's, head h of each
        at rows h * out_size / heads."""
        return torch.cat([lin.weight for w in (self.Wq, self.Wk, self.Wv)
                          for lin in w])


class MultiAttention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, segs = cfg.in_features, cfg.num_segments
        self.attention = SelfAttention(d, d, cfg.num_heads)
        self.local_attention = nn.ModuleList(
            [SelfAttention(d, d // segs, cfg.local_heads)
             for _ in range(segs)])


@dataclasses.dataclass(frozen=True)
class PackedWeights:
    """The weights as the kernel route takes them: f32, contiguous."""

    g_qkv: torch.Tensor    # (3d, d)
    g_out: torch.Tensor    # (d, d)
    l_qkv: torch.Tensor    # (S, 3 d / S, d)
    l_out: torch.Tensor    # (S, d, d / S)
    zeros: torch.Tensor    # (3d,): the bias of the bias-free products
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    ln_y: Tuple[torch.Tensor, torch.Tensor]
    ln_lin: Tuple[torch.Tensor, torch.Tensor]


def _pack(model: "PGLSum") -> PackedWeights:
    f = lambda t: t.detach().float().contiguous()  # noqa: E731
    att = model.attention
    with torch.no_grad():
        return PackedWeights(
            g_qkv=f(att.attention.packed_qkv()),
            g_out=f(att.attention.out.weight),
            l_qkv=f(torch.stack([a.packed_qkv()
                                 for a in att.local_attention])),
            l_out=f(torch.stack([a.out.weight
                                 for a in att.local_attention])),
            zeros=torch.zeros(3 * model.cfg.in_features,
                              device=model.linear_1.weight.device),
            w1=f(model.linear_1.weight), b1=f(model.linear_1.bias),
            w2=f(model.linear_2.weight), b2=f(model.linear_2.bias),
            ln_y=(f(model.norm_y.weight), f(model.norm_y.bias)),
            ln_lin=(f(model.norm_linear.weight), f(model.norm_linear.bias)))


class PGLSum(nn.Module):
    """The scorer. Linear weights and biases start U(+-1/sqrt(fan_in)) from
    ``generator`` (default: seed 0), LayerNorms at ones and zeros."""

    forwards = 0
    launches = 0
    # per device, the forwards' non-empty segment counts not yet read
    _segment_counts: Dict[str, List[torch.Tensor]] = {}

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        d = cfg.in_features
        self.attention = MultiAttention(cfg)
        self.linear_1 = nn.Linear(d, d)
        self.linear_2 = nn.Linear(d, 1)
        self.norm_y = nn.LayerNorm(d, eps=LN_EPS)
        self.norm_linear = nn.LayerNorm(d, eps=LN_EPS)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    bound = 1.0 / math.sqrt(mod.in_features)
                    mod.weight.uniform_(-bound, bound, generator=generator)
                    if mod.bias is not None:
                        mod.bias.uniform_(-bound, bound, generator=generator)
        self.to(resolve_device(device))
        self._den = {}

    def den(self, count: int, device) -> torch.Tensor:
        """The position bias's table (``position_bias_den``), at least
        ``count`` long, cached per device."""
        table = self._den.get(str(device))
        if table is None or table.numel() < count:
            table = position_bias_den(max(count, DEN_MIN),
                                      self.cfg.in_features,
                                      self.cfg.pos_freq, device)
            self._den[str(device)] = table
        return table

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                *, attn_impl: Optional[str] = None, deterministic: bool = True,
                generator=None, block_seeds=None, return_attn: bool = False,
                attn_fn=None):
        """Score x (B, N, d) with pad_mask (B, N) bool, True at padded rows
        (each video's valid rows first). Returns ``(logits (B, N, 1) f32,
        hidden Z (B, N, d))``; rows past a video's length hold no score.
        SimNet's training and ring keywords are taken only to refuse
        them."""
        if attn_impl is None:
            attn_impl = "fused_block" if x.device.type == "cuda" else "dense"
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"PGLSum's attn_impl is one of {ATTN_IMPLS}, "
                             f"got {attn_impl!r}")
        if not deterministic or generator is not None \
                or block_seeds is not None:
            raise ValueError("PGLSum scores only (deterministic=True): its "
                             "training is not ported")
        if return_attn or attn_fn is not None:
            raise ValueError("PGLSum returns no attention maps and takes no "
                             "caller-supplied attention (the ring)")
        x = x.float()
        B, N, _ = x.shape
        if pad_mask is None:
            lens = torch.full((B,), N, dtype=torch.int64, device=x.device)
        else:
            lens = N - pad_mask.to(x.device).sum(dim=1)
        with profiling.span("pglsum.forward"):
            w = cached(self, "pglsum", _pack)
            route = self._dense if attn_impl == "dense" else self._kernels
            logits, hidden, seg_lens = route(w, x, lens)
        PGLSum.forwards += 1
        counts = PGLSum._segment_counts.setdefault(str(x.device), [])
        counts.append((seg_lens > 0).sum())
        if len(counts) > 64:
            counts[:] = [torch.stack(counts).sum()]
        return logits, hidden

    @classmethod
    def segments(cls) -> int:
        """The non-empty segments scored by every forward so far (waits for
        the forwards' counts on their devices)."""
        return sum(int(c) for counts in cls._segment_counts.values()
                   for c in counts)

    # ---------------------------------------------------------- the routes

    def _seg_lengths(self, lens: torch.Tensor) -> torch.Tensor:
        """(S, B) rows of each video's segments."""
        S = self.cfg.num_segments
        size = (lens + S - 1) // S
        m = torch.arange(S, device=lens.device)[:, None]
        return torch.minimum((lens[None, :] - m * size[None, :]).clamp(min=0),
                             size[None, :])

    def _dense(self, w: PackedWeights, x: torch.Tensor, lens: torch.Tensor):
        """Plain PyTorch, one video at a time on its own rows."""
        cfg = self.cfg
        B, N, d = x.shape
        S = cfg.num_segments
        logits = torch.zeros((B, N, 1), device=x.device)
        hidden = torch.zeros((B, N, d), device=x.device)
        lens_h = lens.tolist()
        den = self.den((max(lens_h) + 1) // 2, x.device)
        for b, T in enumerate(lens_h):
            xv = x[b, :T]
            g = _attend(xv, w.g_qkv, w.g_out, cfg.num_heads, den)
            loc = torch.zeros_like(g)
            size = -(-T // S)
            for m in range(S):
                lo, hi = m * size, min((m + 1) * size, T)
                if lo < hi:
                    loc[lo:hi] = _attend(xv[lo:hi], w.l_qkv[m], w.l_out[m],
                                         cfg.local_heads, den)
            y = fuse_layernorm_reference(g, loc, xv, *w.ln_y, LN_EPS)
            z = layernorm_reference(torch.relu(y @ w.w1.t() + w.b1),
                                    *w.ln_lin, LN_EPS)
            hidden[b, :T] = z
            logits[b, :T] = z @ w.w2.t() + w.b2
        return logits, hidden, self._seg_lengths(lens)

    def _kernels(self, w: PackedWeights, x: torch.Tensor,
                 lens: torch.Tensor):
        """The kernel route: the branches' 2 + 2 S GEMMs and 2 attention
        launches, the regressor's 2 GEMMs and 3 row launches (the fusion,
        two LayerNorms): 17 launches at S = 4."""
        cfg = self.cfg
        B, N, d = x.shape
        S, dev = cfg.num_segments, x.device
        H, LH = cfg.num_heads, cfg.local_heads
        dl = d // S
        den = self.den((N + 1) // 2, dev)
        x2 = x.reshape(B * N, d).contiguous()

        def gemm(a, wt, bias, epilogue="none", out=None):
            PGLSum.launches += 1
            return gemm_bias_epilogue(a, wt, bias, epilogue, out=out)[0]

        def attend(qkv, lengths, out, heads, hd):
            PGLSum.launches += 1
            n = qkv.shape[1]
            q, k, v = (qkv.view(-1, n, 3, heads, hd)[:, :, i].transpose(1, 2)
                       for i in range(3))
            masked_attention_posbias(
                q, k, v, lengths, den,
                out=out.view(-1, n, heads, hd).transpose(1, 2))

        # the global branch over every video's rows
        qkv = gemm(x2, w.g_qkv, w.zeros)
        att = torch.empty((B * N, d), device=dev)
        attend(qkv.view(B, N, 3 * d), lens, att.view(B, N, d), H, d // H)
        g = gemm(att, w.g_out, w.zeros[:d])

        # the local branch: segment m of video b is attention element
        # m B + b, its rows r < t[m, b] those of video rows m size_b + r
        Sl = -(-N // S)
        size = ((lens + S - 1) // S).clamp(min=1)
        t = self._seg_lengths(lens)
        vids = torch.arange(B, device=dev)
        m = torch.arange(S, device=dev)
        src = ((vids * N)[None, :, None]
               + (m[:, None] * size[None, :])[..., None]
               + torch.arange(Sl, device=dev)[None, None, :])
        src = torch.minimum(src, (vids * N + N - 1)[None, :, None])
        xs = x2.index_select(0, src.reshape(-1)).view(S, B * Sl, d)
        qkv_l = torch.empty((S, B * Sl, 3 * dl), device=dev)
        for i in range(S):
            gemm(xs[i], w.l_qkv[i], w.zeros[:3 * dl], out=qkv_l[i])
        att_l = torch.empty((S, B * Sl, dl), device=dev)
        attend(qkv_l.view(S * B, Sl, 3 * dl), t.reshape(-1),
               att_l.view(S * B, Sl, dl), LH, dl // LH)
        loc_s = torch.empty((S, B * Sl, d), device=dev)
        for i in range(S):
            gemm(att_l[i], w.l_out[i], w.zeros[:d], out=loc_s[i])
        p = torch.arange(N, device=dev)[None, :]
        seg = (p // size[:, None]).clamp(max=S - 1)
        row = (p - seg * size[:, None]).clamp(max=Sl - 1)
        back = (seg * B + vids[:, None]) * Sl + row
        loc = loc_s.view(S * B * Sl, d).index_select(0, back.reshape(-1))

        # fusion, residual, regressor
        y = fuse_layernorm(g, loc, x2, *w.ln_y, LN_EPS)
        z = layernorm_(gemm(y, w.w1, w.b1, "relu"), *w.ln_lin, LN_EPS)
        PGLSum.launches += 3
        logits = gemm(z, w.w2, w.b2)
        return logits.view(B, N, 1), z.view(B, N, d), t


def _attend(x: torch.Tensor, wqkv: torch.Tensor, wout: torch.Tensor,
            heads: int, den: torch.Tensor) -> torch.Tensor:
    """One video's (T, d) multi-head position-biased attention, plain."""
    T = x.shape[0]
    hd = wqkv.shape[0] // (3 * heads)
    qkv = (x @ wqkv.t()).view(T, 3, heads, hd).permute(1, 2, 0, 3)
    lens = torch.tensor([T], device=x.device)
    out = attention_posbias_reference(qkv[0][None], qkv[1][None],
                                      qkv[2][None], lens, den)[0]
    return out.transpose(0, 1).reshape(T, heads * hd) @ wout.t()

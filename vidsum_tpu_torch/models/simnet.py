# ported from vidsum_tpu/models/simnet.py
"""SimNet, the transformer frame-importance scorer, as a PyTorch module.

Behaviour (reference: ``src/model/simnet.py``): Linear embed 1024 -> d_model
plus a sinusoidal positional encoding (and an optional CLS token), then
``num_layers`` post-LN encoder blocks, then a Linear head d_model ->
num_classes. Attention is scaled by ``d_model**-0.5``; the pad mask is a key
mask broadcast over heads and queries; blocks are ``LN(sub(x) + x)`` with
LayerNorm eps 1e-5 and biased variance. ``forward`` returns
``(scores, hidden)``.

Module names follow the reference's state-dict keys
(``embedding_layer.feature_transform``, ``encoder.module_list.{i}.sa.q``,
``.mlp.fc1``, ``.norm1``, ``final_layer``), so a reference ``model_mae.pth``
(without its PE buffer, which is recomputed here in closed form) and weights
converted from the JAX package (``models/convert.py``) load as they are.

``attn_impl`` names and their JAX counterparts:

    ``"dense"``        <-> ``"xla"``            plain PyTorch attention
    ``"flash"``        <-> ``"pallas"``         ops/attention.flash_attention
    ``"fused_block"``  <-> ``"pallas_block"``   ops/block_kernel.fused_encoder_block
    ``"int8_dense"``   <-> ``"int8_xla"``       ops/quant.int8_encoder_block_dense
    ``"int8_block"``   <-> ``"int8_block"``     ops/block_kernel_int8.fused_encoder_block_int8

The default is ``"fused_block"`` on CUDA and ``"dense"`` on the CPU. The
ladder is the JAX package's: ``"fused_block"`` demotes to ``"flash"`` when
``fused_block_supported`` is False, and ``"flash"`` picks its single-pass or
key-folded route by ``flash_attention``'s arithmetic. Embed, PE, head and
sigmoid are plain PyTorch, as are the projections, MLP and LayerNorms around
the attention kernel on the ``"flash"`` route; on CUDA the embed and head
run through ``gemm_bias_epilogue`` so that a row's scores do not depend on
the batch it was served in (cuBLAS picks its algorithm by shape).

The int8 routes are the JAX package's opt-in lossy W8A8 scorer
(``simnet.py:235-311``): inference only, post-LN only, no ``return_attn``,
no ``attn_fn`` (each a ``ValueError`` with the JAX message). Before the
embed, ``"int8_block"`` demotes to ``"int8_dense"`` when the sequence
(with the CLS token) is not a multiple of 128, and past
``fused_block_int8_supported`` leaves quantisation for ``"flash"``
(lossless). The embed runs through ``ops/quant.int8_linear``, rounded to the
compute dtype, each block on its ``quantize_block`` codes (cached per
parameter version), the head as on the other routes. On CUDA every int8
product (embed, dense route, kernels) runs on ``csrc/int8_gemm.cu``, whose
integer sums are exact, so a row's scores do not depend on its batch.

Training (``deterministic=False``) follows the JAX package's routes: on
``"fused_block"`` every block runs ``ops/block_train.fused_block_train``
(TPU kernels 9-12) with one dropout seed per layer. Past
``fused_block_train_supported`` (N > 7,936 at d 256) it demotes to
``"flash"``, where each block runs plain projections, LayerNorms and MLP
(with autograd) around ``ops/attention_train.flash_attention_dropout``
(TPU kernels 5-8: dropout on the attention weights inside the kernels, one
seed per layer), post-LN or ``norm_first``. ``"dense"`` and ``return_attn``
run plain PyTorch with dropout on the attention weights. Dropout after the
MLP's ReLU and on both residual branches of those routes is drawn from the
generator: for CUDA inputs on the card, from a card generator seeded by one
draw of it. Injected ``dropout_masks`` replace those draws (on ``"flash"``
the attention keeps its in-kernel dropout and the ``"attn"`` masks are
ignored, as in the JAX package; ``"fused_block"`` with masks runs the dense
route). Embed, PE and head are plain autograd in training (the JAX package
computes them outside Pallas too).

A caller-supplied attention (``attn_fn``: the sequence-parallel ring of
``parallel/``, one shard per call at its global ``pos_offset``) replaces the
attention of every layer, which then runs the plain route around it; with
``dropout_masks`` whose ``"attn"`` entries are None the ring draws the
attention dropout itself, as in the JAX package's seq-sharded step.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.device import dtype_of, resolve_device
from vidsum_tpu_torch.ops.attention import attention_reference, flash_attention
from vidsum_tpu_torch.ops.attention_train import flash_attention_dropout
from vidsum_tpu_torch.ops.block_kernel import (
    cached, fused_block_supported, fused_encoder_block, gemm_bias_epilogue,
)
from vidsum_tpu_torch.ops.block_kernel_int8 import (
    fused_block_int8_supported, fused_encoder_block_int8,
)
from vidsum_tpu_torch.ops.block_train import (
    fused_block_train, fused_block_train_supported,
)
from vidsum_tpu_torch.ops.quant import (
    int8_encoder_block_dense, int8_linear, quantize_block, quantize_weight,
)

ATTN_IMPLS = ("dense", "flash", "fused_block", "int8_dense", "int8_block")


def _int8_checks(deterministic: bool, return_attn: bool, cfg: ModelConfig,
                 caller_attention: bool) -> None:
    """The int8 route's preconditions, with the JAX package's messages."""
    if not deterministic:
        raise ValueError("int8 scoring path is inference-only; use the "
                         "bf16 kernels for training")
    if return_attn:
        raise ValueError("int8 scoring path does not return attention "
                         "maps; use attn_impl='xla' for export")
    if cfg.norm_first:
        raise ValueError("int8 scoring path implements the reference's "
                         "post-LN block only")
    if caller_attention:
        raise ValueError("int8 scoring path does not compose with a "
                         "caller-supplied attention (ring); use the "
                         "bf16 ladder for sequence-parallel scoring")


class Embedding(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.feature_transform = nn.Linear(cfg.in_features, cfg.d_model)
        if cfg.use_cls:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.d_model))


class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.feature_projection = nn.Linear(d, d)


class MLP(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        self.sa = Attention(d)
        self.mlp = MLP(d, cfg.mlp_scale * d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.module_list = nn.ModuleList(
            [EncoderBlock(cfg) for _ in range(cfg.num_layers)])


def positional_encoding_table(max_len: int, d_model: int,
                              device=None) -> torch.Tensor:
    """Classic sin/cos table (reference: simnet.py:220-234), f32."""
    # the JAX package's f32 operation order, so the angles round alike
    angle = torch.exp(-torch.arange(0, d_model, 2, dtype=torch.float32,
                                    device=device)
                      * math.log(10000.0) / d_model)
    pos = torch.arange(0, max_len, dtype=torch.float32, device=device)[:, None]
    pe = torch.zeros((max_len, d_model), device=device)
    pe[:, 0::2] = torch.sin(pos * angle)
    pe[:, 1::2] = torch.cos(pos * angle)
    return pe


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W^T + b`` in x's dtype, one product per batch element so a row's
    result does not depend on the rest of the batch (the JAX ``_linear``)."""
    w = lin.weight.to(x.dtype).t()
    b = lin.bias.to(x.dtype)
    return torch.stack([torch.matmul(xi, w) for xi in x.unbind(0)]) + b


def _kernel_linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """The embed/head product through ``gemm_bias_epilogue`` on CUDA."""
    B, N, K = x.shape
    out, _ = gemm_bias_epilogue(x.reshape(B * N, K).contiguous(),
                                lin.weight.to(x.dtype).contiguous(),
                                lin.bias.float().contiguous(), "none")
    return out.view(B, N, -1)


def _layernorm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with a Bernoulli(1 - rate) keep mask drawn from
    ``generator`` (on the generator's device, then moved to x's)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator,
                      device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, 0.0).to(x.dtype)


def _device_generator(generator: Optional[torch.Generator],
                      device: torch.device) -> Optional[torch.Generator]:
    """The generator plain dropout draws from for inputs on ``device``:
    ``generator`` itself on its own device; for CUDA inputs and a generator
    elsewhere (``train.finetune.epoch_streams`` hands out CPU ones), a card
    generator seeded by one draw of it, so that the masks are drawn on the
    card and the run stays reproducible from ``generator``."""
    if (generator is None or device.type != "cuda"
            or generator.device.type == "cuda"):
        return generator
    seed = int(torch.randint(0, 2**63 - 1, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(device=device).manual_seed(seed)


def _apply_keep(x: torch.Tensor, keep_mask, rate: float) -> torch.Tensor:
    """Dropout with a given boolean keep mask (the JAX ``_apply_keep``)."""
    if rate == 0.0:
        return x
    keep_mask = torch.as_tensor(keep_mask, device=x.device)
    return torch.where(keep_mask, x / (1.0 - rate), 0.0).to(x.dtype)


class SimNet(nn.Module):
    """The scorer. Parameters are f32 and are initialised as
    ``torch.nn.Linear``'s U(+-1/sqrt(fan_in)) for weights and biases (the
    JAX package's init) from ``generator`` (default: seed 0); LayerNorms
    start at ones/zeros and the CLS token at zeros."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.embedding_layer = Embedding(cfg)
        self.encoder = Encoder(cfg)
        self.final_layer = nn.Linear(cfg.d_model, cfg.num_classes)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    bound = 1.0 / math.sqrt(mod.in_features)
                    mod.weight.uniform_(-bound, bound, generator=generator)
                    mod.bias.uniform_(-bound, bound, generator=generator)
        self.to(dev)
        self._pe_cache = {}

    def _pe(self, length: int, device) -> torch.Tensor:
        """The PE table of ``length`` rows. Only the ``max_len`` table, which
        every request up to ``max_len`` frames uses, is cached; longer ones
        are recomputed, so serving many long lengths holds no extra memory."""
        if length != self.cfg.max_len:
            return positional_encoding_table(length, self.cfg.d_model, device)
        pe = self._pe_cache.get(str(device))
        if pe is None:
            pe = positional_encoding_table(length, self.cfg.d_model, device)
            self._pe_cache[str(device)] = pe
        return pe

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                *, attn_impl: Optional[str] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                block_seeds: Optional[Sequence[int]] = None,
                return_attn: bool = False, attn_fn=None,
                pos_offset: Optional[int] = None,
                pe_len: Optional[int] = None, dropout_masks=None):
        """Run the scorer on x (B, N, in_features) with pad_mask (B, N) bool,
        True at padded frames. Returns ``(scores (B, N(+1), num_classes) f32,
        hidden)``, and with ``return_attn`` also the per-layer attention
        weights (B, H, N, N) (which always takes the dense route).

        ``attn_fn(q, k, v, pad_mask) -> out`` (q/k/v/out (B, H, N, Dh) in the
        compute dtype) replaces every layer's attention; the layers then take
        the plain route around it (the int8 routes refuse it). ``pos_offset``
        is the global position of ``x[:, 0]`` in the PE table, whose length
        must then be the global sequence length ``pe_len``: the sequence-
        parallel forward runs one shard per call (see :meth:`forward_steps`).
        Everything else is :meth:`forward_steps`'s."""
        steps = self.forward_steps(
            x, pad_mask, attn_impl=attn_impl, deterministic=deterministic,
            generator=generator, block_seeds=block_seeds,
            return_attn=return_attn, yield_attention=attn_fn is not None,
            pos_offset=pos_offset, pe_len=pe_len,
            dropout_masks=dropout_masks)
        try:
            request = next(steps)
            while True:
                request = steps.send(attn_fn(*request))
        except StopIteration as done:
            return done.value

    def forward_steps(self, x: torch.Tensor,
                      pad_mask: Optional[torch.Tensor] = None, *,
                      attn_impl: Optional[str] = None,
                      deterministic: bool = True,
                      generator: Optional[torch.Generator] = None,
                      block_seeds: Optional[Sequence[int]] = None,
                      return_attn: bool = False,
                      yield_attention: bool = False,
                      pos_offset: Optional[int] = None,
                      pe_len: Optional[int] = None, dropout_masks=None):
        """The forward as a generator; its return value (``StopIteration.
        value``) is :meth:`forward`'s. With ``yield_attention`` it yields
        ``(q, k, v, pad_mask)`` at every layer's attention and takes the
        attention output back through ``send``: the single-process
        counterpart of running the forward under ``shard_map``, where
        ``parallel/seq_forward.py`` advances one generator per shard in
        lockstep and runs the ring over all of them at each yield.

        Training (``deterministic=False``) draws its dropout from
        ``generator``. On both kernel routes (the ``"fused_block"`` block and
        the ``"flash"`` route's attention) each layer's dropout seed is
        ``torch.randint(0, 2**31 - 1)`` from it; without a generator or at
        ``cfg.dropout`` 0 it is the layer index on ``"fused_block"`` and 0 on
        ``"flash"``, as in the JAX package. ``block_seeds`` gives the
        per-layer seeds of either route instead, which is how the tests hand
        both packages the same seeds. ``dropout_masks`` (per layer, boolean
        keep masks ``{"attn": (B,H,N,N), "res1": (B,N,d), "mlp": (B,N,4d),
        "res2": (B,N,d)}``) replace the draws; they take the dense route,
        except on ``"flash"``, whose attention keeps its in-kernel dropout
        (the ``"attn"`` masks are not read there)."""
        cfg = self.cfg
        if attn_impl is None:
            attn_impl = "fused_block" if x.device.type == "cuda" else "dense"
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{attn_impl!r}")
        if (not deterministic and generator is None and dropout_masks is None
                and block_seeds is None):
            raise ValueError("generator is required when deterministic=False")
        use_int8 = attn_impl.startswith("int8")
        if use_int8:
            _int8_checks(deterministic, return_attn, cfg, yield_attention)
        if yield_attention:
            if return_attn:
                raise ValueError("return_attn does not compose with a "
                                 "caller-supplied attention")
            attn_impl = "dense"

        dt = dtype_of(cfg.compute_dtype)
        x = x.to(dt)
        B, N, _ = x.shape
        if attn_impl == "int8_block":
            # decided before the embed, so a demoted forward is lossless
            # throughout (simnet.py:253-267)
            n_eff = N + (1 if cfg.use_cls else 0)
            if n_eff % 128 != 0:
                attn_impl = "int8_dense"
            elif not fused_block_int8_supported(B, n_eff, cfg.d_model,
                                                x.element_size()):
                attn_impl, use_int8 = "flash", False
        # the embed/head kernel has no backward: training takes autograd's
        linear = (_kernel_linear if x.device.type == "cuda" and deterministic
                  else _linear)
        made = []

        def drop_generator():
            """The generator of the plain dropout sites, made at first use."""
            if not made:
                made.append(_device_generator(generator, x.device))
            return made[0]

        emb = self.embedding_layer
        if use_int8:
            ew, es = cached(emb.feature_transform, "int8",
                            lambda m: quantize_weight(m.weight))
            h = int8_linear(x, ew, es, emb.feature_transform.bias).to(dt)
        else:
            h = linear(emb.feature_transform, x)
        if cfg.use_pos:
            pe = self._pe(max(cfg.max_len, pe_len or 0, N), x.device)
            off = int(pos_offset or 0)
            if off + N > pe.shape[0]:
                raise ValueError(f"positions {off}..{off + N} past the PE "
                                 f"table's {pe.shape[0]} rows: pass the "
                                 f"global length as pe_len")
            h = h + pe[None, off:off + N].to(dt)
            if not deterministic and cfg.pos_dropout > 0.0:
                h = _dropout(h, cfg.pos_dropout, drop_generator())
        if cfg.use_cls:
            h = torch.cat([emb.cls_token.to(dt).expand(B, 1, cfg.d_model), h],
                          dim=1)
            if pad_mask is not None:
                pad_mask = torch.cat(
                    [torch.zeros((B, 1), dtype=torch.bool,
                                 device=pad_mask.device), pad_mask], dim=1)

        if use_int8:
            for block in self.encoder.module_list:
                qb = cached(block, "int8", quantize_block)
                run = (fused_encoder_block_int8 if attn_impl == "int8_block"
                       else int8_encoder_block_dense)
                h = run(qb, h, pad_mask, cfg.num_heads, cfg.attn_scale)
            return linear(self.final_layer, h).float(), h

        n_eff = h.shape[1]
        if attn_impl == "fused_block" and (deterministic
                                           or dropout_masks is None):
            ok = (fused_block_supported(B, n_eff, cfg.d_model,
                                        h.element_size())
                  if deterministic else
                  fused_block_train_supported(B, n_eff, cfg.d_model,
                                              cfg.num_heads))
            if not ok:
                attn_impl = "flash"
        use_block = (attn_impl == "fused_block" and not return_attn
                     and not cfg.norm_first
                     and (deterministic or dropout_masks is None))
        # the flash route's training attention: flash_attention_dropout
        flash_train = (attn_impl == "flash" and not deterministic
                       and not return_attn and n_eff % 128 == 0)

        def layer_seed(layer_idx: int) -> int:
            if block_seeds is not None:
                return int(block_seeds[layer_idx])
            if generator is not None and cfg.dropout > 0.0:
                return int(torch.randint(0, 2**31 - 1, (1,),
                                         generator=generator,
                                         device=generator.device))
            return 0 if flash_train else layer_idx

        attn_maps = []
        for layer_idx, block in enumerate(self.encoder.module_list):
            if use_block and deterministic:
                h = fused_encoder_block(block, h, pad_mask, cfg.num_heads,
                                        cfg.attn_scale)
                continue
            if use_block:
                h = fused_block_train(h, block, pad_mask,
                                      layer_seed(layer_idx), cfg.num_heads,
                                      cfg.attn_scale, cfg.dropout)
                continue
            seed = layer_seed(layer_idx) if flash_train else None
            lm = dropout_masks[layer_idx] if dropout_masks is not None \
                else None

            def drop(t, key):
                if deterministic:
                    return t
                if lm is not None:
                    return _apply_keep(t, lm[key], cfg.dropout)
                return _dropout(t, cfg.dropout, drop_generator())

            x_in = _layernorm(block.norm1, h) if cfg.norm_first else h
            if yield_attention:
                out = yield (*self._qkv(block.sa, x_in), pad_mask)
                sa, w = self._project(block.sa, out), None
            else:
                sa, w = self._attention(block.sa, x_in, pad_mask, attn_impl,
                                        deterministic, drop, return_attn,
                                        seed)
            if cfg.norm_first:
                h = h + drop(sa, "res1")
                ff = self._mlp(block.mlp, _layernorm(block.norm2, h), drop)
                h = h + drop(ff, "res2")
            else:
                h = _layernorm(block.norm1, drop(sa, "res1") + h)
                ff = self._mlp(block.mlp, h, drop)
                h = _layernorm(block.norm2, drop(ff, "res2") + h)
            if return_attn:
                attn_maps.append(w)

        scores = linear(self.final_layer, h).float()
        if return_attn:
            return scores, h, attn_maps
        return scores, h

    @staticmethod
    def _mlp(mlp: MLP, x, drop):
        """2-layer FFN, dropout after the ReLU only."""
        return _linear(mlp.fc2, drop(torch.relu(_linear(mlp.fc1, x)), "mlp"))

    def _attention(self, sa: Attention, x, pad_mask, attn_impl: str,
                   deterministic: bool, drop, return_weights: bool,
                   seed: Optional[int] = None):
        """Multi-head self-attention; returns (projected output, the softmax
        weights in x's dtype when asked for). ``seed`` is the layer's
        attention dropout seed on the flash training route."""
        cfg = self.cfg
        q, k, v = self._qkv(sa, x)
        weights = None
        if seed is not None:
            out = flash_attention_dropout(q, k, v, pad_mask, seed,
                                          cfg.dropout, cfg.attn_scale)
        elif attn_impl == "flash" and deterministic and not return_weights:
            out = flash_attention(q, k, v, pad_mask, cfg.attn_scale)
        elif deterministic and not return_weights:
            out = attention_reference(q, k, v, pad_mask, cfg.attn_scale)
        else:
            s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
                * cfg.attn_scale
            if pad_mask is not None:
                s = s.masked_fill(pad_mask[:, None, None, :], float("-inf"))
            weights = torch.softmax(s, dim=-1).to(x.dtype)
            out = torch.matmul(drop(weights, "attn").float(),
                               v.float()).to(x.dtype)
        return self._project(sa, out), weights

    def _qkv(self, sa: Attention, x):
        """The per-head projections q, k, v (B, H, N, Dh)."""
        B, N, _ = x.shape
        H, Dh = self.cfg.num_heads, self.cfg.head_dim
        return tuple(_linear(lin, x).view(B, N, H, Dh).transpose(1, 2)
                     for lin in (sa.q, sa.k, sa.v))

    @staticmethod
    def _project(sa: Attention, out):
        """Heads (B, H, N, Dh) merged and through the output projection."""
        B, H, N, Dh = out.shape
        return _linear(sa.feature_projection,
                       out.transpose(1, 2).reshape(B, N, H * Dh))


def count_params(model: nn.Module) -> int:
    """The number of parameters (``simnet.py:396``'s count of the JAX
    tree: the positional encoding is computed, not a parameter)."""
    return sum(p.numel() for p in model.parameters())

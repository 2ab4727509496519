# ported from vidsum_tpu/preprocess/nn.py
"""Shared pieces of the frozen feature extractors (inference only, like the
reference's ``torch.no_grad`` wrappers at ``src/data/preprocess/
models.py``): a BatchNorm with the JAX package's inference arithmetic, the
exact BN-into-conv fold, and the state-dict readers.

Layout is torchvision's (NCHW / NCDHW, OIHW / OIDHW weights), so a
torchvision or reference state dict loads as it is. Convolutions, ceil-mode
max pools and global pooling are ``torch.nn.functional``'s; the JAX
package's ``maxpool2d_ceil`` exists only because XLA has no ceil mode.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


class FrozenBatchNorm(nn.modules.batchnorm._BatchNorm):
    """Inference BatchNorm over the channel axis (dim 1) with the JAX
    package's arithmetic, ``(x - mean) * rsqrt(var + eps) * scale + bias``
    (``nn.batchnorm``); its state-dict keys are ``nn.BatchNorm2d``'s."""

    def _check_input_dim(self, input):
        pass

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(self.running_var + self.eps)
        return ((x - self.running_mean.view(shape)) * inv.view(shape)
                * self.weight.view(shape) + self.bias.view(shape))


def fold_batchnorm(conv_weight, bn: Dict[str, np.ndarray], eps: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Fold inference BatchNorm into a bias-free conv: with ``inv =
    scale / sqrt(var + eps)``, ``BN(conv(x, w)) == conv(x, w * inv) + (bias -
    mean * inv)``. The JAX package's arithmetic (float64, rounded once to
    float32), so the folded weights equal its folded tree's. ``bn`` holds
    ``scale``, ``bias``, ``mean``, ``var``; ``inv`` scales the output
    channels (axis 0 of an OIHW / OIDHW weight). Returns (w, b) float32."""
    w = np.asarray(conv_weight, np.float64)
    b64 = {k: np.asarray(v, np.float64) for k, v in bn.items()}
    inv = b64["scale"] / np.sqrt(b64["var"] + eps)
    shape = (-1,) + (1,) * (w.ndim - 1)
    return ((w * inv.reshape(shape)).astype(np.float32),
            (b64["bias"] - b64["mean"] * inv).astype(np.float32))


def fold_module(net: nn.Module) -> nn.Module:
    """A BN-folded copy of ``net``: every conv of
    ``net.conv_bn_pairs()`` (``(conv, parent, name)``, the BN being
    ``parent.<name>``) gains the folded bias and its BN becomes
    ``nn.Identity``, so the folded net's state dict has no BN keys."""
    folded = copy.deepcopy(net)
    for conv, parent, name in folded.conv_bn_pairs():
        bn = getattr(parent, name)
        w, b = fold_batchnorm(
            conv.weight.detach().cpu().numpy(),
            {"scale": bn.weight.detach().cpu().numpy(),
             "bias": bn.bias.detach().cpu().numpy(),
             "mean": bn.running_mean.cpu().numpy(),
             "var": bn.running_var.cpu().numpy()}, bn.eps)
        dev = conv.weight.device
        conv.weight = nn.Parameter(torch.from_numpy(w).to(dev),
                                   requires_grad=False)
        conv.bias = nn.Parameter(torch.from_numpy(b).to(dev),
                                 requires_grad=False)
        setattr(parent, name, nn.Identity())
    return folded


def init_conv_bn(conv: nn.Module, bn: Optional[FrozenBatchNorm],
                 generator: torch.Generator) -> None:
    """He-style random weights for an (untrained) conv + BN, the JAX
    ``init_conv_bn``'s distribution (normal * sqrt(2 / fan_in), BN at the
    identity): features are then random projections, fine for tests and
    plumbing, not for real summaries."""
    w = conv.weight
    fan_in = int(np.prod(w.shape[1:]))
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator)
                * math.sqrt(2.0 / fan_in))
        if bn is not None:
            bn.weight.fill_(1.0)
            bn.bias.zero_()
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0)


# ---------------------------------------------------------------------------
# state-dict reading
# ---------------------------------------------------------------------------

class TrackingState(dict):
    """State-dict wrapper recording which keys a loader consumed, so
    :func:`check_state_coverage` can prove the load is exhaustive: a
    renamed torchvision key (``branch4.1`` moving, say) would otherwise
    leave stale weights behind and drift every feature downstream."""

    def __init__(self, state):
        super().__init__(state)
        self.consumed = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        return super().__getitem__(k)


def check_state_coverage(tracked: TrackingState,
                         ignore_prefixes: Tuple[str, ...] = ()) -> None:
    """Raise if any state-dict key was neither consumed nor explicitly
    ignorable (BN bookkeeping, stripped heads)."""
    leftover = sorted(
        k for k in tracked
        if k not in tracked.consumed
        and not k.endswith("num_batches_tracked")
        and not any(k.startswith(p) for p in ignore_prefixes))
    if leftover:
        raise ValueError(
            "torch state keys not consumed by the converter (renamed "
            f"layout?): {leftover[:10]}{'...' if len(leftover) > 10 else ''}")


def load_tracked(net: nn.Module, state, ignore_prefixes: Tuple[str, ...],
                 strict: bool = True) -> nn.Module:
    """Load ``state`` (a state dict of tensors or numpy arrays) into
    ``net``: every key ``net`` has must be there (``KeyError`` otherwise),
    and with ``strict`` every key of ``state`` must be used, bar
    ``ignore_prefixes`` and BN bookkeeping (:func:`check_state_coverage`)."""
    tracked = TrackingState(state)
    own = net.state_dict()
    with torch.no_grad():
        for key, dst in own.items():
            if key.endswith("num_batches_tracked"):
                continue
            src = torch.tensor(np.asarray(tracked[key]))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: shape {tuple(src.shape)}, the "
                                 f"network has {tuple(dst.shape)}")
            dst.copy_(src)
    if strict:
        check_state_coverage(tracked, ignore_prefixes)
    return net


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch ``.pth`` / ``.pt`` state dict or an ``.npz`` into
    numpy."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    return {k: v.numpy() for k, v in state.items()}


def conv_w_to_torch(w: np.ndarray) -> np.ndarray:
    """HWIO -> OIHW (2-D) or DHWIO -> OIDHW (3-D): the JAX package's conv
    layout back to torchvision's."""
    w = np.asarray(w)
    if w.ndim == 4:
        return np.transpose(w, (3, 2, 0, 1))
    if w.ndim == 5:
        return np.transpose(w, (4, 3, 0, 1, 2))
    raise ValueError(f"unexpected conv weight rank {w.ndim}")


def put_conv_bn_from_jax(out: Dict[str, np.ndarray], p, conv_key: str,
                         bn_prefix: str) -> None:
    """One JAX ``{"conv": {"w"[, "b"]}[, "bn": {...}]}`` block into
    torchvision keys: the conv weight at ``conv_key`` (``.weight``), its
    bias where the tree is folded, the BN under ``bn_prefix``."""
    out[conv_key + ".weight"] = conv_w_to_torch(p["conv"]["w"])
    if "b" in p["conv"]:
        out[conv_key + ".bias"] = np.asarray(p["conv"]["b"])
    if "bn" in p:
        bn = p["bn"]
        out[bn_prefix + ".weight"] = np.asarray(bn["scale"])
        out[bn_prefix + ".bias"] = np.asarray(bn["bias"])
        out[bn_prefix + ".running_mean"] = np.asarray(bn["mean"])
        out[bn_prefix + ".running_var"] = np.asarray(bn["var"])


def exact_f32_convs():
    """cuDNN's f32 convolutions at full f32 for the scope of a call: PyTorch
    lets cuDNN use TF32 for them by default (``cudnn.allow_tf32``), which
    the port's exact-f32 contract forbids. The global flag is left as it
    is."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)

# ported from vidsum_tpu/preprocess/googlenet.py
"""GoogLeNet (Inception v1, BN variant) pool5 feature extractor.

The reference wraps torchvision's pretrained ``googlenet`` with the final
dropout + fc stripped, leaving the 1024-d global-average-pool ("pool5")
output (``src/data/preprocess/models.py:10-37``). :class:`GoogLeNet` is that
network in NCHW with torchvision's module names, so a torchvision or
reference ``googlenet`` state dict loads directly (:meth:`GoogLeNet.
load_torch_state`; its ``aux1`` / ``aux2`` / ``fc`` heads are dropped).

Architecture notes (as torchvision, for weight parity):
- every conv is conv -> BN (eps 1e-3) -> ReLU (``BasicConv2d``), bias-free;
- inception branch 3 uses a 3 x 3 kernel (torchvision's deviation from the
  paper's 5 x 5) with padding 1;
- max pools use ceil mode;
- no ``transform_input``: the reference rebuilds the net as
  ``nn.Sequential(*children)`` and ``_transform_input`` lives in
  ``GoogLeNet.forward``, so it drops out there too; inputs get plain
  ImageNet normalisation (``feature_extraction.py:83-88``).

:meth:`GoogLeNet.fold` returns the BN-folded inference net (one biased conv
per block, the JAX ``fold_googlenet``); :func:`googlenet_params_from_jax`
maps the JAX package's parameter tree (folded or not) to this state dict.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vidsum_tpu_torch.preprocess.nn import (
    FrozenBatchNorm, exact_f32_convs, fold_module, init_conv_bn, load_tracked,
    put_conv_bn_from_jax,
)

BN_EPS = 1e-3  # torchvision BasicConv2d

# (ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj) per block
INCEPTION_CFG = {
    "inception3a": (64, 96, 128, 16, 32, 32),
    "inception3b": (128, 128, 192, 32, 96, 64),
    "inception4a": (192, 96, 208, 16, 48, 64),
    "inception4b": (160, 112, 224, 24, 64, 64),
    "inception4c": (128, 128, 256, 24, 64, 64),
    "inception4d": (112, 144, 288, 32, 64, 64),
    "inception4e": (256, 160, 320, 32, 128, 128),
    "inception5a": (256, 160, 320, 32, 128, 128),
    "inception5b": (384, 192, 384, 48, 128, 128),
}
INCEPTION_IN = {
    "inception3a": 192, "inception3b": 256, "inception4a": 480,
    "inception4b": 512, "inception4c": 512, "inception4d": 512,
    "inception4e": 528, "inception5a": 832, "inception5b": 832,
}
# torchvision heads the reference strips (models.py:20)
STRIPPED = ("aux1.", "aux2.", "dropout.", "fc.")


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride,
                              padding=padding, bias=False)
        self.bn = FrozenBatchNorm(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class MaxPoolCeil(nn.Module):
    """``nn.MaxPool2d(ceil_mode=True)`` without parameters (keeps
    torchvision's ``branch4.0`` slot, so ``branch4.1`` is the conv)."""

    def __init__(self, k: int, stride: int, padding: int = 0):
        super().__init__()
        self.k, self.stride, self.padding = k, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, self.k, self.stride, self.padding,
                            ceil_mode=True)


class Inception(nn.Module):
    def __init__(self, cin, c1, c3r, c3, c5r, c5, pp):
        super().__init__()
        self.branch1 = BasicConv2d(cin, c1, 1)
        self.branch2 = nn.Sequential(BasicConv2d(cin, c3r, 1),
                                     BasicConv2d(c3r, c3, 3, padding=1))
        self.branch3 = nn.Sequential(BasicConv2d(cin, c5r, 1),
                                     BasicConv2d(c5r, c5, 3, padding=1))
        self.branch4 = nn.Sequential(MaxPoolCeil(3, 1, padding=1),
                                     BasicConv2d(cin, pp, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x),
                          self.branch4(x)], 1)


class GoogLeNet(nn.Module):
    """x (B, 3, H, W) normalised images -> (B, 1024) pool5 features.

    Parameters are seeded He-style random weights (``generator``, default
    seed 0; the JAX ``init_googlenet``'s distribution) until a state dict
    is loaded. On CUDA the f32 convolutions run with TF32 off
    (:func:`~vidsum_tpu_torch.preprocess.nn.exact_f32_convs`)."""

    def __init__(self, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.conv1 = BasicConv2d(3, 64, 7, stride=2, padding=3)
        self.maxpool1 = MaxPoolCeil(3, 2)
        self.conv2 = BasicConv2d(64, 64, 1)
        self.conv3 = BasicConv2d(64, 192, 3, padding=1)
        self.maxpool2 = MaxPoolCeil(3, 2)
        for name, cfg in INCEPTION_CFG.items():
            setattr(self, name, Inception(INCEPTION_IN[name], *cfg))
        self.maxpool3 = MaxPoolCeil(3, 2)
        self.maxpool4 = MaxPoolCeil(2, 2)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for conv, parent, name in self.conv_bn_pairs():
            init_conv_bn(conv, getattr(parent, name), generator)
        self.requires_grad_(False)
        self.eval()
        if device is not None:
            self.to(device)

    def conv_bn_pairs(self):
        """``(conv, parent, bn attribute name)`` of every BasicConv2d."""
        return [(m.conv, m, "bn") for m in self.modules()
                if isinstance(m, BasicConv2d)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with exact_f32_convs():
            x = self.maxpool1(self.conv1(x))
            x = self.maxpool2(self.conv3(self.conv2(x)))
            x = self.maxpool3(self.inception3b(self.inception3a(x)))
            x = self.inception4e(self.inception4d(self.inception4c(
                self.inception4b(self.inception4a(x)))))
            x = self.maxpool4(x)
            x = self.inception5b(self.inception5a(x))
            return x.mean(dim=(2, 3))

    def fold(self) -> "GoogLeNet":
        """The BN-folded copy (exact inference transform; see
        :func:`~vidsum_tpu_torch.preprocess.nn.fold_batchnorm`)."""
        return fold_module(self)

    def load_torch_state(self, state, strict: bool = True) -> "GoogLeNet":
        """Load a torchvision ``googlenet`` state dict (tensors or numpy):
        every key of this net must be in it, and with ``strict`` every key
        of it must be used except the stripped heads (``aux1``, ``aux2``,
        ``dropout``, ``fc``) and BN bookkeeping, so a renamed layout fails
        loudly. A folded net takes a folded state (``conv.bias``, no BN)."""
        return load_tracked(self, state, STRIPPED, strict)


def googlenet_params_from_jax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX package's GoogLeNet tree (numpy or jax leaves; folded or not)
    as this module's state dict, in torchvision's keys."""
    out: Dict[str, np.ndarray] = {}
    for name in ("conv1", "conv2", "conv3"):
        put_conv_bn_from_jax(out, params[name], f"{name}.conv", f"{name}.bn")
    slots = {"branch1": "branch1", "branch2_0": "branch2.0",
             "branch2_1": "branch2.1", "branch3_0": "branch3.0",
             "branch3_1": "branch3.1", "branch4": "branch4.1"}
    for name in INCEPTION_CFG:
        for jax_key, slot in slots.items():
            pfx = f"{name}.{slot}"
            put_conv_bn_from_jax(out, params[name][jax_key], f"{pfx}.conv",
                                 f"{pfx}.bn")
    return out

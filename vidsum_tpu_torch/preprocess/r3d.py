# ported from vidsum_tpu/preprocess/r3d.py
"""R3D-18 (3-D ResNet-18) video feature extractor.

The reference wraps torchvision's pretrained ``video.r3d_18`` with the final
fc stripped, leaving the 512-d global-average-pool clip embedding
(``src/data/preprocess/models.py:40-66``), the distillation target of
pretraining (``src/model/simnet_pretrain.py:33``). :class:`R3D18` is that
network in NCDHW with torchvision's module names, so an ``r3d_18`` state
dict loads directly (its ``fc`` dropped).

Architecture (torchvision VideoResNet with Conv3DSimple blocks):
- stem: 3 x 7 x 7 conv, stride (1, 2, 2), padding (1, 3, 3), BN (eps 1e-5),
  ReLU;
- 4 stages of 2 BasicBlocks (64 / 128 / 256 / 512); stages 2-4 downsample by
  stride (2, 2, 2) with a 1 x 1 x 1 conv + BN shortcut;
- global average pool over (T, H, W).

:meth:`R3D18.fold` is the BN-folded inference net (the JAX ``fold_r3d18``);
:func:`r3d18_params_from_jax` maps the JAX package's tree to this state
dict.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from vidsum_tpu_torch.preprocess.nn import (
    FrozenBatchNorm, exact_f32_convs, fold_module, init_conv_bn, load_tracked,
    put_conv_bn_from_jax,
)

BN_EPS = 1e-5
STAGES = (("layer1", 64, 1), ("layer2", 128, 2), ("layer3", 256, 2),
          ("layer4", 512, 2))


def _conv_bn(cin: int, cout: int, kernel, stride, padding,
             relu: bool) -> nn.Sequential:
    layers = [nn.Conv3d(cin, cout, kernel, stride=stride, padding=padding,
                        bias=False),
              FrozenBatchNorm(cout, eps=BN_EPS)]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv_bn(cin, cout, 3, stride, 1, relu=True)
        self.conv2 = _conv_bn(cout, cout, 3, 1, 1, relu=False)
        self.downsample = (_conv_bn(cin, cout, 1, stride, 0, relu=False)
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        shortcut = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + shortcut)


class R3D18(nn.Module):
    """x (B, 3, T, H, W) normalised clip -> (B, 512) embedding. Seeded
    He-style random weights (``generator``, default seed 0) until a state
    dict is loaded; f32 convolutions with TF32 off on CUDA."""

    def __init__(self, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.stem = _conv_bn(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3),
                             relu=True)
        cin = 64
        for name, cout, stride in STAGES:
            setattr(self, name, nn.Sequential(BasicBlock(cin, cout, stride),
                                              BasicBlock(cout, cout)))
            cin = cout
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for conv, parent, name in self.conv_bn_pairs():
            init_conv_bn(conv, getattr(parent, name), generator)
        self.requires_grad_(False)
        self.eval()
        if device is not None:
            self.to(device)

    def conv_bn_pairs(self):
        """``(conv, parent, bn attribute name)`` of every conv + BN."""
        return [(m[0], m, "1") for m in self.modules()
                if isinstance(m, nn.Sequential) and len(m) >= 2
                and isinstance(m[0], nn.Conv3d)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with exact_f32_convs():
            x = self.stem(x)
            for name, _, _ in STAGES:
                x = getattr(self, name)(x)
            return x.mean(dim=(2, 3, 4))

    def fold(self) -> "R3D18":
        """The BN-folded copy (exact inference transform)."""
        return fold_module(self)

    def load_torch_state(self, state, strict: bool = True) -> "R3D18":
        """Load a torchvision ``video.r3d_18`` state dict; with ``strict``
        every key must be used except ``fc`` and BN bookkeeping."""
        return load_tracked(self, state, ("fc.",), strict)


def r3d18_params_from_jax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX package's R3D-18 tree (folded or not) as this module's state
    dict, in torchvision's keys."""
    out: Dict[str, np.ndarray] = {}
    put_conv_bn_from_jax(out, params["stem"], "stem.0", "stem.1")
    for name, _, _ in STAGES:
        for bi, block in enumerate(params[name]):
            pfx = f"{name}.{bi}"
            for part in ("conv1", "conv2", "downsample"):
                if part in block:
                    put_conv_bn_from_jax(out, block[part], f"{pfx}.{part}.0",
                                         f"{pfx}.{part}.1")
    return out

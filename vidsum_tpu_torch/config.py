# ported from vidsum_tpu/config.py
"""Configuration of the serving path: the SimNet architecture and the data
layout fields serving reads. Defaults are the JAX package's, so one config
describes the same model in both packages."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """SimNet architecture (reference: ``src/model/simnet.py:10-30``); the
    defaults are the flagship recipe (d_model 256, 4 heads, 4 layers)."""

    in_features: int = 1024          # GoogLeNet pool5 dim
    d_model: int = 256
    num_heads: int = 4
    num_layers: int = 4
    mlp_scale: int = 4               # MLP hidden = scale*d_model
    dropout: float = 0.3             # training only (a later slice)
    pos_dropout: float = 0.0
    num_classes: int = 1
    use_pos: bool = True
    use_cls: bool = False
    max_len: int = 2000              # PE table length floor (reference quirk)
    # The reference scales attention by d_model**-0.5, not head_dim**-0.5.
    scale_by_d_model: bool = True
    norm_first: bool = False         # pre-LN blocks: a later slice
    compute_dtype: str = "float32"   # or "bfloat16"

    @property
    def head_dim(self) -> int:
        if self.d_model % self.num_heads:
            raise ValueError("d_model must be a multiple of num_heads")
        return self.d_model // self.num_heads

    @property
    def attn_scale(self) -> float:
        return (self.d_model if self.scale_by_d_model else self.head_dim) ** -0.5


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The data-layout fields serving reads."""

    pad_value: float = 1000.0        # padding sentinel (dataset.py:141)
    length_bucket: int = 128         # pad lengths to multiples of this

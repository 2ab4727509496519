# ported from vidsum_tpu/config.py
"""Configuration: the SimNet architecture, the data layout fields serving
and training read, the eval protocol, the finetune protocol and
self-supervised pretraining. Defaults are the JAX package's, so one config
describes the same run in both packages."""

from __future__ import annotations

import dataclasses
from typing import Tuple


ARCHS = ("simnet", "pglsum")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The scorer's architecture. ``arch`` ``"simnet"`` (the default): SimNet
    (reference: ``src/model/simnet.py:10-30``); the defaults are the
    flagship recipe (d_model 256, 4 heads, 4 layers). ``"pglsum"``: PGL-SUM
    (``models/pglsum.py``), which reads ``in_features`` (its width),
    ``num_heads`` (global heads), ``num_segments``, ``local_heads``,
    ``pos_enc``, ``pos_freq``, ``fusion`` and ``compute_dtype``; the
    published model is :func:`pglsum_config`'s."""

    arch: str = "simnet"

    in_features: int = 1024          # GoogLeNet pool5 dim
    d_model: int = 256
    num_heads: int = 4
    num_layers: int = 4
    mlp_scale: int = 4               # MLP hidden = scale*d_model
    dropout: float = 0.3             # block/attn/mlp dropout (training)
    pos_dropout: float = 0.0
    num_classes: int = 1
    use_pos: bool = True
    use_cls: bool = False
    max_len: int = 2000              # PE table length floor (reference quirk)
    # The reference scales attention by d_model**-0.5, not head_dim**-0.5.
    scale_by_d_model: bool = True
    norm_first: bool = False         # pre-LN blocks (dense and flash routes)
    compute_dtype: str = "float32"   # or "bfloat16"
    # PGL-SUM (arch "pglsum"): segments of the local attention, heads of
    # each segment's attention, the position encoding and its base, the
    # fusion of the global and local branches
    num_segments: int = 4
    local_heads: int = 4
    pos_enc: str = "absolute"
    pos_freq: int = 10000
    fusion: str = "add"

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
    """Data layout (reference: ``src/data/dataset.py``, ``src/data/path.py``).
    ``path_scheme`` ``"summarizer"`` names the ``summarizer_dataset_*`` h5
    files (which carry ``user_scores``), ``"eccv16"`` the eval modules'
    ``eccv16_dataset_*`` names (``data/paths.py``)."""

    root: str = "data"
    ex_dataset: str = "tvsum"        # dataset to evaluate on (train.py:183)
    datasets: str = "tvsum"          # "+"-joined training datasets
    min_train_frames: int = 50       # drop train videos with <= 50 frames
    pad_value: float = 1000.0        # padding sentinel (dataset.py:141)
    length_bucket: int = 128         # pad lengths to multiples of this
    path_scheme: str = "summarizer"


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Summary/metric protocol (reference: ``src/evaluation/``). Only the
    host pipeline is ported; the device eval is a later slice."""

    budget_ratio: float = 0.15       # generate_summary.py:46
    eval_method: str = "avg"         # hardcoded even for SumMe
    impl: str = "host"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Finetune protocol (reference: ``src/train.py``, ``run_finetune.sh``).
    ``attn_impl="auto"`` means ``"fused_block"`` on CUDA and ``"dense"`` on
    the CPU (``make_finetune_step`` resolves it). The JAX package's
    ``rng_impl`` (a JAX PRNG knob) has no counterpart.

    ``warm_start_from_save`` loads ``save_ckpt`` before each fold (the
    reference loads ``model_mae.pth`` unconditionally, train.py:76, and
    fails without it). ``state_save_every`` / ``model_save_every`` save the
    resume state (parameters and Adam moments) and the weight-only model
    every K epochs; the last epoch of a fold always saves both."""

    lr: float = 1e-3
    weight_decay: float = 1e-4
    batch_size: int = 4
    max_epoch: int = 100
    seed: int = 1234                 # train.py:29
    use_pretrained: bool = False     # --use_model (train.py:40-44)
    pretrain_ckpt: str = "pretrain.ckpt"
    save_ckpt: str = "model_mae.ckpt"
    warm_start_from_save: bool = False
    attn_impl: str = "auto"
    state_save_every: int = 1
    model_save_every: int = 1


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    """Self-supervised pretraining (reference: ``src/pretrain.py``,
    ``src/model/simnet_pretrain.py``, ``run_pretrain.sh``).

    ``scheduler_samples``: the scheduler's steps per epoch come from a
    hardcoded 13,000-sample numerator (pretrain.py:37), not the dataset's
    length. ``freeze_video_transform``: the reference's Adam holds the
    encoder's parameters only (pretrain.py:35-36), so ``video_transform``
    keeps its initial values. ``save_every``: the encoder checkpoint's
    cadence in epochs (the reference saves every epoch; the last epoch
    always saves). The JAX package's ``rng_impl`` has no counterpart."""

    lr: float = 1e-3
    weight_decay: float = 5e-4
    batch_size: int = 256
    epochs: int = 200
    warmup_epochs: int = 50          # pretrain.py:38
    scheduler_samples: int = 13000   # pretrain.py:37
    sharpening_t: float = 0.4        # simnet_pretrain.py:18
    center_weight: float = 0.5       # pretrain.py:63
    repel_weight: float = 1.0        # pretrain.py:63
    freeze_video_transform: bool = True
    save_every: int = 1
    seed: int = 1234


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """A device mesh's layout (``parallel.mesh.make_mesh``): ``data`` -1
    takes every entry the ``model`` (tensor-parallel) axis does not."""

    data: int = -1
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    pretrain: PretrainConfig = dataclasses.field(
        default_factory=PretrainConfig)


def finetune_recipe() -> Config:
    """The ``run_finetune.sh`` recipe: d256/h4/L4, dropout 0.3, lr 1e-3,
    wd 1e-4, batch 4, 100 epochs from the pretrained encoder."""
    return Config(
        model=ModelConfig(d_model=256, num_heads=4, num_layers=4, dropout=0.3),
        train=TrainConfig(lr=1e-3, weight_decay=1e-4, batch_size=4,
                          max_epoch=100, use_pretrained=True))


def pglsum_config(**overrides) -> ModelConfig:
    """PGL-SUM as published (e-apostolidis/PGL-SUM, ``model/configs.py``):
    1,024 wide, 8 global heads of 128, 4 segments of 4 heads of 64, the
    absolute position bias at base 10,000, fusion ``add``."""
    fields = dict(arch="pglsum", in_features=1024, d_model=1024,
                  num_heads=8, num_segments=4, local_heads=4,
                  pos_enc="absolute", pos_freq=10000, fusion="add")
    fields.update(overrides)
    return ModelConfig(**fields)


def pretrain_recipe() -> Config:
    """The ``run_pretrain.sh`` recipe: d256/h4/L4, dropout 0.2, lr 1e-3,
    batch 256, 200 epochs."""
    return Config(
        model=ModelConfig(d_model=256, num_heads=4, num_layers=4, dropout=0.2),
        pretrain=PretrainConfig(lr=1e-3, batch_size=256, epochs=200))

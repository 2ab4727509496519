# ported from vidsum_tpu/preprocess/extract.py
"""Feature extraction entry points.

The API mirrors the reference (``src/data/preprocess/feature_extraction.py:
10,45``): :func:`get_google_net_features` (per-frame 1024-d pool5) and
:func:`get_video_feature` (the 512-d R3D-18 clip embedding). The forward
runs on the card over fixed-size batches of frames that cross the link as
uint8 and are normalised there, and the weights come from an explicit
source (a torchvision ``.pth`` / ``.npz`` state dict, the JAX package's
converted ``.msgpack``, or seeded random weights for plumbing and tests).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from vidsum_tpu_torch.device import dtype_of, resolve_device
from vidsum_tpu_torch.preprocess.googlenet import (
    GoogLeNet, googlenet_params_from_jax,
)
from vidsum_tpu_torch.preprocess.nn import load_state_dict
from vidsum_tpu_torch.preprocess.r3d import R3D18, r3d18_params_from_jax
from vidsum_tpu_torch.preprocess.transforms import (
    device_normalize, resize_shorter_side, resize_video,
)

_NETS = {"google": (GoogLeNet, googlenet_params_from_jax, 1024),
         "r3d18": (R3D18, r3d18_params_from_jax, 512)}


def load_backbone(kind: str, weights: Optional[str] = None, *,
                  fold_bn: bool = True, device=None,
                  generator: Optional[torch.Generator] = None):
    """The ``kind`` ("google" or "r3d18") backbone on ``device`` (default:
    the CUDA card), with the weights of ``weights`` (a torchvision state
    dict ``.pth`` / ``.npz``, or the JAX package's ``.msgpack`` tree as
    ``scripts/convert_backbones.py`` writes it) or seeded random ones
    (``generator``, default seed 0), BN-folded unless ``fold_bn`` is False
    (the exact inference transform: one biased conv per block)."""
    if kind not in _NETS:
        raise ValueError(kind)
    cls, from_jax, _ = _NETS[kind]
    net = cls(generator=generator)
    if weights and weights.endswith(".msgpack"):
        from vidsum_tpu_torch.train import flax_msgpack
        from vidsum_tpu_torch.train.checkpoint import load_checkpoint

        tree, _ = load_checkpoint(weights)
        state = from_jax(flax_msgpack.lists_from_dicts(tree))
        if not any(k.endswith("running_var") for k in state):
            net = net.fold()   # a folded tree loads into the folded net
        net.load_torch_state(state)
    elif weights:
        net.load_torch_state(load_state_dict(weights))
    if fold_bn and any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                       for m in net.modules()):
        net = net.fold()
    return net.to(resolve_device(device))


def embed(net: torch.nn.Module, kind: str,
          frames: torch.Tensor) -> torch.Tensor:
    """uint8 frames (B, H, W, 3), or clips (B, T, H, W, 3), on the
    backbone's device -> (B, out_dim) f32 features: ToTensor + Normalize
    there (:func:`device_normalize`), then the network in its parameters'
    dtype."""
    dt = next(net.parameters()).dtype
    x = device_normalize(frames, kind).to(dt).movedim(-1, 1).contiguous()
    with torch.inference_mode():
        return net(x).float()


class FeatureExtractor:
    """Batched CNN feature extraction on ``device`` (default: the CUDA
    card). Frames are resized on the host (PIL; skipped for frames already
    at the size), cross to the device as uint8 batches of ``batch_size``
    (the tail zero-padded, so every batch has one shape), and are normalised
    and embedded there in ``compute_dtype``."""

    def __init__(self, kind: str = "google", weights: Optional[str] = None,
                 *, batch_size: Optional[int] = None,
                 compute_dtype: str = "float32", fold_bn: bool = True,
                 device=None):
        self.device = resolve_device(device)
        # the JAX package's batch (128 on its accelerator, 64 elsewhere);
        # not tuned on the card
        if batch_size is None:
            batch_size = 128 if self.device.type == "cuda" else 64
        self.kind = kind
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.net = load_backbone(kind, weights, fold_bn=fold_bn,
                                 device=self.device).to(
                                     dtype_of(compute_dtype))
        self.out_dim = _NETS[kind][2]

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def frames(self, video: np.ndarray, size: int = 224) -> np.ndarray:
        """(T, H, W, 3) uint8 -> (T, 1024) GoogLeNet pool5 features."""
        return self.frames_stream(iter(video), size)

    def frames_stream(self, frame_iter, size: int = 224) -> np.ndarray:
        """Iterator of (H, W, 3) uint8 frames -> (T, 1024) pool5 features,
        holding one batch of resized frames on the host at a time (a 1-hour
        1080p video's reduced-fps stack is tens of GB). Batches are queued
        on the device as they fill, and the features are fetched once at
        the end."""
        if self.kind != "google":
            raise ValueError("frames / frames_stream need the 'google' "
                             "extractor")
        outs, buf = [], []

        def run_batch(buf):
            chunk = np.stack(buf)
            pad = self.batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            out = embed(self.net, self.kind, self._to_device(chunk))
            return out[: self.batch_size - pad]

        for f in frame_iter:
            buf.append(resize_shorter_side(f, size))
            if len(buf) == self.batch_size:
                outs.append(run_batch(buf))
                buf = []
        if buf:
            outs.append(run_batch(buf))
        if not outs:
            return np.zeros((0, self.out_dim), np.float32)
        return torch.cat(outs).cpu().numpy()

    def clip(self, video: np.ndarray, size: int = 112) -> np.ndarray:
        """(T, H, W, 3) uint8 -> (512,) R3D-18 clip embedding."""
        return self.clip_resized(resize_video(video, size))

    def clip_resized(self, resized: np.ndarray) -> np.ndarray:
        """(T, h, w, 3) uint8 already resized (shorter side 112) -> (512,)
        R3D-18 clip embedding; lets a streaming decoder resize per frame."""
        if self.kind != "r3d18":
            raise ValueError("clip / clip_resized need the 'r3d18' "
                             "extractor")
        x = self._to_device(resized[None])            # (1, T, h, w, 3)
        return embed(self.net, self.kind, x)[0].cpu().numpy()


@functools.lru_cache(maxsize=2)
def _default_extractor(kind: str) -> FeatureExtractor:
    """Process-wide extractor on the card; weights from the
    ``VIDSUM_GOOGLENET_WEIGHTS`` / ``VIDSUM_R3D18_WEIGHTS`` variables."""
    weights = os.environ.get(
        "VIDSUM_GOOGLENET_WEIGHTS" if kind == "google"
        else "VIDSUM_R3D18_WEIGHTS")
    return FeatureExtractor(kind, weights=weights)


def get_google_net_features(video: np.ndarray, size: int = 224) -> np.ndarray:
    """Reference-compatible wrapper (feature_extraction.py:10-41)."""
    return _default_extractor("google").frames(video, size)


def get_video_feature(video: np.ndarray, size: int = 112) -> np.ndarray:
    """Reference-compatible wrapper (feature_extraction.py:45-76)."""
    return _default_extractor("r3d18").clip(video, size)

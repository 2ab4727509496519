# ported from vidsum_tpu/preprocess/transforms.py
"""Image transforms matching the reference's torchvision pipeline
(``src/data/preprocess/feature_extraction.py:96-114``): Resize(shorter side)
-> ToTensor (uint8 / 255) -> per-channel Normalize.

The resize runs on the host with PIL (torchvision's ``transforms.Resize`` on
PIL images: the same antialiased bilinear), imported where it is used; a
frame that already has the target size is returned as it is, without PIL
(PIL's resize to the same size is the identity), so frames made at the
network's size need no PIL. The normalisation runs on the tensor's device
(:func:`device_normalize`), so frames cross to the card as uint8.
"""

from __future__ import annotations

import numpy as np
import torch

# https://pytorch.org/hub/pytorch_vision_googlenet (feature_extraction.py:86)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# https://pytorch.org/vision video classification (feature_extraction.py:85)
VIDEO_MEAN = np.array([0.43216, 0.394666, 0.37645], np.float32)
VIDEO_STD = np.array([0.22803, 0.22145, 0.216989], np.float32)


def shorter_side_shape(h: int, w: int, size: int):
    """(new_h, new_w) with the shorter side ``size``, aspect preserved
    (torchvision ``Resize(int)``)."""
    if h <= w:
        return size, max(round(w * size / h), 1)
    return max(round(h * size / w), 1), size


def resize_shorter_side(frame: np.ndarray, size: int) -> np.ndarray:
    """Resize (H, W, 3) uint8 so the shorter side equals ``size`` (aspect
    preserved), PIL bilinear; a frame already of that shape is returned
    unchanged."""
    h, w = frame.shape[:2]
    new_h, new_w = shorter_side_shape(h, w, size)
    if (new_h, new_w) == (h, w):
        return frame
    from PIL import Image

    img = Image.fromarray(frame).resize((new_w, new_h), Image.BILINEAR)
    return np.asarray(img)


def _normalize(frames: np.ndarray, mean: np.ndarray,
               std: np.ndarray) -> np.ndarray:
    """uint8 (..., 3) -> float32 normalised (ToTensor + Normalize)."""
    return (frames.astype(np.float32) / 255.0 - mean) / std


def imagenet_normalize(frames: np.ndarray) -> np.ndarray:
    return _normalize(frames, IMAGENET_MEAN, IMAGENET_STD)


def video_normalize(frames: np.ndarray) -> np.ndarray:
    return _normalize(frames, VIDEO_MEAN, VIDEO_STD)


def resize_video(video: np.ndarray, size: int) -> np.ndarray:
    """(T, H, W, 3) uint8 -> resized uint8, still on the host (the wire
    format: a quarter of the normalised float32 bytes)."""
    return np.stack([resize_shorter_side(f, size) for f in video])


def prepare_video(video: np.ndarray, size: int, kind: str) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T, h, w, 3) float32 ready for the extractor."""
    resized = resize_video(video, size)
    if kind == "google":
        return imagenet_normalize(resized)
    if kind == "r3d18":
        return video_normalize(resized)
    raise ValueError(kind)


def device_normalize(x: torch.Tensor, kind: str) -> torch.Tensor:
    """uint8 tensor (..., 3) -> normalised float32 on its device: the host
    functions' float32 formula, with every divisor a tensor on ``x``'s
    device, so each step is a true division (PyTorch turns a division by a
    Python scalar into a multiplication by its reciprocal on CUDA). On the
    CPU it is bit-equal to :func:`imagenet_normalize` /
    :func:`video_normalize`."""
    if kind not in ("google", "r3d18"):
        raise ValueError(kind)
    mean, std = ((IMAGENET_MEAN, IMAGENET_STD) if kind == "google"
                 else (VIDEO_MEAN, VIDEO_STD))
    dev = x.device
    scale = torch.tensor(255.0, dtype=torch.float32, device=dev)
    return ((x.to(torch.float32) / scale - torch.from_numpy(mean).to(dev))
            / torch.from_numpy(std).to(dev))

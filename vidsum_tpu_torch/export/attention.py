# ported from vidsum_tpu/export/attention.py
"""Attention-map export.

Behaviour (reference: ``src/train.py:155-165``): run the model over a
dataset and save per-video attention maps. The reference copies every
layer's weights to the host on every forward (``src/model/simnet.py:164``);
here the maps exist only inside this export, through ``SimNet``'s
``return_attn`` route (the plain dense attention), one device-to-host copy
a video, saved as an ``.npz`` of (L, H, N, N) arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vidsum_tpu_torch.config import Config
from vidsum_tpu_torch.data.collate import pad_batch


def collect_attention_weights(model, val_set, cfg: Config
                              ) -> Dict[str, np.ndarray]:
    """Per-video stacked attention maps (num_layers, H, N, N), unpadded, on
    the model's device."""
    dev = next(model.parameters()).device
    out: Dict[str, np.ndarray] = {}
    for i in range(len(val_set)):
        feats, target, user = val_set[i]
        n = feats.shape[0]
        x, _, mask = pad_batch([feats], [target], pad_value=cfg.data.pad_value,
                               bucket=cfg.data.length_bucket)
        with torch.inference_mode():
            _, _, maps = model(torch.from_numpy(x).to(dev),
                               torch.from_numpy(mask).to(dev),
                               return_attn=True)
            stacked = torch.stack([m[0, :, :n, :n] for m in maps])
        out[user.name] = stacked.float().cpu().numpy()
    return out


def save_attention_weights(model, val_set, cfg: Config,
                           path: str = "weights.npz") -> None:
    np.savez_compressed(path, **collect_attention_weights(model, val_set,
                                                          cfg))

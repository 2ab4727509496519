# ported from vidsum_tpu/models/torch_convert.py
"""Weights across the two packages.

:func:`params_from_jax` turns the JAX package's SimNet parameter tree (with
numpy leaves) into a state dict for :class:`~vidsum_tpu_torch.models.simnet.
SimNet`, keyed like the reference's checkpoints
(``embedding_layer.feature_transform.*``, ``encoder.module_list.{i}.*``,
``final_layer.*``). Linear weights transpose from the JAX (in, out) layout to
nn.Linear's (out, in). :func:`params_to_jax` is its inverse, for tests.
:func:`pretrain_params_from_jax` / :func:`pretrain_params_to_jax` do the
same for the pretraining model (``{"encoder", "video_transform"}`` <->
``encoder.*``, ``video_transform.*``, the reference ``PretrainModel``'s
keys). :func:`load_torch_checkpoint` reads a reference-trained ``.pth``
(``model_mae.pth`` or ``pretrain.pth``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Params = Dict[str, Any]


def _put_linear(out: Dict[str, torch.Tensor], prefix: str, p: Params) -> None:
    out[f"{prefix}.weight"] = torch.tensor(np.asarray(p["w"], np.float32).T)
    out[f"{prefix}.bias"] = torch.tensor(np.asarray(p["b"], np.float32))


def _put_ln(out: Dict[str, torch.Tensor], prefix: str, p: Params) -> None:
    out[f"{prefix}.weight"] = torch.tensor(np.asarray(p["scale"], np.float32))
    out[f"{prefix}.bias"] = torch.tensor(np.asarray(p["bias"], np.float32))


def params_from_jax(params: Params) -> Dict[str, torch.Tensor]:
    """JAX SimNet parameter tree (numpy or array leaves) -> state dict."""
    out: Dict[str, torch.Tensor] = {}
    _put_linear(out, "embedding_layer.feature_transform", params["embed"])
    for i, block in enumerate(params["blocks"]):
        pfx = f"encoder.module_list.{i}"
        _put_linear(out, f"{pfx}.sa.q", block["attn"]["q"])
        _put_linear(out, f"{pfx}.sa.k", block["attn"]["k"])
        _put_linear(out, f"{pfx}.sa.v", block["attn"]["v"])
        _put_linear(out, f"{pfx}.sa.feature_projection", block["attn"]["proj"])
        _put_linear(out, f"{pfx}.mlp.fc1", block["mlp"]["fc1"])
        _put_linear(out, f"{pfx}.mlp.fc2", block["mlp"]["fc2"])
        _put_ln(out, f"{pfx}.norm1", block["ln1"])
        _put_ln(out, f"{pfx}.norm2", block["ln2"])
    _put_linear(out, "final_layer", params["head"])
    if "cls" in params:
        out["embedding_layer.cls_token"] = torch.tensor(
            np.asarray(params["cls"], np.float32))
    return out


def params_to_jax(state: Dict[str, torch.Tensor]) -> Params:
    """Inverse of :func:`params_from_jax`: a state dict -> a JAX-layout
    parameter tree with numpy leaves."""
    def arr(key):
        return state[key].detach().cpu().float().numpy()

    def linear(prefix):
        return {"w": np.ascontiguousarray(arr(f"{prefix}.weight").T),
                "b": arr(f"{prefix}.bias")}

    def ln(prefix):
        return {"scale": arr(f"{prefix}.weight"), "bias": arr(f"{prefix}.bias")}

    n_layers = 1 + max(int(k.split(".")[2]) for k in state
                       if k.startswith("encoder.module_list."))
    params: Params = {
        "embed": linear("embedding_layer.feature_transform"),
        "blocks": [],
        "head": linear("final_layer"),
    }
    for i in range(n_layers):
        pfx = f"encoder.module_list.{i}"
        params["blocks"].append({
            "attn": {"q": linear(f"{pfx}.sa.q"), "k": linear(f"{pfx}.sa.k"),
                     "v": linear(f"{pfx}.sa.v"),
                     "proj": linear(f"{pfx}.sa.feature_projection")},
            "mlp": {"fc1": linear(f"{pfx}.mlp.fc1"),
                    "fc2": linear(f"{pfx}.mlp.fc2")},
            "ln1": ln(f"{pfx}.norm1"),
            "ln2": ln(f"{pfx}.norm2"),
        })
    if "embedding_layer.cls_token" in state:
        params["cls"] = arr("embedding_layer.cls_token")
    return params


def pretrain_params_from_jax(params: Params) -> Dict[str, torch.Tensor]:
    """JAX pretraining parameter tree ``{"encoder", "video_transform"}`` ->
    a state dict for :class:`~vidsum_tpu_torch.models.pretrain.
    PretrainModel`."""
    out = {f"encoder.{k}": v
           for k, v in params_from_jax(params["encoder"]).items()}
    _put_linear(out, "video_transform", params["video_transform"])
    return out


def pretrain_params_to_jax(state: Dict[str, torch.Tensor]) -> Params:
    """Inverse of :func:`pretrain_params_from_jax`."""
    enc = {k[len("encoder."):]: v for k, v in state.items()
           if k.startswith("encoder.")}
    w, b = (state[f"video_transform.{n}"].detach().cpu().float().numpy()
            for n in ("weight", "bias"))
    return {"encoder": params_to_jax(enc),
            "video_transform": {"w": np.ascontiguousarray(w.T), "b": b}}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference-trained ``.pth`` as a state dict: ``model_mae.pth`` for
    :class:`~vidsum_tpu_torch.models.simnet.SimNet`, ``pretrain.pth`` for
    :class:`~vidsum_tpu_torch.models.pretrain.PretrainModel`. Its keys are
    the port's module names already; the positional-encoding buffer (a key
    ending in ``pe``, recomputed in closed form here) is dropped."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in state.items() if k.split(".")[-1] != "pe"}

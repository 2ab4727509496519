# ported from vidsum_tpu/parallel/sharding.py
"""The tensor-parallel layout of SimNet's parameters: Megatron's column /
row pairing, as the JAX package annotates it for GSPMD.

- attention q / k / v: column-sharded over ``model`` (their outputs are the
  ``H * Dh`` head channels, so a shard holds whole heads where ``model``
  divides H); their biases alike;
- the attention's output projection (``feature_projection``): row-sharded
  (its input is the head channels), so each shard's product is a partial
  sum that the step sums over ``model`` before the bias and the residual;
  its bias replicated;
- MLP ``fc1`` column-sharded, ``fc2`` row-sharded, the same pairing;
- embed, head, LayerNorms, the CLS token and ``video_transform``:
  replicated.

In torch's ``(out, in)`` weight layout a JAX column shard (``P(None,
"model")`` on ``(in, out)``) is a block of weight rows, a row shard a block
of weight columns. The state dict keeps the reference's keys: the slices
are cut from the whole parameters at each step (views where the entries
repeat a device), so checkpoints carry no layout.
"""

from __future__ import annotations

from typing import Dict

import torch

# block-relative module -> "col" (out channels sharded) or "row" (in)
LAYOUT = {"sa.q": "col", "sa.k": "col", "sa.v": "col",
          "sa.feature_projection": "row", "mlp.fc1": "col",
          "mlp.fc2": "row"}


def block_shard(block: torch.nn.Module, m: int, M: int,
                num_heads: int) -> Dict[str, torch.Tensor]:
    """Model shard ``m`` of ``M``'s slices of one encoder block's sharded
    parameters, by block-relative key (``"sa.q.weight"``, ...; a row-
    sharded module's bias is replicated and not among them). Slices of the
    parameters themselves, so gradients flow back into them."""
    if num_heads % M:
        raise ValueError(f"{num_heads} heads do not split over model={M}")
    out = {}
    for mod_name, kind in LAYOUT.items():
        lin = block.get_submodule(mod_name)
        if lin.out_features % M if kind == "col" else lin.in_features % M:
            raise ValueError(f"{mod_name} does not split over model={M}")
        if kind == "col":
            n = lin.out_features // M
            out[mod_name + ".weight"] = lin.weight[m * n:(m + 1) * n]
            out[mod_name + ".bias"] = lin.bias[m * n:(m + 1) * n]
        else:
            n = lin.in_features // M
            out[mod_name + ".weight"] = lin.weight[:, m * n:(m + 1) * n]
    return out

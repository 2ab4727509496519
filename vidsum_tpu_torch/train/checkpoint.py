# ported from vidsum_tpu/train/checkpoint.py
"""Checkpoints: ``torch.save`` files with a JSON metadata sidecar, an
asynchronous writer, and one reader for both packages' files.

The reference saves whole state dicts to fixed file names every epoch
(``model_mae.pth``, ``src/train.py:95``) with weight-only warm starts. Here,
as in the JAX package, the model file holds the scorer's parameters (its
``state_dict()``, keyed like the reference's checkpoints; the positional
encoding is recomputed, not stored) and the resume state file
``{"params": ..., "opt_state": optimizer.state_dict()}``; ``path +
".meta.json"`` holds the metadata (``epoch``, ``split`` and, for the state
file, ``per_split``, ``fs``, ``ks``, ``ss``) in the JAX package's schema.

:func:`load_checkpoint` tells the formats apart by their first bytes: a zip
archive (``PK\\x03\\x04``) is a ``torch.save`` file, read with
``torch.load(weights_only=True)``; a msgpack map is the JAX package's flax
file, read by :mod:`~vidsum_tpu_torch.train.flax_msgpack` (plain Python).
:func:`load_model_state` gives a scorer ``state_dict`` from either.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import torch

from vidsum_tpu_torch.models.convert import params_from_jax
from vidsum_tpu_torch.train import flax_msgpack

ZIP_MAGIC = b"PK\x03\x04"


def host_snapshot(tree: Any) -> Any:
    """A copy of ``tree`` whose tensors are detached CPU copies. A model's
    and an optimizer's ``state_dict()`` hand out the live tensors that the
    next step updates in place (on the CPU they are the parameters), so a
    checkpoint written on another thread takes a snapshot first."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_snapshot(v) for v in tree)
    return tree


def save_checkpoint(path: str, tree: Any,
                    meta: Optional[Dict] = None) -> None:
    """Write a tree of tensors (+ the JSON metadata sidecar) atomically."""
    _write(path, host_snapshot(tree), meta)


def _write(path: str, host_tree: Any, meta: Optional[Dict]) -> None:
    tmp = path + ".tmp"
    torch.save(host_tree, tmp)
    os.replace(tmp, path)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


class AsyncCheckpointer:
    """Overlap checkpoint encoding and disk writes with training.

    The copy to the host stays on the caller thread (:func:`host_snapshot`:
    it must see the current step's values); ``torch.save`` and the file
    write run on one background thread. Writes happen in submission order,
    and the tmp -> ``os.replace`` step keeps every file on disk whole. Call
    :meth:`flush` before reading a file back (and at the end of training);
    a failed write re-raises there.
    """

    def __init__(self) -> None:
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._pending = []

    def save(self, path: str, host_tree: Any,
             meta: Optional[Dict] = None) -> None:
        """Queue an already-snapshotted (host-side) tree for writing."""
        self._pending.append(self._pool.submit(_write, path, host_tree, meta))

    def flush(self) -> None:
        """Block until ALL queued writes finish, then re-raise the first
        failure (awaiting everything first means a second flush() after a
        caught error cannot return while a write is still in flight)."""
        pending, self._pending = self._pending, []
        first_err = None
        for fut in pending:
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 - re-raised below
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err


def checkpoint_format(path: str) -> str:
    """``"torch"`` for a ``torch.save`` zip archive, ``"flax"`` for the JAX
    package's msgpack file; ``ValueError`` for anything else."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == ZIP_MAGIC:
        return "torch"
    if flax_msgpack.is_msgpack_map(head):
        return "flax"
    raise ValueError(f"{path}: neither a torch.save archive nor a JAX "
                     f"(flax msgpack) checkpoint (first bytes {head!r})")


def load_checkpoint(path: str) -> Tuple[Any, Optional[Dict]]:
    """Read a checkpoint of either package: ``(tree, meta)``, ``meta`` from
    the ``.meta.json`` sidecar or None. A ``torch.save`` file gives what was
    saved (tensors on the CPU); a JAX file gives its flax state dict with
    numpy leaves (lists as maps keyed ``"0"``, ``"1"``, ...)."""
    if checkpoint_format(path) == "torch":
        tree = torch.load(path, map_location="cpu", weights_only=True)
    else:
        with open(path, "rb") as f:
            tree = flax_msgpack.restore(f.read())
    meta = None
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return tree, meta


def load_model_state(path: str) -> Tuple[Dict[str, torch.Tensor],
                                         Optional[Dict]]:
    """A scorer ``state_dict`` (and the metadata) from a model checkpoint of
    either package: the port's as saved, the JAX package's parameter tree
    through ``models.convert.params_from_jax``."""
    tree, meta = load_checkpoint(path)
    if checkpoint_format(path) == "torch":
        return tree, meta
    params = flax_msgpack.lists_from_dicts(tree)
    if not isinstance(params, dict) or "embed" not in params:
        raise ValueError(f"{path}: a JAX checkpoint, but not a SimNet "
                         f"parameter tree")
    return params_from_jax(params), meta

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
:func:`restore_train_state` restarts a model and its Adam from a resume
state file of either package (``train_state.ckpt``,
``pretrain_state.ckpt``): a JAX file's optax state goes through
:func:`adam_state_from_jax`.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
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


def _adam_part(opt_tree: Any) -> Dict[str, Any]:
    """The ``{"count", "mu", "nu"}`` map of the flax state dict of the JAX
    package's ``make_optimizer``: ``optax.chain(add_decayed_weights(wd),
    adam(lr))`` is ``{"0": {}, "1": ADAM}`` and ``adam(lr)`` alone (weight
    decay 0) is ``ADAM``, where ``ADAM`` = ``{"0": {"count", "mu", "nu"},
    "1": {} or {"count"}}`` (``"1"`` holds the schedule's count when the
    rate is a schedule). Anything else raises ``ValueError``."""
    def is_adam(t):
        return (isinstance(t, dict) and set(t) == {"0", "1"}
                and isinstance(t["0"], dict)
                and set(t["0"]) == {"count", "mu", "nu"}
                and isinstance(t["1"], dict) and set(t["1"]) <= {"count"})

    if is_adam(opt_tree):
        return opt_tree["0"]
    if (isinstance(opt_tree, dict) and set(opt_tree) == {"0", "1"}
            and opt_tree["0"] == {} and is_adam(opt_tree["1"])):
        return opt_tree["1"]["0"]
    shape = (sorted(opt_tree) if isinstance(opt_tree, dict)
             else type(opt_tree).__name__)
    raise ValueError(
        f"not the JAX package's Adam state (optax.chain(add_decayed_weights,"
        f" adam) or adam): top level {shape}")


def adam_state_from_jax(opt_tree: Any, params_map: Callable[[Any], Dict],
                        optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The JAX package's Adam state (a flax state dict with numpy leaves, as
    :func:`load_checkpoint` reads it) as a ``state_dict`` for torch's Adam
    ``optimizer`` (built by ``train.steps.make_optimizer``, which keeps the
    parameter names). ``count`` becomes every parameter's ``step``, ``mu``
    its ``exp_avg`` and ``nu`` its ``exp_avg_sq``; the moments go through
    ``params_map`` (``models.convert.params_from_jax`` or
    ``pretrain_params_from_jax``), the parameters' own mapping. Moments of
    parameters the optimizer does not hold (a frozen ``video_transform``)
    are dropped. A tree of another shape, a missing moment or a leaf whose
    shape differs from its parameter's raises ``ValueError`` naming it."""
    adam = _adam_part(opt_tree)
    count = np.asarray(adam["count"])
    if count.shape != () or count.dtype.kind not in "iu":
        raise ValueError(f"JAX Adam state: count is {count.dtype} of shape "
                         f"{count.shape}, not an integer scalar")
    moments = {}
    for key in ("mu", "nu"):
        try:
            moments[key] = params_map(flax_msgpack.lists_from_dicts(adam[key]))
        except (KeyError, TypeError, IndexError, AttributeError) as e:
            raise ValueError(f"JAX Adam state: {key} is not a parameter tree "
                             f"of this model ({type(e).__name__}: {e})"
                             ) from None
    sd = optimizer.state_dict()
    state = {}
    for live, saved in zip(optimizer.param_groups, sd["param_groups"]):
        names = live.get("param_names")
        if names is None:
            raise ValueError("the optimizer has no parameter names: build it "
                             "with train.steps.make_optimizer")
        for name, p, idx in zip(names, live["params"], saved["params"]):
            entry = {"step": torch.tensor(float(count), dtype=torch.float32)}
            for key, out in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                leaf = moments[key].get(name)
                if leaf is None:
                    raise ValueError(f"JAX Adam state: no {key} for {name}")
                if tuple(leaf.shape) != tuple(p.shape):
                    raise ValueError(
                        f"JAX Adam state: {key} of {name} has shape "
                        f"{tuple(leaf.shape)}, the parameter "
                        f"{tuple(p.shape)}")
                entry[out] = leaf
            state[idx] = entry
    return {"state": state, "param_groups": sd["param_groups"]}


def restore_train_state(path: str, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer,
                        params_map: Callable[[Any], Dict] = params_from_jax
                        ) -> Optional[Dict]:
    """Load a resume state file ``{"params", "opt_state"}`` of either
    package into ``model`` and ``optimizer``; returns its metadata. The
    port's file holds a ``state_dict`` of each; the JAX package's holds
    flax trees, which go through ``params_map`` (the JAX -> state-dict key
    mapping of ``model``) and :func:`adam_state_from_jax`."""
    tree, meta = load_checkpoint(path)
    if not isinstance(tree, dict) or not {"params", "opt_state"} <= set(tree):
        raise ValueError(f"{path}: not a resume state file (no params and "
                         f"opt_state)")
    if checkpoint_format(path) == "torch":
        model.load_state_dict(tree["params"])
        optimizer.load_state_dict(tree["opt_state"])
        return meta
    try:
        params = params_map(flax_msgpack.lists_from_dicts(tree["params"]))
    except (KeyError, TypeError, IndexError, AttributeError) as e:
        raise ValueError(f"{path}: the JAX parameters are not this model's "
                         f"({type(e).__name__}: {e})") from None
    model.load_state_dict(params)
    optimizer.load_state_dict(adam_state_from_jax(tree["opt_state"],
                                                  params_map, optimizer))
    return meta

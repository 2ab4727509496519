# ported from vidsum_tpu/parallel/distributed.py
"""Multi-process runs on ``torch.distributed``.

The JAX package joins processes into one runtime with
``jax.distributed.initialize`` and lets the same mesh code span every
process's devices. Here each process holds a
:class:`~vidsum_tpu_torch.parallel.mesh.DeviceMesh` of its own entries
(:func:`global_mesh`), the data axis of the run is the processes' data axes
laid end to end (process-major, as the JAX mesh lays them out), and the
training steps add one collective on top of their in-process shard sum: the
gradients, the loss and the batch's denominators are all-reduced over the
processes (:func:`all_reduce`).

Multi-process discipline (``train/finetune.py``, ``train/pretraining.py``):

- every process runs the same driver loop on the same data order (the
  shuffle and dropout streams are seeded alike, so nothing is broadcast);
- each process places only its own rows of a batch (:func:`put_batch`);
- files (checkpoints, metrics, summaries) are written by the coordinator
  alone (:func:`is_coordinator`); a resume reads them from a shared
  filesystem;
- the eval pass runs on every process from the same parameters.

Restart discipline: the coordinator's ``train_state.ckpt`` holds the whole
state (parameters, Adam moments, epoch cursor, per-fold history) and the
streams are per (split, epoch), so after any process dies the procedure is
to stop the others and relaunch all of them with ``resume=True`` (the same
process count): the run replays bit for bit from the last saved epoch.

Backend: NCCL will not give one card to two ranks, so the backend follows
the placement (:func:`pick_backend`): gloo where the ranks share a card or
run on the CPU, NCCL where each rank has a card of its own. Under gloo a
CUDA tensor is all-reduced through a host copy (a synchronous ``.cpu()``
into pageable memory, reduced there and copied back), under NCCL on the
card.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import List, Optional, Sequence

import torch

from vidsum_tpu_torch.config import MeshConfig
from vidsum_tpu_torch.parallel.mesh import DeviceMesh, make_mesh, shard_rows


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Multi-process wiring; ``num_processes <= 1`` is a single process (a
    no-op). The fields default from the JAX package's environment
    variables, so a launcher may configure by environment alone.
    ``local_device_ids`` names the cards this process owns (under NCCL the
    first becomes its current card; default: card ``process_id`` where
    every rank can have its own, else every visible card, shared)."""

    coordinator_address: Optional[str] = None   # "host:port" of process 0
    num_processes: int = 1
    process_id: int = 0
    local_device_ids: Optional[tuple] = None

    @staticmethod
    def from_env() -> "DistributedConfig":
        return DistributedConfig(
            coordinator_address=os.environ.get("VIDSUM_COORDINATOR"),
            num_processes=int(os.environ.get("VIDSUM_NUM_PROCESSES", "1")),
            process_id=int(os.environ.get("VIDSUM_PROCESS_ID", "0")),
        )


def pick_backend(cfg: DistributedConfig) -> str:
    """``"nccl"`` where each rank has a card of its own (named by
    ``local_device_ids``, or as many visible cards as processes), else
    ``"gloo"`` (ranks that share a card, or the CPU)."""
    if not torch.cuda.is_available():
        return "gloo"
    if cfg.local_device_ids is not None:
        return "nccl"
    return ("nccl" if torch.cuda.device_count() >= cfg.num_processes
            else "gloo")


def init_distributed(cfg: Optional[DistributedConfig] = None
                     ) -> Optional[str]:
    """Join the run's process group (``tcp://`` at the coordinator's
    address). Call once, before the first step. A no-op for one process,
    so drivers call it unconditionally. Returns the backend (None for one
    process)."""
    cfg = cfg or DistributedConfig.from_env()
    if cfg.num_processes <= 1:
        return None
    if cfg.coordinator_address is None:
        raise ValueError("multi-process run needs coordinator_address "
                         "(process 0's host:port)")
    backend = pick_backend(cfg)
    if backend == "nccl":
        ids = (cfg.local_device_ids if cfg.local_device_ids is not None
               else (cfg.process_id,))
        torch.cuda.set_device(int(ids[0]))
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{cfg.coordinator_address}",
        world_size=cfg.num_processes, rank=cfg.process_id,
        timeout=timedelta(minutes=15))
    return backend


def process_count() -> int:
    dist = torch.distributed
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def process_index() -> int:
    dist = torch.distributed
    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def is_coordinator() -> bool:
    """True on the process that writes files (checkpoints, metrics,
    exports); a single process is trivially the coordinator."""
    return process_index() == 0


def global_mesh(cfg: Optional[MeshConfig] = None,
                devices=None) -> DeviceMesh:
    """This process's part of a run's mesh. ``cfg.data`` counts the data
    axis over every process (``-1``: every entry); the process holds
    ``cfg.data / processes`` of it over ``devices`` (default: under NCCL
    the card :func:`init_distributed` gave the process, else every visible
    card, shared by the processes)."""
    cfg = cfg or MeshConfig()
    n = process_count()
    data = cfg.data
    if data > 0:
        if data % n:
            raise ValueError(f"data axis {data} does not split over {n} "
                             f"processes")
        data //= n
    if (devices is None and n > 1
            and torch.distributed.get_backend() == "nccl"):
        devices = [f"cuda:{torch.cuda.current_device()}"]
    return make_mesh(MeshConfig(data=data, model=cfg.model,
                                axis_names=cfg.axis_names), devices)


def axis_entries(mesh: DeviceMesh, axis: str) -> List[torch.device]:
    """The first entry of each index along ``axis`` (where a shard of that
    axis starts)."""
    k = mesh.axis_names.index(axis)
    arr = mesh.array.transpose([k] + [i for i in range(mesh.array.ndim)
                                      if i != k])
    return list(arr.reshape(arr.shape[0], -1)[:, 0])


def put_batch(mesh: DeviceMesh, *arrays, batch_axis: str = "data"):
    """This process's rows of host batch arrays (the global batch, alike on
    every process), cut along dimension 0 into one shard per index of
    ``batch_axis`` and each placed on that index's first entry. Returns a
    list of shards per array (one array: its list); ``None`` passes
    through (optional item weights)."""
    devs = axis_entries(mesh, batch_axis)
    n, rank = process_count(), process_index()
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        t = torch.as_tensor(a)
        mine = shard_rows(t, n, 0)[rank] if n > 1 else t
        out.append([c.to(d, non_blocking=True)
                    for c, d in zip(shard_rows(mine, len(devs), 0), devs)])
    return out[0] if len(out) == 1 else tuple(out)


def all_reduce(tensors: Sequence[torch.Tensor], op: str = "sum"
               ) -> List[torch.Tensor]:
    """Each tensor summed (``op="max"``: the max) over the processes, as
    new tensors on the same devices, in one collective; the tensors
    themselves where there is one process. Under gloo a CUDA buffer goes
    through a host copy."""
    tensors = list(tensors)
    if process_count() <= 1:
        return tensors
    dist = torch.distributed
    flat = torch.cat([t.reshape(-1).to(tensors[0].device, torch.float32)
                      for t in tensors])
    staged = (flat.cpu() if flat.is_cuda and dist.get_backend() == "gloo"
              else flat)
    dist.all_reduce(staged, dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX)
    flat = staged.to(flat.device)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape)
                   .to(t.device, t.dtype))
        start += t.numel()
    return out

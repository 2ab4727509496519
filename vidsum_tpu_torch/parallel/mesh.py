# ported from vidsum_tpu/parallel/mesh.py
"""A single-process device mesh.

The JAX package's multi-device modes are single-controller: one process runs
``shard_map`` (or a GSPMD-partitioned ``jit``) over a ``jax.sharding.Mesh``.
The port keeps that shape without ``torch.distributed``: a
:class:`DeviceMesh` is a grid of ``torch.device`` entries in one process with
named axes, and an entry may repeat a device. D shards then live on one card
(or on the CPU, as the tests run them), exactly as the JAX tests hold D
shards on one CPU's virtual devices; the kernels, launch counts and
arithmetic are those of D cards, and only the moves between entries change:
``.to(entry)`` is the tensor itself where two entries share a device and a
peer copy where they do not.

The axes the modes use: ``("data", "seq")`` for the sequence-parallel ring,
``("data", "model")`` (``MeshConfig``) for data and tensor parallelism,
``("data", "seq", "model")`` for the composed step and ``("stage",)`` for the
pipeline. Entries map onto the devices in grid order (row-major):
``make_mesh((1, 4), ["cuda:0"])`` puts all four on one card,
``make_mesh((1, 4), ["cuda:0", "cuda:1"])`` alternates two cards, and
``devices=None`` cycles over every visible card.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from vidsum_tpu_torch.config import MeshConfig
from vidsum_tpu_torch.device import resolve_device


class DeviceMesh:
    """A grid of ``torch.device`` entries with named axes. ``shape`` maps
    each axis name to its size, as ``jax.sharding.Mesh.shape`` does;
    ``grid`` is the entries as nested lists (``grid[i][s]`` on a 2-axis
    mesh)."""

    def __init__(self, grid, axis_names: Sequence[str] = ("data", "seq")
                 ) -> None:
        names = tuple(axis_names)
        arr = np.empty(np.shape(np.asarray(grid, dtype=object)),
                       dtype=object)
        flat = np.asarray(grid, dtype=object).reshape(-1)
        if arr.ndim != len(names) or flat.size == 0:
            raise ValueError(f"a mesh is a non-empty rectangular grid of "
                             f"rank {len(names)} (axes {names})")
        if len(set(names)) != len(names):
            raise ValueError(f"axis names must differ, got {names}")
        arr.reshape(-1)[:] = [torch.device(d) for d in flat]
        self.array = arr
        self.axis_names = names
        self.grid = arr.tolist()
        self.shape = dict(zip(names, arr.shape))

    @property
    def devices(self) -> List[torch.device]:
        """The entries in grid order (row-major), repeats included."""
        return list(self.array.reshape(-1))

    @property
    def size(self) -> int:
        return int(self.array.size)


def _device_list(devices) -> List[torch.device]:
    """``devices`` (a device, a list of them, or None for the visible CUDA
    cards, raising without one) resolved."""
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    return [resolve_device(d) for d in devices]


def make_mesh(shape: Union[Tuple[int, ...], MeshConfig, None] = None,
              devices=None,
              axis_names: Sequence[str] = ("data", "seq")) -> DeviceMesh:
    """A mesh over ``devices`` (a device, a list of entries, or ``None``:
    the visible CUDA cards, raising without one; pass ``"cpu"`` for the
    plain path).

    - ``shape`` a tuple (``(data, seq)`` by default, or one size per
      ``axis_names``): the entries cycle over ``devices``, so one device
      may fill every entry.
    - ``shape`` a :class:`MeshConfig` (or None, its defaults): the JAX
      ``make_mesh``. The entries are ``devices`` as listed (repeat a device
      to put several entries on it), ``data == -1`` takes every entry the
      ``model`` axis does not, and a count that does not fill the grid
      raises ``ValueError`` with the JAX message."""
    if shape is None or isinstance(shape, MeshConfig):
        cfg = shape or MeshConfig()
        devs = _device_list(devices)
        n = len(devs)
        model = max(cfg.model, 1)
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = cfg.data if cfg.data > 0 else n // model
        if data * model != n:
            raise ValueError(f"mesh {data}x{model} != {n} devices")
        grid = np.empty(n, dtype=object)
        grid[:] = devs
        return DeviceMesh(grid.reshape(data, model), cfg.axis_names)
    sizes = tuple(int(n) for n in shape)
    if len(sizes) != len(tuple(axis_names)):
        raise ValueError(f"shape {shape} does not name one size per axis "
                         f"of {tuple(axis_names)}")
    if any(n < 1 for n in sizes):
        raise ValueError(f"mesh shape must be positive, got {shape}")
    devs = _device_list(devices)
    total = int(np.prod(sizes))
    grid = np.empty(total, dtype=object)
    grid[:] = [devs[i % len(devs)] for i in range(total)]
    return DeviceMesh(grid.reshape(sizes), axis_names)


def on(device: torch.device):
    """Make ``device`` the current card while a shard's work is issued (the
    hand-written kernels launch on the current card); nothing on the CPU."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def rotate(blocks: list, devs: Sequence[torch.device]) -> list:
    """One ring rotation (``jax.lax.ppermute`` with shard i -> i + 1): shard
    s receives the block of shard (s - 1) mod P, moved to ``devs[s]``. On
    one device ``.to`` returns the tensor itself (a list re-index); across
    cards it is a peer copy ordered on the current streams."""
    P = len(blocks)
    return [blocks[(s - 1) % P].to(devs[s], non_blocking=True)
            for s in range(P)]


def shard_rows(t: torch.Tensor, n: int, dim: int) -> list:
    """``t`` cut into ``n`` equal contiguous pieces along ``dim``."""
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {t.shape[dim]} does not "
                         f"split into {n} equal shards")
    return [c.contiguous() for c in torch.chunk(t, n, dim=dim)]


def place(mesh: DeviceMesh, t: torch.Tensor, seq_dim: int = 1) -> list:
    """The (data, seq) grid of shards of ``t`` (dimension 0 over ``data``,
    ``seq_dim`` over ``seq``), each on its mesh entry."""
    return [[c.to(mesh.grid[i][s], non_blocking=True)
             for s, c in enumerate(shard_rows(rows, mesh.shape["seq"],
                                              seq_dim))]
            for i, rows in enumerate(shard_rows(t, mesh.shape["data"], 0))]

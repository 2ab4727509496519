# ported from vidsum_tpu/parallel/mesh.py (a (data, seq) grid for the
# sequence-parallel ring; the (data, model) mesh of the tensor-parallel step
# arrives with the multi-GPU slice)
"""A single-process device mesh.

The JAX package's multi-device modes are single-controller: one process runs
``shard_map`` over a ``jax.sharding.Mesh`` and ``ppermute`` rotates K/V
between its devices. The port keeps that shape without ``torch.distributed``:
a :class:`DeviceMesh` is a (data, seq) grid of ``torch.device`` entries in
one process, and an entry may repeat a device. P ring shards then live on one
card (or on the CPU, as the tests run them), exactly as the JAX tests hold
P shards on one CPU's virtual devices; the ring's kernels, launch counts and
arithmetic are those of P cards, and only the rotation changes:
:func:`rotate` is a list re-index where neighbouring shards share a device
and a peer copy where they do not.

P shards map onto the cards in grid order: ``make_mesh((1, 4), ["cuda:0"])``
puts all four on one card, ``make_mesh((1, 4), ["cuda:0", "cuda:1"])``
alternates two cards, and ``devices=None`` cycles over every visible card.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import torch

from vidsum_tpu_torch.device import resolve_device


class DeviceMesh:
    """A (data, seq) grid of ``torch.device`` entries. ``shape`` maps each
    axis name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]) -> None:
        rows = [[torch.device(d) for d in row] for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid")
        self.grid: List[List[torch.device]] = rows
        self.shape = {"data": len(rows), "seq": len(rows[0])}

    @property
    def devices(self) -> List[torch.device]:
        """The entries in grid order (row-major), repeats included."""
        return [d for row in self.grid for d in row]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(shape: Tuple[int, int], devices=None) -> DeviceMesh:
    """A ``shape`` = (data, seq) mesh whose entries cycle over ``devices``
    (a device, or a list of them). ``None`` means the visible CUDA cards
    (raising without one); pass ``"cpu"`` for the plain path."""
    data, seq = (int(n) for n in shape)
    if data < 1 or seq < 1:
        raise ValueError(f"mesh shape must be positive, got {shape}")
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devs = [resolve_device(d) for d in devices]
    flat = [devs[i % len(devs)] for i in range(data * seq)]
    return DeviceMesh([flat[r * seq:(r + 1) * seq] for r in range(data)])


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

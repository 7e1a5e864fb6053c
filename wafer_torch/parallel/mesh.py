"""A single-process device mesh for the 3D grid (counterpart of
``wafer_tpu/parallel/mesh.py``).

The reference shards interior arrays over a ``jax.sharding.Mesh`` and
drives every local device from one process through ``shard_map``. Here a
:class:`Mesh` is a mesh shape and one torch device per shard, in row-major
rank order; a device may repeat, which places several shards on one card
(as the reference's tests place eight shards on one CPU). A sharded field is
a list of per-shard tensors in rank order: ``build_block`` and
:meth:`Mesh.blocks` say which part of the grid each shard holds.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_NAMES = ("gx", "gy", "gz")


def default_devices() -> List[torch.device]:
    """The devices a mesh takes when none are given: the visible CUDA
    devices, or the CPU when ``WAFER_DEVICE=cpu`` (as the CLI resolves its
    device)."""
    if torch.device(os.environ.get("WAFER_DEVICE", "cuda")).type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the ``cuda:i`` its tensors report."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """Mesh shape ``(mx, my, mz)`` and the device of each shard, rank
    ``r = (cx·my + cy)·mz + cz``. ``slices > 1`` marks a multi-slice mesh
    (:func:`~wafer_torch.parallel.multislice.make_multislice_mesh`): its x
    ring of ``mx = slices·gx`` shards is the reference's ``(sl, gx)`` ring
    linearised slice-major, and the sharded driver runs it with windows of
    ``slice_update`` steps between x exchanges."""

    def __init__(self, shape: Tuple[int, int, int], devices: Sequence[torch.device],
                 slices: int = 1):
        self.shape = tuple(int(m) for m in shape)
        self.devices = [_indexed(torch.device(d)) for d in devices]
        self.slices = int(slices)
        if len(self.devices) != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} devices, have {len(self.devices)}")
        if self.slices < 1 or self.shape[0] % self.slices:
            raise ValueError(f"{self.slices} slices do not divide the x ring of mesh {self.shape}")
        self._coords = [tuple(int(c) for c in np.unravel_index(r, self.shape))
                        for r in range(self.size)]

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def coords(self, rank: int) -> Tuple[int, int, int]:
        return self._coords[rank]

    def rank(self, coords) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.shape))

    def neighbour(self, rank: int, axis: int, step: int) -> Optional[int]:
        """The rank one step along ``axis`` (±1), or None past a global edge."""
        c = list(self.coords(rank))
        c[axis] += step
        if not 0 <= c[axis] < self.shape[axis]:
            return None
        return self.rank(c)

    def blocks(self, dims) -> List[Tuple[Tuple[int, int, int], Tuple[int, int, int]]]:
        """(extent, origin) of each shard's block of a grid of interior
        extents ``dims``, in rank order. Each axis must divide evenly, as
        ``shard_map`` demands of the reference."""
        dims = tuple(int(n) for n in dims)
        if any(n % m for n, m in zip(dims, self.shape)):
            raise ValueError(f"grid {dims} does not divide evenly over mesh {self.shape}")
        ext = tuple(n // m for n, m in zip(dims, self.shape))
        return [
            (ext, tuple(c * e for c, e in zip(self.coords(r), ext))) for r in range(self.size)
        ]

    def __repr__(self) -> str:
        sl = f", slices={self.slices}" if self.slices > 1 else ""
        return (f"Mesh({dict(zip(AXIS_NAMES, self.shape))}{sl}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(shape: Tuple[int, int, int], devices: Optional[Sequence] = None) -> Mesh:
    """Build a 3D mesh over ``shape = (mx, my, mz)`` shards, taking the
    first ``mx·my·mz`` of ``devices`` (default :func:`default_devices`).
    A device may repeat: ``devices=[cuda:0] * 8`` puts eight shards on one
    card."""
    devices = list(devices if devices is not None else default_devices())
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh {tuple(shape)} needs {n} devices, have {len(devices)}")
    return Mesh(shape, devices[:n])


def build_blocks(
    mesh: Mesh, dims, build_block: Callable, dtype: torch.dtype
) -> List[torch.Tensor]:
    """One block per shard from ``build_block(shape, offset)``, which returns
    the block of the global interior at ``offset`` with extents ``shape``
    (the reference's ``assemble_blocks``, mesh.py:41-71: per-shard
    generation, no global array), each placed on its shard's device."""
    return [
        torch.as_tensor(build_block(shape, offset)).to(device=dev, dtype=dtype).contiguous()
        for (shape, offset), dev in zip(mesh.blocks(dims), mesh.devices)
    ]

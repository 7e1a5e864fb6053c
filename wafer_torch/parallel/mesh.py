"""A device mesh for the 3D grid (counterpart of
``wafer_tpu/parallel/mesh.py``).

The reference shards interior arrays over a ``jax.sharding.Mesh`` and
drives every device of a process through ``shard_map``; in a multi-process
run the mesh spans every process's devices, process-major, and each process
builds only its addressable shards. Here a :class:`Mesh` is a mesh shape and
one torch device per shard, in row-major rank order; a device may repeat,
which places several shards on one card (as the reference's tests place
eight shards on one CPU). In a multi-process run
(:mod:`~wafer_torch.parallel.distributed`) the shards are dealt to the
processes in equal contiguous runs of ranks, process-major, and each process
holds only its own: a sharded field is the list of this process's blocks in
rank order (every block in a single-process run). ``build_blocks`` and
:meth:`Mesh.blocks` say which part of the grid each shard holds.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wafer_torch.parallel import distributed

AXIS_NAMES = ("gx", "gy", "gz")


def local_devices() -> List[torch.device]:
    """This process's devices: its rank's device in a multi-process run,
    else the visible CUDA devices, or the CPU when ``WAFER_DEVICE=cpu`` (as
    the CLI resolves its device)."""
    rt = distributed.runtime()
    if rt is not None:
        return [rt.device]
    if torch.device(os.environ.get("WAFER_DEVICE", "cuda")).type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _gathered() -> List[List[torch.device]]:
    """Each process's :func:`local_devices`, in process order: one
    ``all_gather_object`` in a multi-process run."""
    rt = distributed.runtime()
    if rt is None:
        return [local_devices()]
    import torch.distributed as dist

    names: List = [None] * rt.world
    dist.all_gather_object(names, [str(d) for d in local_devices()])
    return [[torch.device(d) for d in devs] for devs in names]


def take_devices(n: int, what: str, devices: Optional[Sequence] = None) -> List[torch.device]:
    """The first ``n`` of ``devices``; by default the first ``n`` of
    :func:`local_devices`, and in a multi-process run ``n / processes`` of
    each process's, process-major (the order of the reference's
    ``jax.devices()``), so that each process owns its shards' devices.
    ``what`` names the mesh in the error."""
    if devices is None:
        per_process = _gathered()
        if len(per_process) > 1:
            k, rem = divmod(n, len(per_process))
            short = [p for p, devs in enumerate(per_process) if len(devs) < k]
            if rem or short:
                raise ValueError(
                    f"{what} needs {n} devices over {len(per_process)} processes, have "
                    f"{[len(devs) for devs in per_process]}"
                )
            return [d for devs in per_process for d in devs[:k]]
        devices = per_process[0]
    devices = list(devices)
    if n > len(devices):
        raise ValueError(f"{what} needs {n} devices, have {len(devices)}")
    return devices[:n]


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the ``cuda:i`` its tensors report."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """Mesh shape ``(mx, my, mz)`` and the device of each shard, rank
    ``r = (cx·my + cy)·mz + cz``. In a run of P processes, process p owns
    the ranks ``local`` = ``[p·n/P, (p+1)·n/P)``; ``devices[r]`` of another
    process's shard is that device as its process names it. ``slices > 1``
    marks a multi-slice mesh
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
        self.processes = distributed.process_count()
        self.process = distributed.process_index()
        if self.size % self.processes:
            raise ValueError(
                f"mesh {self.shape} of {self.size} shards does not divide over "
                f"{self.processes} processes"
            )
        per = self.size // self.processes
        self.local = range(self.process * per, (self.process + 1) * per)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def spans(self) -> bool:
        """Whether the shards belong to more than one process."""
        return self.processes > 1

    @property
    def local_devices(self) -> List[torch.device]:
        """The devices of this process's shards, in rank order."""
        return [self.devices[r] for r in self.local]

    def is_local(self, rank: int) -> bool:
        """Whether shard ``rank`` belongs to this process."""
        return rank in self.local

    def owner(self, rank: int) -> int:
        """The process that holds shard ``rank``."""
        return rank // (self.size // self.processes)

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
        sl += f", processes={self.processes}" if self.spans else ""
        return (f"Mesh({dict(zip(AXIS_NAMES, self.shape))}{sl}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(shape: Tuple[int, int, int], devices: Optional[Sequence] = None) -> Mesh:
    """Build a 3D mesh over ``shape = (mx, my, mz)`` shards, taking the
    first ``mx·my·mz`` of ``devices`` (default: :func:`take_devices`, an
    equal share of each process's devices). A device may repeat:
    ``devices=[cuda:0] * 8`` puts eight shards on one card, and in a run of
    two processes four on each process's card."""
    n = int(np.prod(shape))
    return Mesh(shape, take_devices(n, f"mesh {tuple(shape)}", devices))


def build_blocks(
    mesh: Mesh, dims, build_block: Callable, dtype: torch.dtype
) -> List[torch.Tensor]:
    """One block per local shard from ``build_block(shape, offset)``, which
    returns the block of the global interior at ``offset`` with extents
    ``shape`` (the reference's ``assemble_blocks``, mesh.py:41-71:
    per-shard generation of the addressable shards only, no global array),
    each placed on its shard's device."""
    blocks = mesh.blocks(dims)
    return [
        torch.as_tensor(build_block(*blocks[r])).to(device=mesh.devices[r], dtype=dtype)
        .contiguous()
        for r in mesh.local
    ]

"""The multi-process entry (counterpart of
``wafer_tpu/parallel/distributed.py``).

The reference starts ``jax.distributed`` from ``WAFER_COORDINATOR`` (host:port
of process 0), ``WAFER_NUM_PROCESSES`` and ``WAFER_PROCESS_ID``; every
process then sees all devices as one list, process-major, and builds only
its own shards. The port starts ``torch.distributed`` from the same three
variables (``init_process_group`` over ``tcp://WAFER_COORDINATOR``). Each
process, a rank, owns a contiguous run of a mesh's shards
(:class:`~wafer_torch.parallel.mesh.Mesh`); the faces and sums that cross
ranks travel through :mod:`~wafer_torch.parallel.transport`.

``torch.distributed`` over TCP cannot detect the world size or the rank, as
``jax.distributed`` can on a TPU pod: both variables must be set.

The backend is chosen once, from the ranks' layout, which the ranks gather
over the default (gloo) group right after it starts, and logged:

- every rank on the CPU (``WAFER_DEVICE=cpu``): gloo;
- every rank on a card of its own: NCCL, in a second group that carries the
  data (the default group stays gloo, for host objects);
- ranks that share a card: gloo, with every CUDA tensor staged through
  pinned host buffers (NCCL refuses two ranks on one device).

A rank's card is ``WAFER_DEVICE`` when it names one (``cuda:1``), else
``cuda:(rank mod the visible cards)``. The choice never changes after a
failure: a collective that fails raises, and ``TIMEOUT`` bounds every
collective, so the peers of a rank that died stop too.
"""

from __future__ import annotations

import logging
import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import torch

from wafer_torch.errors import DistributedInitError

TIMEOUT = timedelta(minutes=30)  # longest wait of any collective on a peer


@dataclass(frozen=True)
class Runtime:
    """The started multi-process run: this process's ``rank`` of ``world``,
    its ``device``, the ``backend`` its data travels on (``group``), and
    whether CUDA tensors are ``staged`` through the host for it."""

    rank: int
    world: int
    device: torch.device
    backend: str
    staged: bool
    group: object


_runtime: Optional[Runtime] = None  # set once per process, as torch.distributed's own group


def _env_int(name: str) -> int:
    value = os.environ.get(name, "").strip()
    if not value:
        raise DistributedInitError(
            f"{name} must be set beside WAFER_COORDINATOR: torch.distributed over TCP "
            "cannot detect it"
        )
    try:
        return int(value)
    except ValueError as exc:
        raise DistributedInitError(f"{name}={value!r} is not an integer") from exc


def rank_device(rank: int) -> torch.device:
    """This rank's device: the CPU under ``WAFER_DEVICE=cpu``, the card
    ``WAFER_DEVICE`` names, else ``cuda:(rank mod visible cards)``."""
    device = torch.device(os.environ.get("WAFER_DEVICE", "cuda"))
    if device.type == "cuda" and device.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise DistributedInitError(
                "no CUDA device is visible; set WAFER_DEVICE=cpu to run the ranks on the CPU"
            )
        device = torch.device("cuda", rank % n)
    return device


def layout_of(device: torch.device) -> Tuple[str, str]:
    """(host, card): what tells two ranks' devices apart; the card is the
    CUDA device's UUID, or ``cpu``."""
    if device.type != "cuda":
        return socket.gethostname(), "cpu"
    return socket.gethostname(), str(torch.cuda.get_device_properties(device).uuid)


def choose_backend(layouts: Sequence[Tuple[str, str]]) -> Tuple[str, bool, str]:
    """(backend, staged, why) for the ranks' gathered ``layouts``."""
    cpu = [card == "cpu" for _host, card in layouts]
    if all(cpu):
        return "gloo", False, "every rank on the CPU"
    if any(cpu):
        raise DistributedInitError(
            "some ranks run on the CPU and some on CUDA; set WAFER_DEVICE alike on every rank"
        )
    if len(set(layouts)) == len(layouts):
        return "nccl", False, "every rank on a card of its own"
    return "gloo", True, "ranks share a card (NCCL refuses two ranks on one device)"


def maybe_initialize_distributed(log=None) -> bool:
    """Start ``torch.distributed`` from ``WAFER_COORDINATOR`` /
    ``WAFER_NUM_PROCESSES`` / ``WAFER_PROCESS_ID``. Returns False when
    ``WAFER_COORDINATOR`` is unset (the single-process run), True when the
    run is multi-process; a second call returns True and does nothing. A
    missing variable raises :class:`~wafer_torch.errors.DistributedInitError`
    naming it."""
    global _runtime
    coord = os.environ.get("WAFER_COORDINATOR")
    if not coord:
        return False
    if _runtime is not None:
        return True
    import torch.distributed as dist

    log = log or logging.getLogger("wafer")
    world = _env_int("WAFER_NUM_PROCESSES")
    rank = _env_int("WAFER_PROCESS_ID")
    if not 0 <= rank < world:
        raise DistributedInitError(f"WAFER_PROCESS_ID={rank} is outside 0..{world - 1}")
    device = rank_device(rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://{coord}", world_size=world, rank=rank,
                            timeout=TIMEOUT)
    layouts: List = [None] * world
    dist.all_gather_object(layouts, layout_of(device))
    backend, staged, why = choose_backend(layouts)
    group = dist.group.WORLD
    if backend == "nccl":
        group = dist.new_group(backend="nccl", timeout=TIMEOUT)
    _runtime = Runtime(rank, world, device, backend, staged, group)
    log.info(
        "torch.distributed started: process %d/%d on %s, coordinator %s; data over %s%s (%s)",
        rank, world, device, coord, backend, ", CUDA tensors staged through the host"
        if staged else "", why,
    )
    return True


def runtime() -> Optional[Runtime]:
    """The started run, or None in a single-process run."""
    return _runtime


def process_index() -> int:
    """This process's rank (0 in a single-process run)."""
    return 0 if _runtime is None else _runtime.rank


def process_count() -> int:
    """The run's processes (1 in a single-process run)."""
    return 1 if _runtime is None else _runtime.world


def shutdown() -> None:
    """End the multi-process run this process started (nothing otherwise)."""
    global _runtime
    if _runtime is None:
        return
    import torch.distributed as dist

    _runtime = None
    if dist.is_initialized():
        dist.destroy_process_group()

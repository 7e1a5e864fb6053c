"""Faces and sums between a mesh's shards, within a process and across
processes (the port's counterpart of the reference's ``ppermute`` and
``psum`` inside ``shard_map``).

Within a process a face is a ``copy_`` of a slice: across devices ``copy_``
orders itself after the source device's stream, so nothing waits on the
host. Across processes (:mod:`~wafer_torch.parallel.distributed`):

- the faces of one exchange stage travel in one ``dist.batch_isend_irecv``,
  every process posting its sends and its receives in the same global order
  (with the transfer's index as tag), each through a contiguous staging
  buffer that the plan owns;
- per-shard values and partial rows are all-gathered, each process giving
  its contiguous run of shards, so that every process holds every shard's
  values in rank order and adds them as a single process does, bit for bit.

Under NCCL the buffers live on the card and nothing waits on the host.
Under gloo with CUDA tensors (ranks that share a card) they are pinned host
memory: a stage copies its outgoing faces down, waits for the stream, sends
and receives, and copies the incoming faces up, one device→host sync per
stage that crosses processes; a gather does the same. Gloo on the CPU sends
the CPU buffers as they are. A bf16 face (a stored state streamed in bf16)
travels as its bytes, an int16 view, which every backend carries exactly.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from wafer_torch.parallel import distributed
from wafer_torch.parallel.mesh import Mesh

Cut = Tuple[int, int, int]  # (dim, start, length) of a ``narrow``
# (destination rank, its cut, source rank or None for zeros, its cut)
Transfer = Tuple[int, Cut, Optional[int], Optional[Cut]]


def _staged(device: torch.device) -> bool:
    rt = distributed.runtime()
    return rt is not None and rt.staged and device.type == "cuda"


def _wire(view: torch.Tensor) -> torch.Tensor:
    """``view`` as the backends carry it: a bf16 view as its bytes (int16,
    the same bits; a cast would round through another type), any other as
    it is."""
    return view.view(torch.int16) if view.dtype == torch.bfloat16 else view


def _buffer_for(view: torch.Tensor) -> torch.Tensor:
    """A contiguous buffer that carries ``view`` across processes: pinned
    host memory when CUDA tensors are staged, else on ``view``'s device."""
    if _staged(view.device):
        return torch.empty(view.shape, dtype=view.dtype, pin_memory=True)
    return torch.empty(view.shape, dtype=view.dtype, device=view.device)


def _wait_for_streams(devices) -> None:
    """Host waits for the devices' current streams: staged buffers are
    complete (outgoing) and free again (incoming) after it."""
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class _Stage:
    """One stage of an exchange: local copies, then the transfers that
    cross processes in one ``batch_isend_irecv``."""

    def __init__(self, copies, sends, recvs):
        self.copies = copies  # (destination view, source view or None)
        self.sends = sends    # (peer process, tag, face view, buffer)
        self.recvs = recvs    # (peer process, tag, halo view, buffer)
        self.staged = {v.device for _p, _t, v, _b in sends + recvs if _staged(v.device)}

    def __len__(self) -> int:
        return len(self.copies) + len(self.sends) + len(self.recvs)

    def run(self) -> None:
        for dst, src in self.copies:
            if src is None:
                dst.zero_()
            else:
                dst.copy_(src, non_blocking=True)
        if not (self.sends or self.recvs):
            return
        import torch.distributed as dist

        group = distributed.runtime().group
        for _p, _t, view, buf in self.sends:
            buf.copy_(view, non_blocking=True)
        _wait_for_streams(self.staged)
        ops = [dist.P2POp(dist.isend, buf, peer, group, tag) for peer, tag, _v, buf in self.sends]
        ops += [dist.P2POp(dist.irecv, buf, peer, group, tag) for peer, tag, _v, buf in self.recvs]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for _p, _t, view, buf in self.recvs:
            view.copy_(buf, non_blocking=True)


class Exchange:
    """A face exchange over ``mesh``, planned once for this process's
    ``dst_blocks`` and ``src_blocks`` (its blocks in rank order; one list for
    a halo exchange) and replayed with :meth:`run`; the views stay valid
    while the blocks live. ``stages`` are run in order, each a list of
    :data:`Transfer`: a stage may read what an earlier one wrote (a y face
    carries the x halos). A transfer between two of this process's shards
    is a copy, one with another process's shard a send or a receive, and
    one between two other shards is not this process's."""

    def __init__(self, mesh: Mesh, dst_blocks: Sequence[torch.Tensor],
                 src_blocks: Sequence[torch.Tensor], stages: Sequence[Sequence[Transfer]]):
        first = mesh.local.start

        def view(blocks, rank, cut):
            return blocks[rank - first].narrow(*cut)

        self.stages: List[_Stage] = []
        for transfers in stages:
            copies, sends, recvs = [], [], []
            for tag, (dst, dst_cut, src, src_cut) in enumerate(transfers):
                here = mesh.is_local(dst)
                there = src is not None and mesh.is_local(src)
                if here and (src is None or there):
                    copies.append((view(dst_blocks, dst, dst_cut),
                                   None if src is None else view(src_blocks, src, src_cut)))
                elif here:
                    v = _wire(view(dst_blocks, dst, dst_cut))
                    recvs.append((mesh.owner(src), tag, v, _buffer_for(v)))
                elif there:
                    v = _wire(view(src_blocks, src, src_cut))
                    sends.append((mesh.owner(dst), tag, v, _buffer_for(v)))
            self.stages.append(_Stage(copies, sends, recvs))

    def __len__(self) -> int:
        return sum(len(s) for s in self.stages)

    @property
    def crosses(self) -> bool:
        """Whether a transfer of this process crosses processes."""
        return any(s.sends or s.recvs for s in self.stages)

    def run(self) -> None:
        for stage in self.stages:
            stage.run()


class Gather:
    """All-gather over the run's processes, planned once for ``mine`` (this
    process's contiguous run of rows, in rank order) and ``out`` (every
    process's runs, process-major: ``out`` is P × ``mine``), and replayed
    with :meth:`run`. Only in a multi-process run."""

    def __init__(self, mine: torch.Tensor, out: torch.Tensor):
        rt = distributed.runtime()
        self.mine, self.out = mine, out
        self.group, self.nccl = rt.group, rt.backend == "nccl"
        staged = _staged(mine.device)
        self._devices = {mine.device} if staged else set()
        self._mine = _buffer_for(mine) if staged else mine
        self._out = _buffer_for(out) if staged else out
        self._parts = list(self._out.chunk(rt.world))

    def run(self) -> None:
        import torch.distributed as dist

        if self._mine is not self.mine:
            self._mine.copy_(self.mine, non_blocking=True)
        _wait_for_streams(self._devices)
        if self.nccl:
            dist.all_gather_into_tensor(self.out, self._mine, group=self.group)
        else:
            dist.all_gather(self._parts, self._mine, group=self.group)
        if self._out is not self.out:
            self.out.copy_(self._out, non_blocking=True)


def gather_shards(mesh: Mesh, mine: torch.Tensor) -> torch.Tensor:
    """``mine``, this process's shards' values stacked in rank order (the
    leading axis), as every shard's on every process: ``mine`` itself in a
    single-process mesh."""
    if not mesh.spans:
        return mine
    mine = mine.contiguous()
    out = torch.empty((mesh.size,) + tuple(mine.shape[1:]), dtype=mine.dtype, device=mine.device)
    Gather(mine, out).run()
    return out

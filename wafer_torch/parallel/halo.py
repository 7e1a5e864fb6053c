"""Ghost-cell (halo) exchange over a device mesh (counterpart of
``wafer_tpu/parallel/halo.py``).

Each shard stores its block padded, ``(bx+2e, by+2e, bz+2e)`` on the last
three axes, like every other field of the port. Before a sweep the
exchange writes each neighbour's interior faces into the ``ext``-wide halo,
axis by axis as the reference's ``_pad_axis`` does, so edges and corners
compose from the halos already filled. Halos at a global face hold zeros:
the Dirichlet boundary, which the reference gets from ``ppermute`` having
no source there. Between blocks on one device a face is a ``copy_`` of a
slice; across devices ``copy_`` orders itself after the source device's
current stream, so no host synchronisation is needed.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from wafer_torch.parallel.mesh import Mesh


def _slab(block: torch.Tensor, axis: int, start: int, length: int) -> torch.Tensor:
    return block.narrow(block.dim() - 3 + axis, start, length)


def edge_flags(mesh: Mesh, rank: int, axis: int) -> tuple:
    """(at_global_lo, at_global_hi) of shard ``rank`` along ``axis``: the
    kernels' Dirichlet masking input in the reference (halo.py:21-31). The
    port's sweep needs none: a halo at a global face holds the zeros the
    exchange writes there."""
    c = mesh.coords(rank)[axis]
    return c == 0, c == mesh.shape[axis] - 1


def check_width(n: int, ext: int, axis: int) -> None:
    """A block on a sharded axis must be at least ``ext`` cells wide: its
    faces are its neighbours' halos (reference halo.py:53-57)."""
    if n < ext:
        raise ValueError(
            f"block of {n} cells along axis {axis} is narrower than the "
            f"stencil halo ({ext}); use a coarser mesh or a bigger grid"
        )


def halo_copies(
    blocks: List[torch.Tensor], ext: int, mesh: Mesh, zero_edges: bool = True,
    axes=(0, 1, 2),
) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """The exchange of :func:`exchange_halos` as (halo slab, neighbour face)
    view pairs, a face of None standing for zeros, in the order they run.
    A chunk builds the list once for each of its two buffers and replays it
    every step (:func:`run_copies`): the views stay valid while the blocks
    live, and the host then spends one ``copy_`` a face per step. ``axes``
    picks the axes exchanged; a multi-slice window exchanges y and z only,
    over its blocks' whole deep x extent (the reference's ``_pad_yz``)."""
    copies = []
    for axis in axes:
        for rank, blk in enumerate(blocks):
            n = blk.shape[blk.dim() - 3 + axis] - 2 * ext
            if mesh.shape[axis] > 1:
                check_width(n, ext, axis)
            for step, halo_start in ((-1, 0), (1, n + ext)):
                nb = mesh.neighbour(rank, axis, step)
                dst = _slab(blk, axis, halo_start, ext)
                if nb is None:
                    if zero_edges:
                        copies.append((dst, None))
                    continue
                src_blk = blocks[nb]
                # my low halo is the left neighbour's high face, and so on
                face_start = src_blk.shape[src_blk.dim() - 3 + axis] - 2 * ext if step < 0 else ext
                copies.append((dst, _slab(src_blk, axis, face_start, ext)))
    return copies


def run_copies(copies) -> None:
    for dst, src in copies:
        if src is None:
            dst.zero_()
        else:
            dst.copy_(src, non_blocking=True)


def exchange_halos(
    blocks: List[torch.Tensor], ext: int, mesh: Mesh, zero_edges: bool = True
) -> None:
    """Fill, in place, the halos of the padded ``blocks`` (one per shard, in
    rank order; leading axes such as the (re, im) pair or a stack of
    stored states are carried along) with the neighbours' interior faces.
    ``zero_edges`` also writes the zeros at global faces; a block that a
    sweep just wrote has them already (the sweep writes its whole shell
    zero), so the chunk loop skips them after its first step."""
    run_copies(halo_copies(blocks, ext, mesh, zero_edges))

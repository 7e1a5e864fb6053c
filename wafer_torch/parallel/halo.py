"""Ghost-cell (halo) exchange over a device mesh (counterpart of
``wafer_tpu/parallel/halo.py``).

Each shard stores its block padded, ``(bx+2e, by+2e, bz+2e)`` on the last
three axes, like every other field of the port. Before a sweep the
exchange writes each neighbour's interior faces into the ``ext``-wide halo,
axis by axis as the reference's ``_pad_axis`` does, so edges and corners
compose from the halos already filled. Halos at a global face hold zeros:
the Dirichlet boundary, which the reference gets from ``ppermute`` having
no source there. The faces travel through
:class:`~wafer_torch.parallel.transport.Exchange`: between blocks of one
process a ``copy_`` of a slice, between processes a send and a receive.
"""

from __future__ import annotations

from typing import List

import torch

from wafer_torch.parallel.mesh import Mesh
from wafer_torch.parallel.transport import Exchange


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
) -> Exchange:
    """The exchange of :func:`exchange_halos` as a plan over this process's
    ``blocks`` (in rank order), one stage an axis in the order given: each
    halo slab takes its neighbour's face, or zeros at a global face. A
    chunk builds the plan once for each of its two buffers and replays it
    every step (``Exchange.run``): the views stay valid while the blocks
    live, and the host then spends one ``copy_`` a face per step (a send or
    a receive for a face of another process). ``axes`` picks the axes
    exchanged; a multi-slice window exchanges y and z only, over its blocks'
    whole deep x extent (the reference's ``_pad_yz``)."""
    stages = []
    for axis in axes:
        dim = axis - 3
        n = blocks[0].shape[dim] - 2 * ext
        if mesh.shape[axis] > 1:
            check_width(n, ext, axis)
        transfers = []
        for rank in range(mesh.size):
            for step, halo_start in ((-1, 0), (1, n + ext)):
                nb = mesh.neighbour(rank, axis, step)
                if nb is None:
                    if zero_edges:
                        transfers.append((rank, (dim, halo_start, ext), None, None))
                    continue
                # my low halo is the left neighbour's high face, and so on
                face_start = n if step < 0 else ext
                transfers.append((rank, (dim, halo_start, ext), nb, (dim, face_start, ext)))
        stages.append(transfers)
    return Exchange(mesh, blocks, blocks, stages)


def exchange_halos(
    blocks: List[torch.Tensor], ext: int, mesh: Mesh, zero_edges: bool = True
) -> None:
    """Fill, in place, the halos of this process's padded ``blocks`` (in
    rank order; leading axes such as the (re, im) pair or a stack of
    stored states are carried along) with the neighbours' interior faces.
    ``zero_edges`` also writes the zeros at global faces; a block that a
    sweep just wrote has them already (the sweep writes its whole shell
    zero), so the chunk loop skips them after its first step."""
    halo_copies(blocks, ext, mesh, zero_edges).run()

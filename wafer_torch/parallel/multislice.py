"""The multi-slice (DCN-tier) mesh (counterpart of
``wafer_tpu/parallel/multislice.py``).

The reference factorises its mesh ``(slice, gx, gy, gz)`` with the grid's x
axis sharded over ``slice`` and ``gx`` jointly, so that x hops crossing a
slice ride the slow inter-slice network. It exchanges x faces once per
window of ``slice_update`` steps, with halos ``slice_update·ext`` deep, and
sweeps blindly in between: a block's valid region shrinks by ``ext`` a
step from the deep pad inward, so its interior is exact at the window's
end. The y/z faces are exchanged every step, over the block's whole deep x
extent.

Here the mesh is a :class:`~wafer_torch.parallel.mesh.Mesh` of shape
``(slices·gx, gy, gz)`` in the reference's slice-major order, which records
``slices``. In a run of ``slices`` processes each slice is one process's
(the shards are dealt out process-major), so only the window's x copies
cross processes, once per window. :class:`MultiSliceOps` is :class:`ShardedOps` with that
windowed chunk: each shard keeps a deep block of ``bx + 2·R·ext`` interior
x-planes at origin ``x0 − R·ext``, and one K1 (K3 for pairs) per shard a
step sweeps all of it, writing zero on planes outside the grid and summing
its partials over the true interior only; one K2 adds every shard's rows.
Stored states and a streamed B are padded deep once per chunk, and the
carried correction acts on the pads with the global coefficients, as the
neighbour applies it to the same points. The measure is the flat mesh's:
the reference's ``measure_local`` is the flat measure on the combined x
ring.

One class closes the reference's three multi-slice routes (the XLA
``MultiSliceOps``, the real flat-ring kernel route with its window pinned
to ``slice_update``, and the split flat ring of ``run_sharded_split``):
all three compute the same trajectory, and they differ in TPU residency
and remote DMA, which do not carry over. Only the windows' cadence does:
one x exchange per ``R`` steps in place of one a step.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from wafer_torch.config import Config
from wafer_torch.parallel.halo import halo_copies
from wafer_torch.parallel.mesh import Mesh, take_devices
from wafer_torch.parallel.sharded import Blocks, MeshChunk, ShardedOps
from wafer_torch.parallel.sharded_split import ShardedSplitOps
from wafer_torch.parallel.transport import Exchange


def make_multislice_mesh(shape, slices: int, devices: Optional[Sequence] = None) -> Mesh:
    """The ``slices × (gx, gy, gz)`` mesh as a ``(slices·gx, gy, gz)``
    :class:`Mesh` over the first ``slices·gx·gy·gz`` of ``devices`` (default
    :func:`~wafer_torch.parallel.mesh.take_devices`, an equal share of each
    process's devices), in the reference's process-major order: x ring index
    ``sl·gx + cx``. A device may repeat: ``[cuda:0] * 8`` puts 2 × (2, 2, 1)
    on one card, and in a run of two processes one slice on each process's
    card."""
    shape = tuple(int(m) for m in shape)
    n = slices * int(np.prod(shape))
    devices = take_devices(n, f"multi-slice mesh {slices}x{shape}", devices)
    return Mesh((slices * shape[0], shape[1], shape[2]), devices, slices=slices)


def slice_steps(config: Config, n_ring: int) -> int:
    """Steps of one window between x exchanges: ``slice_update``, no more
    than the block can feed (``bx // ext``: the deep pad is a neighbour's
    interior) or the chunk holds (reference :175-181)."""
    ext = config.central_difference.ext
    bx = config.work_size()[0] // n_ring
    return max(1, min(config.mesh.slice_update, bx // ext, config.output.screen_update))


def check_split_factorisation(mesh: Mesh) -> None:
    """Complex ψ on a multi-slice mesh needs unsharded y/z, as the
    reference's split driver demands (``sharded_split.py:962-967``); the
    windowed pair chunk itself runs on any factorisation."""
    from wafer_torch import errors

    if mesh.slices > 1 and (mesh.shape[1] != 1 or mesh.shape[2] != 1):
        raise errors.ConfigParseError(
            "mesh.slices > 1 on the split-complex path requires an "
            "unsharded y/z factorisation (the flat-ring DCN shortcut); "
            "y/z-sharded slices need the complex-capable real path"
        )


def log_windows(config: Config, mesh: Mesh, log) -> None:
    """Say once per run how the multi-slice mesh exchanges its faces."""
    r = slice_steps(config, mesh.shape[0])
    log.info(
        "Multi-slice mesh %d x %s: x faces exchanged every %d steps with %d-deep halos, "
        "y/z faces every step",
        mesh.slices, (mesh.shape[0] // mesh.slices, *mesh.shape[1:]), r,
        r * config.central_difference.ext,
    )


class MultiSliceOps(ShardedOps):
    """:class:`ShardedOps` on a multi-slice mesh: the same placement,
    measure and interface, with the chunk run in windows of
    :attr:`slice_steps` steps between x exchanges."""

    def __init__(
        self,
        config: Config,
        mesh: Mesh,
        n_lower: int,
        pot_sub_scalar: Optional[float] = None,
        use_pallas: Optional[bool] = None,
        v_shift: float = 0.0,
    ):
        ext = config.central_difference.ext
        dims = config.work_size()
        for d, m, nm in zip(dims, mesh.shape, "xyz"):
            if d % m:
                raise ValueError(f"grid axis {nm}={d} not divisible by its mesh factor {m}")
        bx = dims[0] // mesh.shape[0]
        if bx < ext:
            raise ValueError(
                f"block of {bx} cells along x is narrower than the stencil "
                f"halo ({ext}); use a coarser mesh or a bigger grid"
            )
        super().__init__(config, mesh, n_lower, pot_sub_scalar=pot_sub_scalar,
                         use_pallas=use_pallas, v_shift=v_shift)
        self.bx = bx
        self.slice_steps = slice_steps(config, mesh.shape[0])
        self.depth = self.slice_steps * ext  # h: the deep pad's planes
        if bx < self.depth:
            raise ValueError(
                f"block of {bx} cells along x is narrower than the {self.depth}-deep "
                f"slice-window halo; lower slice_update or use a bigger grid"
            )

    # ------------------------------------------------------------------ #
    # deep blocks
    # ------------------------------------------------------------------ #

    def _x_transfers(self, dst_start, src_face):
        """The x-ring transfers of a window, one stage: each shard's low and
        high deep pad (planes ``dst_start(step)``) takes its x-neighbour's
        ``depth`` planes at ``src_face(step)``."""
        h = self.depth
        return [[
            (r, (-3, dst_start(step), h), nb, (-3, src_face(step), h))
            for r in range(self.mesh.size) for step in (-1, 1)
            if (nb := self.mesh.neighbour(r, 0, step)) is not None
        ]]

    def _deepen(self, blocks: Blocks, halo: int, out: Optional[Blocks] = None) -> Blocks:
        """Each block (x halo ``halo``: ``ext`` for a padded block, 0 for an
        interior one) with ``depth`` more x-planes on each side, holding its
        x-neighbours' interior faces over the whole ring, zeros past a
        global x face (``_pad_x_ring``); leading axes carried. Written into
        ``out`` (deep blocks of that shape) where it is given."""
        h, bx = self.depth, self.bx
        if out is None:
            out = [blk.new_empty(self._deep_shape(blk, halo)) for blk in blocks]
        for deep, blk in zip(out, blocks):
            deep.zero_()
            deep.narrow(-3, halo + h, bx).copy_(blk.narrow(-3, halo, bx))
        Exchange(self.mesh, out, blocks, self._x_transfers(
            lambda step: halo if step < 0 else halo + h + bx,
            lambda step: halo + bx - h if step < 0 else halo,
        )).run()
        return out

    def _deep_shape(self, blk: torch.Tensor, halo: int):
        shape = list(blk.shape)
        shape[-3] = self.bx + 2 * self.depth + 2 * halo
        return shape

    def _x_copies(self, deep: Blocks) -> Exchange:
        """The window's x exchange on deep padded blocks, planned once:
        each deep pad takes its x-neighbour's ``depth`` interior planes next
        to it. A pad past a global face is skipped: its planes lie outside
        the grid, and every sweep writes them zero."""
        h, bx, e = self.depth, self.bx, self.ext
        return Exchange(self.mesh, deep, deep, self._x_transfers(
            lambda step: e if step < 0 else e + h + bx,
            lambda step: e + bx if step < 0 else e + h,
        ))

    def _exchange_yz(self, deep: Blocks, zero_edges: bool):
        return halo_copies(deep, self.ext, self.mesh, zero_edges=zero_edges, axes=(1, 2))

    # ------------------------------------------------------------------ #
    # the chunk
    # ------------------------------------------------------------------ #

    def _make_chunk(self, phi: Blocks, b, store, per_step_norm: bool, done=None):
        return SliceChunk(self, phi, b, store, per_step_norm, done)


class SliceChunk(MeshChunk):
    """The bound chunk of a multi-slice mesh: :class:`MeshChunk` on deep
    blocks, ``x0 − R·ext`` their origin and the true interior the window
    their partials sum. Stored states and a streamed B are padded deep once
    a key (their y/z halos over the deep extent included): they hold for
    the chunk's state. ψ's blocks are padded deep into ``bufs[1]`` each
    chunk. A step exchanges y/z faces, and x faces once a window of
    ``slice_steps`` steps (``period``: a segment keeps the cadence); every
    sweep writes the shell and the planes outside the grid zero, so after
    the set-up the plans copy faces only."""

    def __init__(self, ops: MultiSliceOps, like: Blocks, b, store, per_step_norm: bool, done):
        e, h = ops.ext, ops.depth
        self.period = ops.slice_steps
        b_deep = None if b is None else ops._deepen(b, 0)
        st_deep = None
        if store is not None:
            st_deep = ops._deepen(store, e)
            ops._exchange_yz(st_deep, True).run()
        deep_like = [p.new_empty(ops._deep_shape(p, e)) for p in like]
        origins = [(ops.blocks[r][1][0] - h, *ops.blocks[r][1][1:]) for r in ops.mesh.local]
        super().__init__(ops, deep_like, b_deep, st_deep, per_step_norm, done,
                         origins=origins, window=(h, h + ops.bx))
        self.tensors = tuple(b or ()) + tuple(store or ())

    def _plans(self) -> None:
        ops = self.ops
        self.first = ops._exchange_yz(self.bufs[1], True)
        self.plans = [(ops._x_copies(bufs), ops._exchange_yz(bufs, False)) for bufs in self.bufs]

    def begin(self, phi: Blocks) -> Blocks:
        self._identity()
        self.ops._deepen(phi, self.ops.ext, out=self.bufs[1])
        self.first.run()
        return self.bufs[1]

    def _exchange(self, t: int, src: Blocks) -> None:
        if t > 0:
            x_plan, yz_plan = self.plans[0 if src is self.bufs[0] else 1]
            if t % self.period == 0:
                x_plan.run()
            yz_plan.run()

    def end(self, last: Blocks) -> Blocks:
        h, bx, e = self.ops.depth, self.ops.bx, self.ops.ext
        devices = self.ops.mesh.local_devices
        return [
            self.ops._finish_chunk(
                s.narrow(-3, h, bx + 2 * e), self.coefs[dev],
                None if self.store is None else self.store[i].narrow(-3, h, bx + 2 * e),
                self.per_step_norm,
            ).contiguous()
            for i, (s, dev) in enumerate(zip(last, devices))
        ]


class MultiSliceSplitOps(MultiSliceOps, ShardedSplitOps):
    """:class:`MultiSliceOps` for (re, im) pairs: the windowed chunk with
    K3, the pair's deep pads (a streamed (Br, Bi) too), the conjugated
    overlaps and the split measure of :class:`ShardedSplitOps`."""


def ops_class(mesh: Mesh, split: bool):
    """The sharded ops for a mesh: the multi-slice windows when it carries
    ``slices > 1``, the per-step exchange otherwise."""
    if mesh.slices > 1:
        return MultiSliceSplitOps if split else MultiSliceOps
    return ShardedSplitOps if split else ShardedOps

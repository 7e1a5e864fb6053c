"""The sharded sweep and observables over a device mesh (counterpart of
``wafer_tpu/parallel/sharded.py``).

A field is the list of this process's padded blocks ``(…, bx+2e, by+2e,
bz+2e)`` in rank order (every shard's in a single-process run), whose halos
:func:`~wafer_torch.parallel.halo.exchange_halos` fills with the
neighbours' faces and the global Dirichlet zeros. Coefficient arrays (V,
B, r², potential_sub) are interior blocks.

A chunk step is one exchange and one sweep per shard: K1 (the pair sweep
K3 in :mod:`~wafer_torch.parallel.sharded_split`) with the shard's global
origin, so the analytic B and therefore every point of ψ' are those of the
whole grid, bit for bit. Where the step reduces (per-step norm, stored
states), each shard's block partials land in its own row range of one
buffer on the process's first device (all-gathered from every process in a
multi-process run), and one K2 on every process adds them in rank order
and writes the coefficients the next step applies: every process computes
the single-process coefficients, bit for bit. The measure's sums are
gathered and added in rank order the same way. This one chunk stands for
every sharded TPU scheme of the reference: the resident and ICI modes of
``_evolve_kernel_res`` (B12), the K-fused ground (B5), the y/z-padded
kernels and their R-step windows (B13, B14), which differ only in how often
they exchange and how they keep ψ in VMEM. The reference's layout
permutation and its kernel pickers exist for the TPU's lanes and VMEM and
are not copied: ``perm`` is the identity.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from wafer_torch import chunk_graph, geometry
from wafer_torch.config import Config
from wafer_torch.ops import hopper_stencil as hs
from wafer_torch.ops.observables import observable_sums
from wafer_torch.parallel.halo import check_width, exchange_halos, halo_copies
from wafer_torch.parallel.mesh import AXIS_NAMES, Mesh, build_blocks
from wafer_torch.parallel.transport import Gather, gather_shards

Blocks = List[torch.Tensor]


class ShardedOps:
    """Sweep, measure and placement of real ψ for one (config, mesh,
    n_lower). ``pot_sub_scalar`` is the constant V∞ (a potential_sub array
    is passed to :meth:`measure` instead). ``use_pallas`` (the reference's
    name) selects the kernel
    wrappers, which launch K1/K2 on CUDA blocks and run their plain versions
    on CPU blocks; it defaults to precision f32 and demands it. Without it
    each step runs the plain sweep and sum directly, in the run's precision,
    with B streamed."""

    def __init__(
        self,
        config: Config,
        mesh: Mesh,
        n_lower: int,
        pot_sub_scalar: Optional[float] = None,
        use_pallas: Optional[bool] = None,
        v_shift: float = 0.0,
    ):
        """``stream_dtype``, set here, is the stored states' type in the
        chunks (:meth:`put_store`): bf16 by the reference's rule
        (``hopper_stencil.exc_stream_dtype``) for real f32 ψ on the kernel
        route of a mesh that shards one axis, the run's precision
        otherwise."""
        self.config = config
        self.mesh = mesh
        self.n_lower = n_lower
        self.pot_sub_scalar = pot_sub_scalar
        self.perm = self.inv_perm = (0, 1, 2)
        self.axis_names = AXIS_NAMES
        self.ext = config.central_difference.ext
        self.order = config.central_difference.value
        self.dims = tuple(config.work_size())
        self.blocks = mesh.blocks(self.dims)
        for axis, m in enumerate(mesh.shape):
            if m > 1:
                check_width(self.blocks[0][0][axis], self.ext, axis)
        f32 = config.real_dtype == torch.float32
        if use_pallas is None:
            use_pallas = f32
        elif use_pallas and not f32:
            raise ValueError("the sharded kernel sweep requires precision f32")
        self.use_pallas = use_pallas
        self.stream_dtype = hs.exc_stream_dtype(config, n_lower, use_pallas, mesh.shape)
        self.analytic = hs.analytic_params(config, v_shift) if use_pallas else None
        g = config.grid
        k = geometry.stencil_coefficients(self.order)[3]
        self.scale = g.dt / (k * g.dn * g.dn * config.mass)
        self.n_steps = config.output.screen_update
        self.red_device = mesh.local_devices[0]
        # the reference's windowed drift guard belongs to its y/z-padded
        # windows (B14); one exchange per step needs none
        self.psn_window_steps = 0
        self.evolve_chunk_psn_win = None
        # a solve's ChunkGraphs (chunk_graph.py), set by the solve: the
        # bound chunks kept by key, on one card replayed as graphs
        self.graphs = None

    # ------------------------------------------------------------------ #
    # placement
    # ------------------------------------------------------------------ #

    def put(self, arr, halo: bool = True) -> Blocks:
        """Split a global interior array (leading axes kept) into this
        process's blocks on their devices: padded, with the neighbours'
        faces and the global zeros in the halo (a window of the zero-padded
        array), or with ``halo=False`` the bare interior blocks."""
        arr = torch.as_tensor(arr)
        e = self.ext if halo else 0
        padded = F.pad(arr, (e,) * 6) if e else arr
        out = []
        for r in self.mesh.local:
            (shape, origin), dev = self.blocks[r], self.mesh.devices[r]
            win = padded[(...,) + tuple(slice(o, o + n + 2 * e) for o, n in zip(origin, shape))]
            out.append(torch.empty(win.shape, dtype=win.dtype, device=dev).copy_(win))
        return out

    def put_blocks(self, build_block: Callable, dtype=None) -> Blocks:
        """Interior blocks built per shard by ``build_block(shape, offset)``
        (no global array; see :func:`parallel.mesh.build_blocks`)."""
        return build_blocks(self.mesh, self.dims, build_block, dtype or self.config.real_dtype)

    def get(self, blocks: Blocks) -> torch.Tensor:
        """Gather padded or interior blocks into the global interior array
        on this process's first device (inverse of :meth:`put`); in a
        multi-process run every process receives every block."""
        lead = blocks[0].shape[:-3]
        out = torch.empty(lead + self.dims, dtype=blocks[0].dtype, device=self.red_device)
        inner = [blk if tuple(blk.shape[-3:]) == tuple(self.blocks[r][0])
                 else geometry.work_area(blk, self.ext) for blk, r in zip(blocks, self.mesh.local)]
        ranks = self.mesh.local
        if self.mesh.spans:
            inner = gather_shards(self.mesh, torch.stack([x.to(self.red_device) for x in inner]))
            ranks = range(self.mesh.size)
        for blk, r in zip(inner, ranks):
            shape, origin = self.blocks[r]
            out[(...,) + tuple(slice(o, o + n) for o, n in zip(origin, shape))].copy_(blk)
        return out

    def put_store(self, store) -> Optional[Blocks]:
        """The stored lower states (S, …) as the chunks stream them: padded
        blocks of :attr:`stream_dtype` whose halos hold the neighbours'
        faces (the sweep corrects every tap it reads, halo taps included).
        None for no stored states. The measure takes the f32 blocks of
        :meth:`put`."""
        if store is None or self.n_lower == 0:
            return None
        return [blk.to(self.stream_dtype) for blk in self.put(store)]

    def dummy_pot_sub(self):
        """Placeholder when no potential_sub array takes part."""
        return None

    # ------------------------------------------------------------------ #
    # the chunk
    # ------------------------------------------------------------------ #

    def evolve_chunk(self, phi: Blocks, a, b: Optional[Blocks], store: Optional[Blocks],
                     done: Optional[torch.Tensor] = None) -> Blocks:
        """``screen_update`` steps of ψ's blocks; ``b`` holds the interior B
        blocks where B is streamed (A = 2B − 1 is never read, so ``a`` is
        ignored); ``store`` from :meth:`put_store` or None. The blocks of
        ``phi`` are not modified. ``done``, a batch's flag on the reduction
        device (``hopper_stencil.sweep_step``): while it is set the kernels
        write nothing and the result is undefined (the face copies still
        run). With :attr:`graphs` set (a solve's
        :class:`~wafer_torch.chunk_graph.ChunkGraphs`) and no ``done``, the
        bound chunk is kept by key and, on the graph route, its middle
        steps replayed from a captured segment."""
        return self._chunk(phi, b, store, per_step_norm=False, done=done)

    def evolve_chunk_psn(self, phi: Blocks, a, b: Optional[Blocks], store: Optional[Blocks],
                         done: Optional[torch.Tensor] = None) -> Blocks:
        """:meth:`evolve_chunk` renormalising every step (the f32 drift
        guard, and the delayed-GS chunks with ``store`` None)."""
        return self._chunk(phi, b, store, per_step_norm=True, done=done)

    def _n_red(self, n_store: int) -> int:
        return 1 + n_store

    def _rows(self, block: torch.Tensor) -> int:
        return hs.num_partials(block, self.order) if self.use_pallas else 1

    def _bind(self, like, coef, part, b_blk, store_blk, origin, apply: bool,
              red=None, done=None, stream=None):
        """One shard's sweep at its global ``origin``, bound once:
        ``launch(src, dst)`` for blocks like ``like``; ``red`` is the window
        of interior x-planes its partials sum (all by default); ``done`` a
        batch's flag on the block's device; ``stream`` the launch's stream
        (default: the current one)."""
        kw = dict(order=self.order, scale=self.scale, analytic=self.analytic,
                  b_int=None if self.analytic is not None else b_blk, store=store_blk,
                  apply_coef=apply, origin=origin, grid=self.dims, red=red)
        if self.use_pallas:
            return hs.bind_sweep(like, coef, part, done=done, stream=stream, **kw)
        return lambda src, dst: hs.sweep_step_plain(src, dst, coef, part, **kw)

    def _finisher(self, partials, red, coef, done=None, stream=None):
        """K2 bound to the chunk's buffers, or the plain sum."""
        if self.use_pallas:
            return hs.finish_launcher(partials, red, coef, done=done, stream=stream)
        return lambda: hs.finish_coef_plain(partials, red, coef)

    def _dones(self, done):
        """A batch's flag on each local device (None outside a batch)."""
        devices = set(self.mesh.local_devices)
        if done is None:
            return {dev: None for dev in devices}
        return {dev: done if dev == done.device else done.to(dev) for dev in devices}

    def _finish_chunk(self, src, coef, store_blk, per_step_norm: bool) -> torch.Tensor:
        return hs.finish_chunk(src, coef, store_blk, per_step_norm)

    def _coefs(self, n_red: int, dtype):
        """The chunk's coefficients on the reduction device and a copy on
        each other local device (set to the identity by
        :meth:`MeshChunk.begin`)."""
        coef = torch.empty(n_red, dtype=torch.float32 if self.use_pallas else dtype,
                           device=self.red_device)
        return coef, {dev: coef if dev == self.red_device else torch.empty_like(coef, device=dev)
                      for dev in set(self.mesh.local_devices)}

    def _chunk_key(self, phi: Blocks, b, store, per_step_norm: bool) -> tuple:
        """A bound chunk's key: the ops class and mesh, ψ's blocks, the
        reductions, the stored states' count, type and memory and B's
        source (its memory where streamed)."""
        def blocks(xs):
            return None if xs is None else tuple(x.data_ptr() for x in xs)

        return (type(self).__name__, self.mesh.shape, self.mesh.slices,
                tuple(self.mesh.devices), self.order, self.scale, self.use_pallas,
                tuple((tuple(p.shape), p.dtype) for p in phi), per_step_norm,
                0 if store is None else store[0].shape[0],
                None if store is None else store[0].dtype, blocks(store),
                self.analytic if self.analytic is not None else blocks(b))

    def _make_chunk(self, phi: Blocks, b, store, per_step_norm: bool, done=None) -> "MeshChunk":
        return MeshChunk(self, phi, b, store, per_step_norm, done)

    def _chunk(self, phi: Blocks, b, store, per_step_norm: bool, done=None) -> Blocks:
        def make():
            return self._make_chunk(phi, b, store, per_step_norm, done)

        if self.graphs is None or done is not None:
            return chunk_graph.run(make(), phi, self.n_steps)
        return self.graphs.run(self._chunk_key(phi, b, store, per_step_norm), make, phi,
                               self.n_steps)

    # ------------------------------------------------------------------ #
    # the measure
    # ------------------------------------------------------------------ #

    def _total(self, per_shard):
        """This process's shard values (tuples of 0-d tensors, in rank
        order) added over every shard in rank order on the reduction
        device. In a multi-process run each process gathers every shard's
        values first (exactly, through f64) and adds the same numbers in the
        same order, so every process holds the single-process totals."""
        per_shard = [[v.to(self.red_device) for v in vals] for vals in per_shard]
        if self.mesh.spans:
            dtypes = [v.dtype for v in per_shard[0]]
            mine = torch.stack([torch.stack([v.to(torch.float64) for v in vals])
                                for vals in per_shard])
            per_shard = [[x.to(dt) for x, dt in zip(row, dtypes)]
                         for row in gather_shards(self.mesh, mine)]
        totals = None
        for vals in per_shard:
            totals = vals if totals is None else [t + v for t, v in zip(totals, vals)]
        return totals

    def _interior(self, block: torch.Tensor) -> torch.Tensor:
        return geometry.work_area(block, self.ext)

    def _interior_sum(self, fn) -> torch.Tensor:
        """Σ over the shards, in rank order, of ``fn(i)`` for this
        process's i-th block."""
        return self._total((fn(i),) for i in range(len(self.mesh.local)))[0]

    def _sums(self, phi_blk, v_blk, r2_blk, sub_blk):
        c = self.config
        return observable_sums(
            phi_blk, v_blk, r2_blk, sub_blk, None, self.order, c.grid.dn, c.mass
        )

    def _normalise(self, phi: Blocks, norm2) -> Blocks:
        return [p / torch.sqrt(norm2.to(p.device)).to(p.dtype) for p in phi]

    def _orthogonalise(self, phi: Blocks, store) -> Blocks:
        """Project out each stored state in turn (modified Gram-Schmidt, as
        ``gram_schmidt.orthogonalise_wavefunction``) with overlaps summed
        over the shards' interiors."""
        w = self._interior
        for s in range(0 if store is None else store[0].shape[0]):
            ov = self._interior_sum(lambda r: torch.sum(w(store[r][s]) * w(phi[r])))
            phi = [p - store[r][s] * ov.to(p.device) for r, p in enumerate(phi)]
        return phi

    def measure(self, phi: Blocks, v: Blocks, r2: Blocks, sub, store):
        """(energy, norm², V∞, ⟨r²⟩) as 0-d tensors on the reduction device, and
        ψ normalised and orthogonalised to ``store``. Each shard's sums are
        the single-device observables over its block (``hybrid_sum``), added
        in rank order (the reference's per-shard sums + psum,
        sharded.py:1148-1167). Refreshes ψ's halos in place first: the
        kinetic term reads the neighbours' faces."""
        exchange_halos(phi, self.ext, self.mesh)
        sums = self._total(
            self._sums(phi[i], v[i], r2[i], None if sub is None else sub[i])
            for i in range(len(phi))
        )
        norm2 = sums[-3]
        if sub is None and self.pot_sub_scalar is not None:
            sums[-2] = norm2 * self.pot_sub_scalar
        phi = self._orthogonalise(self._normalise(phi, norm2), store)
        return tuple(sums), phi

    def max_rel_overlap(self, phi: Blocks, store: Blocks) -> torch.Tensor:
        """maxₛ |⟨lₛ|ψ⟩| / (‖lₛ‖·‖ψ‖) over the shards' interiors: the delayed
        re-orthogonalisation gate's measured admixture (the sharded form of
        ``solver._max_rel_overlap``)."""
        w = self._interior
        pn = torch.sqrt(self._interior_sum(lambda r: torch.sum(w(phi[r]) ** 2)))
        out = []
        for s in range(store[0].shape[0]):
            ln = torch.sqrt(self._interior_sum(lambda r: torch.sum(w(store[r][s]) ** 2)))
            out.append(self._overlap_abs(phi, store, s) / (ln * pn))
        return torch.max(torch.stack(out))

    def _overlap_abs(self, phi, store, s) -> torch.Tensor:
        w = self._interior
        return torch.abs(self._interior_sum(lambda r: torch.sum(w(store[r][s]) * w(phi[r]))))


class MeshChunk:
    """The bound chunk of a mesh (``chunk_graph``'s notes): ψ's two sets of
    padded blocks, the coefficients on every local device, each shard's
    partial rows, the buffer K2 adds in rank order (all-gathered over the
    processes), the halo plans of each set, and each shard's sweep and K2
    bound to them. Step 0 reads the copy of ψ's blocks in ``bufs[1]``
    (their halos exchanged with the global zeros); the sweep writes every
    shell zero, so later steps copy faces only, from the plan of the set
    they read."""

    period = 1

    def __init__(self, ops: ShardedOps, like: Blocks, b, store, per_step_norm: bool, done,
                 origins=None, window=None):
        mesh = ops.mesh
        self.ops, self.b, self.store = ops, b, store
        self.per_step_norm = per_step_norm
        self.dones = ops._dones(done)
        self.done = self.dones[ops.red_device]
        n_store = 0 if store is None else store[0].shape[0]
        self.reduce = per_step_norm or n_store > 0
        self.coef, self.coefs = ops._coefs(ops._n_red(n_store), like[0].dtype)
        self.bufs = ([torch.empty_like(p) for p in like], [torch.empty_like(p) for p in like])
        self.origins = origins or [ops.blocks[r][1] for r in mesh.local]
        self.window = window
        self.own = [None] * len(like)
        if self.reduce:
            self._reduction(like)
        self.device, self.counts = ops.red_device, hs.LAUNCHES
        self.tensors = tuple(b or ()) + tuple(store or ())
        self._plans()
        self.eager = self.launchers()

    def _plans(self) -> None:
        ops = self.ops
        self.first = halo_copies(self.bufs[1], ops.ext, ops.mesh)
        self.plans = [halo_copies(bufs, ops.ext, ops.mesh, zero_edges=False)
                      for bufs in self.bufs]

    def _reduction(self, like: Blocks) -> None:
        """Each local shard's partial rows (on its device, as its sweep
        writes them) and the buffer of every shard's rows in rank order."""
        ops, mesh = self.ops, self.ops.mesh
        red_dev = ops.red_device
        count = ops._rows(like[0])  # every shard's block has one shape
        n_red = self.coef.shape[0]
        self.partials = torch.empty(mesh.size * count, n_red, dtype=torch.float64,
                                    device=red_dev)
        mine = self.partials
        self.gather = None
        if mesh.spans:
            mine = torch.empty(len(like) * count, n_red, dtype=torch.float64, device=red_dev)
            self.gather = Gather(mine, self.partials)
        self.rows = [mine[i * count:(i + 1) * count] for i in range(len(like))]
        self.own = [rws if dev == red_dev else torch.empty(rws.shape, dtype=rws.dtype,
                                                           device=dev)
                    for rws, dev in zip(self.rows, mesh.local_devices)]
        self.red = torch.empty(n_red, dtype=torch.float64, device=red_dev)

    def launchers(self, stream=None):
        """(each shard's sweep, K2 or None) bound to this chunk's tensors,
        launching on ``stream`` (default: the current stream)."""
        ops, devices = self.ops, self.ops.mesh.local_devices
        sweeps = [
            ops._bind(blk, self.coefs[dev], own, None if self.b is None else self.b[i],
                      None if self.store is None else self.store[i], origin, self.reduce,
                      red=self.window, done=self.dones[dev], stream=stream)
            for i, (blk, dev, own, origin) in enumerate(
                zip(self.bufs[0], devices, self.own, self.origins))
        ]
        finish = None
        if self.reduce:
            finish = ops._finisher(self.partials, self.red, self.coef, self.done, stream)
        return sweeps, finish

    def _identity(self) -> None:
        """The identity coefficients on every local device: the first step
        sweeps ψ as it is."""
        self.coef.zero_()
        self.coef[:1].fill_(1.0)
        for c in self.coefs.values():
            if c is not self.coef:
                c.copy_(self.coef)

    def begin(self, phi: Blocks) -> Blocks:
        self._identity()
        for dst, p in zip(self.bufs[1], phi):
            dst.copy_(p)
        self.first.run()
        return self.bufs[1]

    def _exchange(self, t: int, src: Blocks) -> None:
        if t > 0:
            self.plans[0 if src is self.bufs[0] else 1].run()

    def step(self, launch, t: int, src: Blocks, dst: Blocks) -> None:
        self._exchange(t, src)
        sweeps, finish = launch
        for sweep, s, d in zip(sweeps, src, dst):
            sweep(s, d)
        if finish is not None:
            for sweep_rows, dest in zip(self.own, self.rows):
                if sweep_rows is not dest:
                    dest.copy_(sweep_rows, non_blocking=True)
            if self.gather is not None:
                self.gather.run()
            finish()
            for c in self.coefs.values():
                if c is not self.coef:
                    c.copy_(self.coef, non_blocking=True)

    def fresh(self) -> Blocks:
        return [torch.empty_like(p) for p in self.bufs[0]]

    def end(self, last: Blocks) -> Blocks:
        devices = self.ops.mesh.local_devices
        return [self.ops._finish_chunk(s, self.coefs[dev],
                                       None if self.store is None else self.store[i],
                                       self.per_step_norm)
                for i, (s, dev) in enumerate(zip(last, devices))]

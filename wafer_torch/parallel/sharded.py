"""The sharded sweep and observables over a single-process device mesh
(counterpart of ``wafer_tpu/parallel/sharded.py``).

A field is a list of per-shard padded blocks ``(…, bx+2e, by+2e, bz+2e)``
in rank order, whose halos :func:`~wafer_torch.parallel.halo.exchange_halos`
fills with the neighbours' faces and the global Dirichlet zeros.
Coefficient arrays (V, B, r², potential_sub) are interior blocks.

A chunk step is one exchange and one sweep per shard: K1 (the pair sweep
K3 in :mod:`~wafer_torch.parallel.sharded_split`) with the shard's global
origin, so the analytic B and therefore every point of ψ' are those of the
whole grid, bit for bit. Where the step reduces (per-step norm, stored
states), each shard's block partials land in its own row range of one
buffer on shard 0's device, and one K2 adds them in rank order and writes
the coefficients the next step applies. This one chunk stands for every
sharded TPU scheme of the reference: the resident and ICI modes of
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

from wafer_torch import geometry
from wafer_torch.config import Config
from wafer_torch.ops import hopper_stencil as hs
from wafer_torch.ops.observables import observable_sums
from wafer_torch.parallel.halo import check_width, exchange_halos, halo_copies, run_copies
from wafer_torch.parallel.mesh import AXIS_NAMES, Mesh, build_blocks

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
        self.analytic = hs.analytic_params(config, v_shift) if use_pallas else None
        g = config.grid
        k = geometry.stencil_coefficients(self.order)[3]
        self.scale = g.dt / (k * g.dn * g.dn * config.mass)
        self.n_steps = config.output.screen_update
        self.red_device = mesh.devices[0]
        # the reference's windowed drift guard belongs to its y/z-padded
        # windows (B14); one exchange per step needs none
        self.psn_window_steps = 0
        self.evolve_chunk_psn_win = None

    # ------------------------------------------------------------------ #
    # placement
    # ------------------------------------------------------------------ #

    def put(self, arr, halo: bool = True) -> Blocks:
        """Split a global interior array (leading axes kept) into the
        shards' blocks on their devices: padded, with the neighbours' faces
        and the global zeros in the halo (a window of the zero-padded
        array), or with ``halo=False`` the bare interior blocks."""
        arr = torch.as_tensor(arr)
        e = self.ext if halo else 0
        padded = F.pad(arr, (e,) * 6) if e else arr
        out = []
        for (shape, origin), dev in zip(self.blocks, self.mesh.devices):
            win = padded[(...,) + tuple(slice(o, o + n + 2 * e) for o, n in zip(origin, shape))]
            out.append(torch.empty(win.shape, dtype=win.dtype, device=dev).copy_(win))
        return out

    def put_blocks(self, build_block: Callable, dtype=None) -> Blocks:
        """Interior blocks built per shard by ``build_block(shape, offset)``
        (no global array; see :func:`parallel.mesh.build_blocks`)."""
        return build_blocks(self.mesh, self.dims, build_block, dtype or self.config.real_dtype)

    def get(self, blocks: Blocks) -> torch.Tensor:
        """Gather padded or interior blocks into the global interior array
        on shard 0's device (inverse of :meth:`put`)."""
        lead = blocks[0].shape[:-3]
        out = torch.empty(lead + self.dims, dtype=blocks[0].dtype, device=self.red_device)
        for blk, (shape, origin) in zip(blocks, self.blocks):
            if tuple(blk.shape[-3:]) != tuple(shape):
                blk = geometry.work_area(blk, self.ext)
            out[(...,) + tuple(slice(o, o + n) for o, n in zip(origin, shape))].copy_(blk)
        return out

    def put_store(self, store) -> Optional[Blocks]:
        """The stored lower states (S, …) as padded blocks whose halos hold
        the neighbours' faces: the sweep corrects every tap it reads, halo
        taps included. None for no stored states."""
        if store is None or self.n_lower == 0:
            return None
        return self.put(store)

    def dummy_pot_sub(self):
        """Placeholder when no potential_sub array takes part."""
        return None

    # ------------------------------------------------------------------ #
    # the chunk
    # ------------------------------------------------------------------ #

    def evolve_chunk(self, phi: Blocks, a, b: Optional[Blocks], store: Optional[Blocks]) -> Blocks:
        """``screen_update`` steps of ψ's blocks; ``b`` holds the interior B
        blocks where B is streamed (A = 2B − 1 is never read, so ``a`` is
        ignored); ``store`` from :meth:`put_store` or None. The blocks of
        ``phi`` are not modified."""
        return self._chunk(phi, b, store, per_step_norm=False)

    def evolve_chunk_psn(self, phi: Blocks, a, b: Optional[Blocks], store: Optional[Blocks]) -> Blocks:
        """:meth:`evolve_chunk` renormalising every step (the f32 drift
        guard, and the delayed-GS chunks with ``store`` None)."""
        return self._chunk(phi, b, store, per_step_norm=True)

    def _n_red(self, n_store: int) -> int:
        return 1 + n_store

    def _rows(self, block: torch.Tensor) -> int:
        return hs.num_partials(block, self.order) if self.use_pallas else 1

    def _sweep(self, src, dst, coef, part, b_blk, store_blk, origin, apply: bool) -> None:
        sweep = hs.sweep_step if self.use_pallas else hs.sweep_step_plain
        sweep(
            src, dst, coef, part, order=self.order, scale=self.scale, analytic=self.analytic,
            b_int=None if self.analytic is not None else b_blk, store=store_blk,
            apply_coef=apply, origin=origin,
        )

    def _finisher(self, partials, red, coef):
        """K2 bound to the chunk's buffers (once per chunk), or the plain sum."""
        if self.use_pallas:
            return hs.finish_launcher(partials, red, coef)
        return lambda: hs.finish_coef_plain(partials, red, coef)

    def _finish_chunk(self, src, coef, store_blk, per_step_norm: bool) -> torch.Tensor:
        return hs.finish_chunk(src, coef, store_blk, per_step_norm)

    def _chunk(self, phi: Blocks, b, store, per_step_norm: bool) -> Blocks:
        mesh, red_dev = self.mesh, self.red_device
        n_store = 0 if store is None else store[0].shape[0]
        reduce = per_step_norm or n_store > 0
        n_red = self._n_red(n_store)
        coef = torch.zeros(
            n_red, dtype=torch.float32 if self.use_pallas else phi[0].dtype, device=red_dev
        )
        coef[0] = 1.0  # the identity: the first step sweeps ψ as it is
        coefs = {dev: coef if dev == red_dev else coef.to(dev) for dev in set(mesh.devices)}
        partials = rows = own = finish = None
        if reduce:
            counts = [self._rows(p) for p in phi]
            partials = torch.empty(sum(counts), n_red, dtype=torch.float64, device=red_dev)
            red = torch.empty(n_red, dtype=torch.float64, device=red_dev)
            starts = [sum(counts[:r]) for r in range(len(counts))]
            rows = [partials[s:s + c] for s, c in zip(starts, counts)]
            own = [
                rws if dev == red_dev else torch.empty(rws.shape, dtype=rws.dtype, device=dev)
                for rws, dev in zip(rows, mesh.devices)
            ]
            finish = self._finisher(partials, red, coef)
        src = [p.clone() for p in phi]
        nxt = [torch.empty_like(p) for p in phi]
        exchange_halos(src, self.ext, mesh)
        # the sweep writes every shell zero, so later steps copy faces only,
        # from a plan made once for each of the two buffers
        plans = {id(bufs): halo_copies(bufs, self.ext, mesh, zero_edges=False)
                 for bufs in (src, nxt)}
        for t in range(self.n_steps):
            if t > 0:
                run_copies(plans[id(src)])
            for r, (_shape, origin) in enumerate(self.blocks):
                self._sweep(
                    src[r], nxt[r], coefs[mesh.devices[r]], None if own is None else own[r],
                    None if b is None else b[r], None if store is None else store[r],
                    origin, reduce,
                )
            if reduce:
                for mine, dest in zip(own, rows):
                    if mine is not dest:
                        dest.copy_(mine, non_blocking=True)
                finish()
                for c in coefs.values():
                    if c is not coef:
                        c.copy_(coef, non_blocking=True)
            src, nxt = nxt, src
        return [
            self._finish_chunk(s, coefs[dev], None if store is None else store[r], per_step_norm)
            for r, (s, dev) in enumerate(zip(src, mesh.devices))
        ]

    # ------------------------------------------------------------------ #
    # the measure
    # ------------------------------------------------------------------ #

    def _total(self, per_shard):
        """Shard values (tuples of tensors) added in rank order on shard 0's
        device."""
        totals = None
        for vals in per_shard:
            vals = [v.to(self.red_device) for v in vals]
            totals = vals if totals is None else [t + v for t, v in zip(totals, vals)]
        return totals

    def _interior(self, block: torch.Tensor) -> torch.Tensor:
        return geometry.work_area(block, self.ext)

    def _interior_sum(self, fn) -> torch.Tensor:
        """Σ over the shards, in rank order, of ``fn(rank)``."""
        return self._total((fn(r),) for r in range(self.mesh.size))[0]

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
        """(energy, norm², V∞, ⟨r²⟩) as 0-d tensors on shard 0's device, and
        ψ normalised and orthogonalised to ``store``. Each shard's sums are
        the single-device observables over its block (``hybrid_sum``), added
        in rank order (the reference's per-shard sums + psum,
        sharded.py:1148-1167). Refreshes ψ's halos in place first: the
        kinetic term reads the neighbours' faces."""
        exchange_halos(phi, self.ext, self.mesh)
        sums = self._total(
            self._sums(phi[r], v[r], r2[r], None if sub is None else sub[r])
            for r in range(self.mesh.size)
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

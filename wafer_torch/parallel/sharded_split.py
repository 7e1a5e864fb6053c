"""The sharded sweep and observables for complex ψ as (re, im) pairs
(counterpart of ``wafer_tpu/parallel/sharded_split.py``).

The port carries complex ψ as a pair on every device, so the sharded pair
path is :class:`~wafer_torch.parallel.sharded.ShardedOps` with the pair
sweep K3 (shard origin, complex B), K2 at ``n_red = 1 + 2S``, conjugated
overlaps and the split measure. It closes the sharded modes of the TPU pair
kernels (B8/B9 with ``x_origin``, B12) and the multi-axis
``_evolve_kernel_sc_yzp`` (B15). Blocks are ``(2, …)``, stored pairs
``(S, 2, …)``, a streamed B the interior pair (Br, Bi).
"""

from __future__ import annotations

import torch

from wafer_torch.ops import hopper_split as hsp, split_complex
from wafer_torch.parallel.sharded import Blocks, ShardedOps


class ShardedSplitOps(ShardedOps):
    """:class:`ShardedOps` for (re, im) pairs."""

    def _n_red(self, n_store: int) -> int:
        return 1 + 2 * n_store

    def _rows(self, block: torch.Tensor) -> int:
        return hsp.num_partials(block, self.order) if self.use_pallas else 1

    def _bind(self, like, coef, part, b_blk, store_blk, origin, apply: bool,
              red=None, done=None, stream=None):
        kw = dict(order=self.order, scale=self.scale, analytic=self.analytic,
                  b2=None if self.analytic is not None else b_blk, store=store_blk,
                  apply_coef=apply, origin=origin, grid=self.dims, red=red)
        if self.use_pallas:
            return hsp.bind_sweep_sc(like, coef, part, done=done, stream=stream, **kw)
        return lambda src, dst: hsp.sweep_step_sc_plain(src, dst, coef, part, **kw)

    def _finish_chunk(self, src, coef, store_blk, per_step_norm: bool) -> torch.Tensor:
        return hsp.finish_chunk_sc(src, coef, store_blk, per_step_norm)

    def _sums(self, phi_blk, v_blk, r2_blk, sub_blk):
        c = self.config
        return split_complex.observable_sums_sc(
            phi_blk[0], phi_blk[1], v_blk[0], v_blk[1], r2_blk, sub_blk, None,
            self.order, c.grid.dn, c.mass,
        )

    def _normalise(self, phi: Blocks, norm2) -> Blocks:
        return [p * (1.0 / torch.sqrt(norm2.to(p.device))).to(p.dtype) for p in phi]

    def _conj_overlap(self, phi: Blocks, store: Blocks, s: int):
        """⟨lₛ|ψ⟩ = Σ conj(lₛ)·ψ over the shards' interiors, as (re, im)."""
        w = self._interior
        o_re, o_im = self._total(
            split_complex._overlap(*w(store[i][s]), *w(phi[i])) for i in range(len(phi))
        )
        return o_re, o_im

    def _orthogonalise(self, phi: Blocks, store) -> Blocks:
        for s in range(0 if store is None else store[0].shape[0]):
            o_re, o_im = self._conj_overlap(phi, store, s)
            phi = [
                torch.stack(split_complex._project(
                    p[0], p[1], store[r][s][0], store[r][s][1],
                    o_re.to(p.device), o_im.to(p.device),
                ))
                for r, p in enumerate(phi)
            ]
        return phi

    def _overlap_abs(self, phi, store, s) -> torch.Tensor:
        return torch.hypot(*self._conj_overlap(phi, store, s))

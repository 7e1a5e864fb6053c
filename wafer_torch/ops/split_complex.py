"""Complex ψ as (re, im) real pairs, in plain torch ops (counterpart of
``wafer_tpu/ops/split_complex.py``; the reference's complex potentials
are real stubs, src/potential.rs:222,271).

The port carries complex ψ as a pair on every device and at both
precisions, so this module is the f64 path, the CPU path and the oracle
of the CUDA pair sweep (``ops/hopper_split``). The complex algebra is
written out over real arrays (V, A, B complex; the stencil taps act
componentwise):

    re' = aᵣψᵣ − aᵢψᵢ + s(bᵣtᵣ − bᵢtᵢ)
    im' = aᵣψᵢ + aᵢψᵣ + s(bᵣtᵢ + bᵢtᵣ)

    norm² = Σ ψᵣ² + ψᵢ²
    ⟨l|ψ⟩ = Σ (lᵣψᵣ + lᵢψᵢ) + i·Σ (lᵣψᵢ − lᵢψᵣ)
    energy = Σ V|ψ|² − ψ*·taps(ψ)/denom   (complex)
"""

from __future__ import annotations

from typing import Optional

import torch

from wafer_torch import geometry
from wafer_torch.ops.observables import hybrid_sum
from wafer_torch.ops.stencil import stencil_taps


def _norm2(pr, pi):
    return torch.sum(pr * pr + pi * pi)


def _overlap(lr, li, pr, pi):
    """⟨l|ψ⟩ = Σ conj(l)·ψ, split into (re, im)."""
    return torch.sum(lr * pr + li * pi), torch.sum(lr * pi - li * pr)


def _project(pr, pi, lr, li, o_re, o_im):
    """ψ ← ψ − l·⟨l|ψ⟩."""
    return pr - (lr * o_re - li * o_im), pi - (lr * o_im + li * o_re)


def evolve_step_sc(pr, pi, ar, ai, br, bi, order, dt, dn, mass):
    """One split-complex sweep (update rule of src/grid.rs:544-687)."""
    _o, _c, _cc, k = geometry.stencil_coefficients(order)
    ext = geometry.EXT[order]
    s = dt / (k * dn * dn * mass)
    tr = stencil_taps(pr, order)
    ti = stencil_taps(pi, order)
    wr, wi = geometry.work_area(pr, ext), geometry.work_area(pi, ext)
    arw, aiw = geometry.work_area(ar, ext), geometry.work_area(ai, ext)
    brw, biw = geometry.work_area(br, ext), geometry.work_area(bi, ext)
    new_r = arw * wr - aiw * wi + s * (brw * tr - biw * ti)
    new_i = arw * wi + aiw * wr + s * (brw * ti + biw * tr)
    return geometry.set_work_area(pr, ext, new_r), geometry.set_work_area(pi, ext, new_i)


def evolve_chunk_sc(
    pr, pi, ar, ai, br, bi,
    store_r: Optional[torch.Tensor], store_i: Optional[torch.Tensor],
    order: str, dt: float, dn: float, mass: float, n_steps: int, n_lower: int,
    per_step_norm: bool = False,
):
    """``n_steps`` split-complex sweeps with per-step normalise, then
    Gram-Schmidt against each stored pair in turn, for excited states
    (src/grid.rs:674-681). ``per_step_norm`` extends the renormalisation to
    the ground state (the f32 scale-drift guard)."""
    for _ in range(n_steps):
        pr, pi = evolve_step_sc(pr, pi, ar, ai, br, bi, order, dt, dn, mass)
        if n_lower > 0 or per_step_norm:
            inv = (1.0 / torch.sqrt(_norm2(pr, pi))).to(pr.dtype)
            pr, pi = pr * inv, pi * inv
        for s in range(n_lower):
            o_re, o_im = _overlap(store_r[s], store_i[s], pr, pi)
            pr, pi = _project(pr, pi, store_r[s], store_i[s], o_re, o_im)
    return pr, pi


def measure_and_prepare_sc(
    pr, pi, vr, vi, r2_grid, pot_sub_array, pot_sub_scalar, store_r, store_i,
    order: str, dn: float, mass: float, n_lower: int,
):
    """Observables of the current pair, then normalise, then orthogonalise.
    Returns ``(e_re, e_im, norm2, v_inf, r2), (pr, pi)``.

    The five sums go through :func:`hybrid_sum` (f32 rows, f64 total):
    plain f32 sums over ≥16M cells lose the 1e-6 ΔE signal whenever
    |E| ≳ 2 (wafer_tpu/ops/split_complex.py:125-130)."""
    ext = geometry.EXT[order]
    _o, _c, _cc, k = geometry.stencil_coefficients(order)
    denom = k * dn * dn * mass

    wr, wi = geometry.work_area(pr, ext), geometry.work_area(pi, ext)
    vrw, viw = geometry.work_area(vr, ext), geometry.work_area(vi, ext)
    abs2 = wr * wr + wi * wi
    tr = stencil_taps(pr, order)
    ti = stencil_taps(pi, order)

    # ψ*·taps = (wr − i·wi)(tr + i·ti)
    e_re = hybrid_sum(vrw * abs2 - (wr * tr + wi * ti) / denom)
    e_im = hybrid_sum(viw * abs2 - (wr * ti - wi * tr) / denom)
    norm2 = hybrid_sum(abs2)
    if pot_sub_array is not None:
        v_inf = hybrid_sum(abs2 * pot_sub_array)
    elif pot_sub_scalar is not None:
        v_inf = norm2 * pot_sub_scalar
    else:
        v_inf = torch.zeros((), dtype=norm2.dtype, device=norm2.device)
    r2 = hybrid_sum(abs2 * r2_grid)

    inv = (1.0 / torch.sqrt(norm2)).to(pr.dtype)
    pr, pi = pr * inv, pi * inv
    for s in range(n_lower):
        o_re, o_im = _overlap(store_r[s], store_i[s], pr, pi)
        pr, pi = _project(pr, pi, store_r[s], store_i[s], o_re, o_im)
    return (e_re, e_im, norm2, v_inf, r2), (pr, pi)

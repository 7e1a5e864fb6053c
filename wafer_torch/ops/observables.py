"""Observable reductions: energy, norm², V∞, ⟨r²⟩ (counterpart of
``wafer_tpu/ops/observables.py``; reference: src/grid.rs:303-445).

Definitions (work area only; halo excluded):

    energy = Σ ( V·|ψ|² − ψ*·(Σ cᵢψᵢ − c₀ψ)/(k·dn²·m) )
    norm²  = Σ |ψ|²
    V∞     = Σ |ψ|²·potsub      (array, scalar, or absent → 0)
    ⟨r²⟩   = Σ |ψ|²·r²(idx)     (index units, work-area indices)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from wafer_torch import geometry
from wafer_torch.ops.stencil import stencil_taps


@dataclass
class Observables:
    """Raw (un-normalised) observables (reference: src/grid.rs:15-28)."""

    energy: complex
    norm2: float
    v_infinity: float
    r2: float


def hybrid_sum(x: torch.Tensor) -> torch.Tensor:
    """Full-array sum that keeps single-precision row sums (the last axis,
    ≤ nz summands) and combines them in f64 — the reference's
    ``hybrid_sum`` (wafer_tpu/ops/observables.py:50-75), which the
    reference CLI always runs because it turns x64 on. Plain f32 sums over
    ≥16M cells lose the 1e-6 relative-energy signal the convergence test
    needs. f64 inputs pass through."""
    if x.dtype in (torch.float32, torch.complex64):
        wide = torch.complex128 if x.is_complex() else torch.float64
        return torch.sum(torch.sum(x, dim=-1).to(wide))
    return torch.sum(x)


def compute_observables_device(
    phi: torch.Tensor,
    v: torch.Tensor,
    r2_grid: torch.Tensor,
    pot_sub_array: Optional[torch.Tensor],
    pot_sub_scalar: Optional[float],
    order: str,
    dn: float,
    mass: float,
):
    """Returns the (energy, norm2, v_infinity, r2) 0-d tensors, on ψ's
    device: the host reads them only where it needs them."""
    ext = geometry.EXT[order]
    _o, _c, _cc, k = geometry.stencil_coefficients(order)
    denominator = k * dn * dn * mass  # src/grid.rs:314,337,367

    w = geometry.work_area(phi, ext)
    v_w = geometry.work_area(v, ext)
    wc = w.conj() if w.is_complex() else w
    abs2 = (wc * w).real if w.is_complex() else wc * w

    taps = stencil_taps(phi, order)
    energy = hybrid_sum(v_w * wc * w - wc * taps / denominator)
    norm2 = hybrid_sum(abs2)
    if pot_sub_array is not None:
        v_inf = hybrid_sum(abs2 * pot_sub_array)
    elif pot_sub_scalar is not None:
        v_inf = norm2 * pot_sub_scalar
    else:
        v_inf = torch.zeros((), dtype=norm2.dtype, device=norm2.device)
    r2 = hybrid_sum(abs2 * r2_grid)
    return energy, norm2, v_inf, r2

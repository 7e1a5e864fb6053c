"""Central-difference sweep as plain torch ops (counterpart of
``wafer_tpu/ops/stencil.py``; reference: src/grid.rs:544-687).

This is the port's f64 path (the reference runs f64 on its XLA sweep,
never on a kernel) and the CPU oracle the CUDA sweep is held against.

Update rule (src/grid.rs:567-664):

    ψ' = A∘ψ + B·dt·(Σᵢ cᵢ·ψ(±i shifts over 3 axes) − c₀·ψ) / (k·dn²·mass)
"""

from __future__ import annotations

from typing import Optional

import torch

from wafer_torch import geometry
from wafer_torch.ops.gram_schmidt import get_norm_squared, orthogonalise_wavefunction


def shifted(phi: torch.Tensor, ext: int, axis: int, off: int) -> torch.Tensor:
    """Work-area-shaped view of the padded array shifted by ``off``
    along ``axis``."""
    idx = []
    for a in range(3):
        o = off if a == axis else 0
        idx.append(slice(ext + o, phi.shape[a] - ext + o))
    return phi[tuple(idx)]


def stencil_taps(phi: torch.Tensor, order: str) -> torch.Tensor:
    """Laplacian numerator ``Σ cᵢ·ψ(neighbours) − c₀·ψ`` on the work area
    (the caller applies the ``k·dn²·mass`` denominator)."""
    offsets, coeffs, center, _k = geometry.stencil_coefficients(order)
    ext = geometry.EXT[order]
    acc = -center * shifted(phi, ext, 0, 0)
    for axis in range(3):
        for off, c in zip(offsets, coeffs):
            acc = acc + c * shifted(phi, ext, axis, +off)
            acc = acc + c * shifted(phi, ext, axis, -off)
    return acc


def evolve_step(
    phi: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    order: str,
    dt: float,
    dn: float,
    mass: float,
) -> torch.Tensor:
    """One explicit-Euler imaginary-time step (src/grid.rs:562-673)."""
    _o, _c, _cc, k = geometry.stencil_coefficients(order)
    ext = geometry.EXT[order]
    denominator = k * dn * dn * mass
    w = geometry.work_area(phi, ext)
    a_w = geometry.work_area(a, ext)
    b_w = geometry.work_area(b, ext)
    new_work = w * a_w + b_w * (dt / denominator) * stencil_taps(phi, order)
    return geometry.set_work_area(phi, ext, new_work)


def evolve_chunk(
    phi: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    w_store: Optional[torch.Tensor],
    order: str,
    dt: float,
    dn: float,
    mass: float,
    n_steps: int,
    n_lower: int,
    per_step_norm: bool = False,
) -> torch.Tensor:
    """``n_steps`` inner steps between screen updates (reference
    ``evolve``, src/grid.rs:544-687). Excited states (``n_lower > 0``)
    renormalise and project against the stored states after every step
    (src/grid.rs:674-681); ``per_step_norm`` renormalises the ground state
    too, the f32 scale-drift guard (renormalisation only rescales)."""
    for _ in range(n_steps):
        phi = evolve_step(phi, a, b, order, dt, dn, mass)
        if n_lower > 0 or per_step_norm:
            phi = phi / torch.sqrt(get_norm_squared(phi)).to(phi.dtype)
        if n_lower > 0:
            phi = orthogonalise_wavefunction(phi, w_store, n_lower)
    return phi

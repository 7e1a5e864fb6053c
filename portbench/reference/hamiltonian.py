"""H = −∇²/(2m) + V on the grid, and what the check reads off a state.

Plain PyTorch, f64 (complex128 for an absorptive potential). The
Laplacian is the ThreePoint central difference with a zero (Dirichlet)
shell around the interior (src/grid.rs:544-687); the observables are the
reference's sums (src/grid.rs:303-445): E = ⟨ψ|H|ψ⟩, norm² = ⟨ψ|ψ⟩,
V∞ = Σ|ψ|²·V(∞), ⟨r²⟩ = Σ|ψ|²·r², here each divided by norm².
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def laplacian(psi: torch.Tensor, dn: float) -> torch.Tensor:
    """ThreePoint ∇²ψ of an interior field with zeros outside it."""
    p = F.pad(psi[None, None], (1, 1, 1, 1, 1, 1))[0, 0]
    lap = (p[2:, 1:-1, 1:-1] + p[:-2, 1:-1, 1:-1]
           + p[1:-1, 2:, 1:-1] + p[1:-1, :-2, 1:-1]
           + p[1:-1, 1:-1, 2:] + p[1:-1, 1:-1, :-2]
           - 6.0 * psi)
    return lap / (dn * dn)


def apply_h(psi: torch.Tensor, v: torch.Tensor, dn: float, mass: float) -> torch.Tensor:
    return -laplacian(psi, dn) / (2.0 * mass) + v * psi


def inner(a: torch.Tensor, b: torch.Tensor):
    """⟨a|b⟩ = Σ conj(a)·b, a Python number."""
    return torch.sum(a.conj() * b).item() if a.is_complex() else torch.sum(a * b).item()


def judge_state(psi, v, pot_sub, r2, dn: float, mass: float) -> dict:
    """The state's Rayleigh quotient ``energy``, its eigen-residual
    ``residual`` = ‖(H − E)ψ‖/‖ψ‖ and its normalised ``v_inf`` and ``r2``."""
    hpsi = apply_h(psi, v, dn, mass)
    norm2 = inner(psi, psi).real if psi.is_complex() else inner(psi, psi)
    energy = inner(psi, hpsi) / norm2
    resid = hpsi - energy * psi
    residual = (abs(inner(resid, resid)) / norm2) ** 0.5
    abs2 = (psi.conj() * psi).real if psi.is_complex() else psi * psi
    v_inf = torch.sum(abs2 * pot_sub).item() / norm2 if torch.is_tensor(pot_sub) else pot_sub
    return {"energy": energy, "residual": residual, "v_inf": v_inf,
            "r2": torch.sum(abs2 * r2).item() / norm2}


def largest_overlap(states) -> float:
    """max over pairs i < j of |⟨ψᵢ|ψⱼ⟩|/(‖ψᵢ‖‖ψⱼ‖); 0 for one state."""
    norms = [abs(inner(s, s)) ** 0.5 for s in states]
    worst = 0.0
    for j in range(len(states)):
        for i in range(j):
            worst = max(worst, abs(inner(states[i], states[j])) / (norms[i] * norms[j]))
    return worst

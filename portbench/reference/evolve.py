"""A plain imaginary-time solve: the reference in the program's place.

The benchmark's control runs it in bfloat16, the precision below the f32
that the configurations state, and holds what it finds to the same check
as the program's states. Plain PyTorch, any floating dtype. ψ is a
(C, N, N, N) interior field, C = 1 (real) or 2 (an (re, im) pair), with a
zero shell outside. The update is the reference's semi-implicit step
(src/grid.rs:544-687; A and B from src/potential.rs:101-110, with the
energy gauge V → V − max(min V, 0)):

    ψ' = A·ψ + B·dt/(2·m·dn²)·(Σ neighbours − 6ψ)

each step followed by normalisation and, for an excited state,
projection on every lower state (src/grid.rs:674-681); a state is done
when its energy moves by less than the tolerance over ``screen_update``
steps, or after ``max_chunks`` chunks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import potentials


def taps(psi: torch.Tensor) -> torch.Tensor:
    """Σ neighbours − 6ψ of each component, zero outside the interior."""
    p = F.pad(psi, (1, 1, 1, 1, 1, 1))
    return (p[:, 2:, 1:-1, 1:-1] + p[:, :-2, 1:-1, 1:-1] + p[:, 1:-1, 2:, 1:-1]
            + p[:, 1:-1, :-2, 1:-1] + p[:, 1:-1, 1:-1, 2:] + p[:, 1:-1, 1:-1, :-2]
            - 6.0 * psi)


def cmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Componentwise product of two fields, complex where both are pairs."""
    if a.shape[0] == 1 or b.shape[0] == 1:
        return a * b
    return torch.stack([a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]])


def overlap(l: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """⟨l|ψ⟩ as a (C, 1, 1, 1) field."""
    re = torch.sum(l * psi)
    if l.shape[0] == 1:
        return re.reshape(1, 1, 1, 1)
    im = torch.sum(l[0] * psi[1] - l[1] * psi[0])
    return torch.stack([re, im]).reshape(2, 1, 1, 1)


class Solver:
    """The reference's solve of configuration ``raw`` in ``dtype`` on
    ``device``."""

    def __init__(self, raw: dict, dtype, device):
        self.dtype, self.device = dtype, device
        g = raw["grid"]
        self.size = potentials.size(raw)
        self.dn, self.dt, self.mass = float(g["dn"]), float(g["dt"]), float(raw["mass"])
        self.sig = float(raw["sig"])
        self.tol = float(raw["tolerance"])
        self.su = int(raw["output"]["screen_update"])
        v = potentials.potential(raw, device)
        shift = max(float(v.real.min()), 0.0)
        vc = v - shift
        b = 1.0 / (1.0 + self.dt * vc / 2.0)
        a = (1.0 - self.dt * vc / 2.0) * b
        self.v = self._field(v)
        self.a, self.b = self._field(a), self._field(b)
        self.scale = self.dt / (2.0 * self.dn * self.dn * self.mass)
        self.pair = v.is_complex()
        sub = potentials.potential_sub(raw, device)
        self.pot_sub = sub.to(dtype) if torch.is_tensor(sub) else sub
        self.r2 = potentials.r2_index(self.size, device).to(dtype)

    def _field(self, x: torch.Tensor) -> torch.Tensor:
        parts = [x.real, x.imag] if x.is_complex() else [x]
        return torch.stack(parts).to(self.dtype)

    def initial(self, seed: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        c = 2 if self.pair else 1
        noise = torch.randn((1, *self.size), generator=gen, device=self.device, dtype=torch.float32)
        psi = torch.cat([noise, torch.zeros((c - 1, *self.size), device=self.device)])
        return (self.sig * psi).to(self.dtype)

    def normalise(self, psi):
        return psi / torch.sqrt(torch.sum(psi * psi))

    def project(self, psi, lower):
        for l in lower:
            psi = psi - cmul(l, overlap(l, psi))
        return psi

    def energy(self, psi) -> float:
        """⟨ψ|H|ψ⟩/⟨ψ|ψ⟩ (real part), summed in the solve's dtype."""
        h = -taps(psi) / (2.0 * self.mass * self.dn * self.dn) + cmul(self.v, psi)
        return float(torch.sum(psi * h) / torch.sum(psi * psi))

    def solve_state(self, seed: int, lower, max_chunks: int):
        """One state from a seeded Gaussian: (ψ, steps)."""
        psi = self.project(self.normalise(self.initial(seed)), lower)
        last = float("inf")
        for chunk in range(1, max_chunks + 1):
            for _ in range(self.su):
                psi = cmul(self.a, psi) + self.scale * cmul(self.b, taps(psi))
                psi = self.project(self.normalise(psi), lower)
            e = self.energy(psi)
            if abs(e - last) < self.tol:
                break
            last = e
        return psi, chunk * self.su

    def observables(self, psi) -> dict:
        """The reported sums of a state, in the solve's dtype: energy
        (complex for a pair), norm², and ⟨r²⟩ and V∞ unnormalised."""
        h = -taps(psi) / (2.0 * self.mass * self.dn * self.dn) + cmul(self.v, psi)
        norm2 = torch.sum(psi * psi)
        e_re = float(torch.sum(psi * h))
        energy = complex(e_re, float(torch.sum(psi[0] * h[1] - psi[1] * h[0]))) if self.pair else e_re
        abs2 = torch.sum(psi * psi, dim=0)
        v_inf = torch.sum(abs2 * self.pot_sub) if torch.is_tensor(self.pot_sub) else norm2 * self.pot_sub
        return {"energy": energy, "norm2": float(norm2), "r2": float(torch.sum(abs2 * self.r2)),
                "v_infinity": float(v_inf)}

"""What decides ``correct``: each finished solve's states held to the plain
reference.

A solve's answer is its converged states and the observables it reported
for them. The reference (``portbench/reference``) works V, V(∞), the
Laplacian and the exact harmonic levels out again from the configuration
file and judges the states by what they say:

- ``energy_gap``: the largest relative gap between a reported energy
  (E over norm²) and the reference's ⟨ψ|H|ψ⟩/⟨ψ|ψ⟩ of the returned
  state: the measure and the potential the host layer built;
- ``moment_gap``: the same for ⟨r²⟩ and V∞. These move at first order
  with the lower-state admixture that the last measure reports before it
  projects (the energy only at second order), so they read higher on
  excited states;
- ``residual``: the largest ‖(H − E)ψ‖/‖ψ‖ of a state, in the energy's
  units: whether the sweep's states are eigenstates of the reference's H;
- ``overlap``: the largest |⟨ψᵢ|ψⱼ⟩|/(‖ψᵢ‖‖ψⱼ‖) between two states of a
  solve: the Gram-Schmidt and stored-state routes;
- ``level_gap``: the largest |E − Eₖ| against the exact k-th level of the
  discrete oscillator, where the configuration has one: whether the k-th
  state is the k-th level.

A number a cell's limits file does not name is not compared.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import hamiltonian, potentials, spectrum

F64 = torch.float64


def interior(phi: torch.Tensor, ext: int = 1) -> torch.Tensor:
    """A padded ψ of the program (real, or an (re, im) pair stacked first)
    without its shell of ``ext`` planes, as it is."""
    return phi[..., ext:-ext, ext:-ext, ext:-ext]


def as_field(psi: torch.Tensor, device) -> torch.Tensor:
    """An interior ψ (real, or an (re, im) pair stacked first) as the
    reference's field on ``device``: f64, or complex128 for a pair."""
    w = psi.to(device, F64)
    return torch.complex(w[0], w[1]) if w.dim() == 4 else w


def _rel(reported, reference) -> float:
    return abs(reported - reference) / abs(reference)


class Judge:
    """The reference's view of configuration ``raw`` on ``device``."""

    def __init__(self, raw: dict, device):
        self.device = device
        self.dn, self.mass = float(raw["grid"]["dn"]), float(raw["mass"])
        self.v = potentials.potential(raw, device)
        self.pot_sub = potentials.potential_sub(raw, device)
        self.r2 = potentials.r2_index(potentials.size(raw), device)
        self.levels = spectrum.harmonic_levels(raw, 64)

    def solve(self, states) -> dict:
        """The numbers of one solve. ``states``: (ψ interior as
        ``interior`` gives it, on any device and in any dtype; reported
        observables {energy, norm2, v_infinity, r2}) in order of state."""
        out = {"energy_gap": 0.0, "moment_gap": 0.0, "residual": 0.0}
        psis = []
        for k, (psi, rep) in enumerate(states):
            psi = as_field(psi, self.device)
            ref = hamiltonian.judge_state(psi, self.v, self.pot_sub, self.r2, self.dn, self.mass)
            norm2 = rep["norm2"]
            out["energy_gap"] = max(out["energy_gap"], _rel(rep["energy"] / norm2, ref["energy"]))
            moments = [_rel(rep["r2"] / norm2, ref["r2"])]
            if ref["v_inf"] != 0.0:
                moments.append(_rel(rep["v_infinity"] / norm2, ref["v_inf"]))
            out["moment_gap"] = max(out["moment_gap"], *moments)
            out["residual"] = max(out["residual"], ref["residual"])
            if self.levels is not None:
                gap = abs(complex(ref["energy"]).real - self.levels[k])
                out["level_gap"] = max(out.get("level_gap", 0.0), gap)
            psis.append(psi)
        if len(psis) > 1:
            out["overlap"] = hamiltonian.largest_overlap(psis)
        return out


def port_states(results):
    """A finished ``solver.run``'s states as the judge takes them, copied
    to the host so that the card holds only what the program holds."""
    return [
        (interior(r.phi).cpu(), {"energy": r.observables.energy, "norm2": r.observables.norm2,
                                 "v_infinity": r.observables.v_infinity,
                                 "r2": r.observables.r2})
        for r in results
    ]


def verdict(per_solve, limits: dict):
    """(worst, failed): the worst reading of each limited number over the
    solves, and how many solves read over a limit. A reading that is not a
    number (NaN) is over every limit."""
    readings = {name: [] for name in limits}
    failed = 0
    for numbers in per_solve:
        read = {name: numbers[name] for name in limits if name in numbers}
        for name, value in read.items():
            readings[name].append(value)
        failed += any(not value <= limits[name] for name, value in read.items())
    worst = {name: (math.nan if any(math.isnan(v) for v in values) else max(values))
             for name, values in readings.items() if values}
    return worst, failed

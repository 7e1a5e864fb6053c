"""The potentials of the benchmark's configurations, in plain PyTorch f64.

Written from the reference Wafer's formulas (``src/potential.rs``, at the
lines SOURCES.md lists), not from the program: V on the interior of a
ThreePoint grid, whose padded index p = i + 1 sits at p − (N + 1)/2 grid
steps from the centre.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


def axes(size, device, index_from=1.0):
    """Per-axis offsets from the centre, in grid steps, of the interior
    points, broadcastable: V's take the padded index i + 1 of the 0-based
    interior index i, V(∞)'s and ⟨r²⟩'s take i itself (``index_from`` 0)."""
    return [
        (torch.arange(n, dtype=F64, device=device) + index_from - (n + 1.0) / 2.0).reshape(
            [-1 if a == ax else 1 for a in range(3)])
        for ax, n in enumerate(size)
    ]


def alphas(mu: float, nf: float) -> float:
    """Running coupling (src/potential.rs:374-391)."""
    b0 = 11.0 - 2.0 * nf / 3.0
    b1 = 51.0 - 19.0 * nf / 3.0
    b2 = 2857.0 - 5033.0 * nf / 9.0 + 325.0 * nf * nf / 27.0
    lg = 2.0 * math.log(mu / 2.3)
    llg = math.log(lg)
    return (4.0 * math.pi / (b0 * lg)) * (
        1.0 - 2.0 * b1 * llg / (b0 * b0 * lg)
        + 4.0 * b1 * b1 * ((llg - 0.5) ** 2 + b2 * b0 / (8.0 * b1 * b1) - 1.25)
        / (b0 ** 4 * lg * lg))


def mu_debye(t: float, nf: float, tc: float) -> float:
    """Debye screening mass (src/potential.rs:393-398)."""
    return 1.4 * math.sqrt((1.0 + nf / 6.0) * 4.0 * math.pi * alphas(2.0 * math.pi * t, nf)) * t * tc


def cornell(raw: dict) -> dict:
    """The configuration's ``cornell`` group with the reference's defaults
    (T 1, ξ 0, n_f 2, T_c 0.2; src/potential.rs:252-253)."""
    return {"t": 1.0, "xi": 0.0, "nf": 2.0, "tc": 0.2, **(raw.get("cornell") or {})}


def real_potential(raw: dict, device) -> torch.Tensor:
    """V of the configuration ``raw`` (its parsed file) on the interior, f64;
    a Complex* potential's real counterpart."""
    size = tuple(int(raw["grid"]["size"][k]) for k in "xyz")
    dn, mass, sig = float(raw["grid"]["dn"]), float(raw["mass"]), float(raw["sig"])
    kind = raw["potential"].removeprefix("Complex")
    dx, dy, dz = axes(size, device)
    r2 = dx * dx + dy * dy + dz * dz
    if kind == "Harmonic":  # src/potential.rs: r²/2
        return (dn * dn) * r2 / 2.0
    if kind == "FullCornell":  # src/potential.rs:250-269
        cp = cornell(raw)
        r = dn * torch.sqrt(r2)
        aniso = 1.0 - dz * dz / r2
        md = (mu_debye(cp["t"], cp["nf"], cp["tc"]) * (1.0 + 0.07 * cp["xi"] ** 0.2 * aniso)
              * (1.0 + cp["xi"]) ** -0.29)
        rs = torch.clamp(r, min=dn)
        screened = torch.exp(-md * rs)
        far = (-alphas(2.0 * math.pi * cp["t"], cp["nf"]) * (4.0 / 3.0) * screened / rs
               + sig * (1.0 - screened) / md
               - 0.8 * sig / (4.0 * mass * mass * rs)
               + 4.0 * mass)
        return torch.where(r < dn, torch.full_like(far, 4.0 * mass), far)
    raise ValueError(f"the reference has no formula for the potential {raw['potential']!r}")


def potential(raw: dict, device) -> torch.Tensor:
    """V on the interior: real f64, or complex128 (1 + i·absorb)·V for a
    Complex* potential."""
    v = real_potential(raw, device)
    if raw["potential"].startswith("Complex"):
        return v * complex(1.0, float(raw.get("absorb", 0.0)))
    return v


def potential_sub(raw: dict, device):
    """V(∞), the binding-energy offset: FullCornell's array
    (src/potential.rs:326-341, with the reference's own grouping of the
    Debye mass there), else the per-kind constant (src/potential.rs:346-363),
    0 for the harmonic oscillator."""
    kind = raw["potential"].removeprefix("Complex")
    if kind != "FullCornell":
        return 0.0
    size = tuple(int(raw["grid"]["size"][k]) for k in "xyz")
    cp = cornell(raw)
    dx, dy, dz = axes(size, device, index_from=0.0)
    aniso = 1.0 - dz * dz / torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-300)
    md = mu_debye(cp["t"], cp["nf"], cp["tc"]) + 0.07 * cp["xi"] ** 0.2 * aniso * (1.0 + cp["xi"]) ** -0.29
    return float(raw["sig"]) / md + 4.0 * float(raw["mass"])


def r2_index(size, device) -> torch.Tensor:
    """⟨r²⟩'s weight (src/potential.rs:366-371): squared distance in grid
    steps of the 0-based interior index from (N + 1)/2."""
    dx, dy, dz = axes(size, device, index_from=0.0)
    return dx * dx + dy * dy + dz * dz

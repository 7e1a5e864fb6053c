"""The potentials of the benchmark's configurations, in plain PyTorch f64.

Written from the reference Wafer's formulas (``src/potential.rs``, at the
lines SOURCES.md lists), not from the program: V on the interior of a
ThreePoint grid, whose padded index p = i + 1 sits at p − (N + 1)/2 grid
steps from the centre. Each kind of potential is a file of its own,
``kinds/<Kind>.py``, found by name; this module holds what they share.
"""

from __future__ import annotations

import math

import torch

from portbench import spec

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


def size(raw: dict) -> tuple:
    """The configuration's interior grid extents (x, y, z)."""
    return tuple(int(raw["grid"]["size"][k]) for k in "xyz")


def kind(raw: dict):
    """The file of the configuration's potential kind: ``kinds/<Kind>.py``,
    ``<Kind>`` its ``potential`` without the ``Complex`` prefix, with its
    ``potential(raw, device)`` and ``v_infinity(raw, device)``."""
    return spec.potential_kind(raw["potential"].removeprefix("Complex"))


def real_potential(raw: dict, device) -> torch.Tensor:
    """V of the configuration ``raw`` (its parsed file) on the interior, f64;
    a Complex* potential's real counterpart."""
    return kind(raw).potential(raw, device)


def potential(raw: dict, device) -> torch.Tensor:
    """V on the interior: real f64, or complex128 (1 + i·absorb)·V for a
    Complex* potential."""
    v = real_potential(raw, device)
    if raw["potential"].startswith("Complex"):
        return v * complex(1.0, float(raw.get("absorb", 0.0)))
    return v


def potential_sub(raw: dict, device):
    """V(∞), the binding-energy offset, as the kind's file gives it: a
    float, or an array on the interior (FullCornell's)."""
    return kind(raw).v_infinity(raw, device)


def r2_index(size, device) -> torch.Tensor:
    """⟨r²⟩'s weight (src/potential.rs:366-371): squared distance in grid
    steps of the 0-based interior index from (N + 1)/2."""
    dx, dy, dz = axes(size, device, index_from=0.0)
    return dx * dx + dy * dy + dz * dz

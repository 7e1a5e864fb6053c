"""The exact levels of the discrete harmonic oscillator.

V = r²/2 on the grid is a sum over the three axes, and so is the
ThreePoint Laplacian with its zero shell: the grid Hamiltonian is
h_x + h_y + h_z, and its levels are sums of three levels of the 1D
tridiagonal h = −(1/(2m·dn²))·(δ_{i,j+1} − 2δ_ij + δ_{i,j−1}) + x_i²/2,
x_i = dn·(i + 1 − (N + 1)/2). Exact for the grid the solver runs, not for
the continuum (whose levels n + 3/2 it approaches as dn²).
"""

from __future__ import annotations

import numpy as np


def axis_levels(n: int, dn: float, mass: float, count: int) -> np.ndarray:
    x = dn * (np.arange(n) + 1.0 - (n + 1.0) / 2.0)
    off = -1.0 / (2.0 * mass * dn * dn)
    h = np.diag(-2.0 * off + x * x / 2.0) + np.diag(np.full(n - 1, off), 1) + np.diag(np.full(n - 1, off), -1)
    return np.linalg.eigvalsh(h)[:count]


def harmonic_levels(raw: dict, count: int):
    """The ``count`` lowest levels (with multiplicity, ascending) of the
    configuration ``raw`` if its potential is the harmonic oscillator, else
    None."""
    if raw["potential"] != "Harmonic":
        return None
    size = [int(raw["grid"]["size"][k]) for k in "xyz"]
    dn, mass = float(raw["grid"]["dn"]), float(raw["mass"])
    ex, ey, ez = (axis_levels(n, dn, mass, count) for n in size)
    sums = (ex[:, None, None] + ey[None, :, None] + ez[None, None, :]).ravel()
    return np.sort(sums)[:count].tolist()

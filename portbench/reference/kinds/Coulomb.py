"""The hydrogenic Coulomb potential: V = −1/r for r ≥ dn and −1/dn inside
r < dn (src/potential.rs:188-319, the ``Coulomb`` arm); V(∞) = 0
(src/potential.rs:346-363)."""

import torch

from portbench.reference import potentials


def potential(raw: dict, device):
    dn = float(raw["grid"]["dn"])
    dx, dy, dz = potentials.axes(potentials.size(raw), device)
    r = dn * torch.sqrt(dx * dx + dy * dy + dz * dz)
    return torch.where(r < dn, torch.full_like(r, -1.0 / dn), -1.0 / torch.clamp(r, min=dn))


def v_infinity(raw: dict, device) -> float:
    return 0.0

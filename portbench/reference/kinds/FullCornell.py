"""The Debye-screened anisotropic Cornell potential with its spin term and
4m offset, 4m inside r < dn (src/potential.rs:250-269); V(∞) an array
on interior indices, with the reference's own grouping of the Debye mass
there (src/potential.rs:326-341)."""

import math

import torch

from portbench.reference import potentials


def potential(raw: dict, device):
    dn, mass, sig = float(raw["grid"]["dn"]), float(raw["mass"]), float(raw["sig"])
    dx, dy, dz = potentials.axes(potentials.size(raw), device)
    r2 = dx * dx + dy * dy + dz * dz
    cp = potentials.cornell(raw)
    r = dn * torch.sqrt(r2)
    aniso = 1.0 - dz * dz / r2
    md = (potentials.mu_debye(cp["t"], cp["nf"], cp["tc"]) * (1.0 + 0.07 * cp["xi"] ** 0.2 * aniso)
          * (1.0 + cp["xi"]) ** -0.29)
    rs = torch.clamp(r, min=dn)
    screened = torch.exp(-md * rs)
    far = (-potentials.alphas(2.0 * math.pi * cp["t"], cp["nf"]) * (4.0 / 3.0) * screened / rs
           + sig * (1.0 - screened) / md
           - 0.8 * sig / (4.0 * mass * mass * rs)
           + 4.0 * mass)
    return torch.where(r < dn, torch.full_like(far, 4.0 * mass), far)


def v_infinity(raw: dict, device):
    cp = potentials.cornell(raw)
    dx, dy, dz = potentials.axes(potentials.size(raw), device, index_from=0.0)
    aniso = 1.0 - dz * dz / torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-300)
    md = (potentials.mu_debye(cp["t"], cp["nf"], cp["tc"])
          + 0.07 * cp["xi"] ** 0.2 * aniso * (1.0 + cp["xi"]) ** -0.29)
    return float(raw["sig"]) / md + 4.0 * float(raw["mass"])

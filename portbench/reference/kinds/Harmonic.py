"""The harmonic oscillator: V = r²/2 (src/potential.rs:188-319, the
``Harmonic`` arm); V(∞) = 0 (src/potential.rs:346-363)."""

from portbench.reference import potentials


def potential(raw: dict, device):
    dn = float(raw["grid"]["dn"])
    dx, dy, dz = potentials.axes(potentials.size(raw), device)
    r2 = dx * dx + dy * dy + dz * dz
    return (dn * dn) * r2 / 2.0


def v_infinity(raw: dict, device) -> float:
    return 0.0

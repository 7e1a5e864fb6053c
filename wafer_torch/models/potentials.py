"""The potentials on torch tensors (counterpart of
``wafer_tpu/models/potentials.py``; reference: src/potential.rs).

Every built-in family is evaluated on *padded* indices, as the reference
does (src/potential.rs:46-62), in the configured dtype. The complex
families (ComplexCoulomb, ComplexHarmonic, ComplexFullCornell) are
(1 + i·absorb) times their real counterpart; the solver carries them, like
ψ, as (re, im) pairs (:func:`generate_split`, :func:`build_ab_split`).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from wafer_torch import geometry
from wafer_torch.utils.host import real_dtype, to_numpy
from wafer_tpu import errors
from wafer_tpu.config import Config, PotentialType


@dataclass
class Potentials:
    """Potential and ancillary arrays (reference: src/potential.rs:14-25)."""

    # (N+bb)³ real arrays; (2, (N+bb)³) (re, im) pairs for a complex potential
    v: torch.Tensor
    a: torch.Tensor  # (1 − dt·V/2)·B
    b: torch.Tensor  # 1/(1 + dt·V/2)
    pot_sub_array: Optional[torch.Tensor] = None  # N³ (FullCornell)
    pot_sub_scalar: Optional[float] = None
    v_min: Optional[float] = None  # finite minimum of V
    v_shift: float = 0.0  # the energy-gauge shift applied to a/b


def real_counterpart(config: Config) -> Config:
    """``config`` with a Complex* potential replaced by the real family it
    scales (the real-valued side effects: V's real part, pot_sub, the
    initial conditions)."""
    return dataclasses.replace(config, potential=config.potential.real_counterpart)


# --------------------------------------------------------------------------- #
# Cornell physics helpers (reference: src/potential.rs:374-398)
# --------------------------------------------------------------------------- #


def alphas(mu: float, nf: float = 2.0) -> float:
    """Running coupling αₛ(μ) (reference: src/potential.rs:374-391)."""
    b0 = 11.0 - 2.0 * nf / 3.0
    b1 = 51.0 - 19.0 * nf / 3.0
    b2 = 2857.0 - 5033.0 * nf / 9.0 + 325.0 * nf * nf / 27.0
    l = 2.0 * math.log(mu / 2.3)
    ll = math.log(l)
    return (
        4.0
        * math.pi
        * (
            1.0
            - 2.0 * b1 * ll / (b0 * b0 * l)
            + 4.0 * b1 * b1 * ((ll - 0.5) ** 2 + b2 * b0 / (8.0 * b1 * b1) - 5.0 / 4.0)
            / (b0 ** 4 * l * l)
        )
        / (b0 * l)
    )


def mu_debye(t: float, nf: float = 2.0, tc: float = 0.2) -> float:
    """Debye screening mass μ(T) (reference: src/potential.rs:393-398)."""
    return 1.4 * math.sqrt((1.0 + nf / 6.0) * 4.0 * math.pi * alphas(2.0 * math.pi * t)) * t * tc


# Dodecahedron face-plane constants from the golden ratio
# (reference hardcodes the decimals: src/potential.rs:283-308)
_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)
_PHI = (1.0 + _SQRT5) / 2.0
_C_3_2PS5 = 3.0 * (2.0 + _SQRT5)
_C_4S3PHI = 4.0 * _SQRT3 * _PHI
_C_S3_4P2S5 = _SQRT3 * (4.0 + 2.0 * _SQRT5)
_C_2S3PHI = 2.0 * _SQRT3 * _PHI
_C_2PHI = 2.0 * _PHI
_C_2OPHI = 2.0 / _PHI
_C_2PS5 = 2.0 + _SQRT5
_C_2PHI2 = 2.0 * _PHI * _PHI
_C_4S3PHI2 = 4.0 * _SQRT3 * _PHI * _PHI
_C_2S3PHI2 = 2.0 * _SQRT3 * _PHI * _PHI
_C_9P3S5 = 9.0 + 3.0 * _SQRT5
_C_3P3S5 = 3.0 + 3.0 * _SQRT5
_C_2P2S5 = 2.0 + 2.0 * _SQRT5
_C_4P2S5 = 4.0 + 2.0 * _SQRT5
_C_6_2PS5 = 6.0 * (2.0 + _SQRT5)
_C_2S3 = 2.0 * _SQRT3


def _dodecahedron_mask(x, y, z):
    """Inside test for a regular dodecahedron in normalised coordinates
    (reference: src/potential.rs:283-308)."""
    return (
        (_C_3_2PS5 + _C_4S3PHI * x >= _C_S3_4P2S5 * z)
        & (_C_4S3PHI * x <= _C_3_2PS5 + _C_S3_4P2S5 * z)
        & (_C_2S3PHI * (_C_2PHI * x - _C_2OPHI * z) <= 6.0 * (_C_2PS5 + _C_2PHI2 * y))
        & (_C_4S3PHI2 * x + _C_2S3 * z <= _C_3_2PS5)
        & (_C_2S3PHI2 * x + _C_9P3S5 * y <= _C_3_2PS5 + _C_2S3 * z)
        & (_C_3P3S5 * y <= _C_3_2PS5 + _C_2S3PHI * x + _C_S3_4P2S5 * z)
        & (_C_3_2PS5 + _C_2S3PHI * x + _C_3P3S5 * y + _C_S3_4P2S5 * z >= 0.0)
        & (_C_9P3S5 * y + _C_2S3 * z <= _C_3_2PS5 + _C_2S3PHI2 * x)
        & (_C_2S3PHI * (-_C_2P2S5 * x - _C_2OPHI * z) <= _C_6_2PS5)
        & (_C_2S3 * z <= _C_2S3PHI2 * x + 3.0 * (_C_2PS5 + _C_2PHI2 * y))
        & (_SQRT3 * (_C_2PHI * x + _C_4P2S5 * z) <= 3.0 * (_C_2PS5 + _C_2PHI * y))
        & (_C_2S3PHI * x + _C_3P3S5 * y + _C_S3_4P2S5 * z <= _C_3_2PS5)
    )


def _axes(shape, offset, dtype, device):
    return [
        (torch.arange(n, dtype=dtype, device=device) + o).reshape(
            [-1 if a == ax else 1 for a in range(3)]
        )
        for ax, (n, o) in enumerate(zip(shape, offset))
    ]


def generate(
    config: Config,
    shape: Optional[Tuple[int, int, int]] = None,
    offset: Tuple[int, int, int] = (0, 0, 0),
    device=None,
) -> torch.Tensor:
    """The potential on padded indices (reference: src/potential.rs:46-62);
    ``shape``/``offset`` select a block of the global padded array."""
    if config.potential in (PotentialType.FROM_FILE, PotentialType.FROM_SCRIPT):
        raise errors.PotentialNotAvailableError()
    if config.potential.is_complex:
        v = generate(real_counterpart(config), shape, offset, device)
        return torch.complex(v, torch.zeros_like(v)) * (1.0 + 1j * config.absorb)
    if shape is None:
        shape = config.padded_size()
    rdt = real_dtype(config)
    nx, ny, nz = config.grid.size.as_tuple()
    dn, mass, pot = config.grid.dn, config.mass, config.potential

    if pot is PotentialType.NO_POTENTIAL:
        return torch.zeros(shape, dtype=rdt, device=device)

    if pot in (PotentialType.CUBE, PotentialType.QUAD_WELL):
        ii, jj, kk = _axes(shape, offset, torch.int64, device)
        inside = (ii > nx // 4) & (ii <= 3 * nx // 4) & (jj > ny // 4) & (jj <= 3 * ny // 4)
        if pot is PotentialType.CUBE:
            inside = inside & (kk > nz // 4) & (kk <= 3 * nz // 4)
        else:  # QuadWell: short side along z (src/potential.rs:202-211)
            inside = inside & (kk > 3 * nz // 8) & (kk <= 5 * nz // 8)
        return torch.where(inside, -10.0, 0.0).to(rdt)

    fi, fj, fk = _axes(shape, offset, rdt, device)
    if pot is PotentialType.PERIODIC:
        # (idx−1)/(num−1) on padded indices (src/potential.rs:212-219)
        sx = torch.sin(2.0 * math.pi * (fi - 1.0) / (nx - 1.0)) ** 2
        sy = torch.sin(2.0 * math.pi * (fj - 1.0) / (ny - 1.0)) ** 2
        sz = torch.sin(2.0 * math.pi * (fk - 1.0) / (nz - 1.0)) ** 2
        return -(sx * sy * sz) + 1.0

    dx = fi - (nx + 1.0) / 2.0
    dy = fj - (ny + 1.0) / 2.0
    dz = fk - (nz + 1.0) / 2.0
    r2 = dx * dx + dy * dy + dz * dz
    r = dn * torch.sqrt(r2)

    if pot is PotentialType.COULOMB:
        return torch.where(r < dn, -1.0 / dn, -1.0 / torch.clamp(r, min=dn))

    if pot is PotentialType.ELIPTICAL_COULOMB:
        # z squashed by 2, offset so V(∞) = 1/dn (src/potential.rs:230-240)
        re = dn * torch.sqrt(dx * dx + dy * dy + (2.0 * dz) ** 2)
        return torch.where(re < dn, 0.0, -1.0 / torch.clamp(re, min=dn) + 1.0 / dn)

    if pot is PotentialType.SIMPLE_CORNELL:
        # GeV units; sig is the string tension (src/potential.rs:241-249)
        r_safe = torch.clamp(r, min=dn)
        far = -0.5 * (4.0 / 3.0) / r_safe + config.sig * r_safe + 4.0 * mass
        return torch.where(r < dn, 4.0 * mass, far)

    if pot is PotentialType.FULL_CORNELL:
        # Debye-screened anisotropic Cornell + spin correction
        # (src/potential.rs:250-269)
        cp = config.cornell
        r2_safe = torch.clamp(r2, min=1e-300)
        aniso = 1.0 - dn * dn * dz * dz / (dn * dn * r2_safe)
        md = (
            mu_debye(cp.t, cp.nf, cp.tc)
            * (1.0 + 0.07 * (cp.xi ** 0.2) * aniso)
            * (1.0 + cp.xi) ** -0.29
        )
        r_safe = torch.clamp(r, min=dn)
        screened = torch.exp(-md * r_safe)
        far = (
            -alphas(2.0 * math.pi * cp.t, cp.nf) * (4.0 / 3.0) * screened / r_safe
            + config.sig * (1.0 - screened) / md
            - 0.8 * config.sig / (4.0 * mass * mass * r_safe)
            + 4.0 * mass
        )
        return torch.where(r < dn, 4.0 * mass, far)

    if pot is PotentialType.HARMONIC:
        return r * r / 2.0

    if pot is PotentialType.DODECAHEDRON:
        # normalised coordinates over the box (src/potential.rs:275-313)
        x = dx / ((nx - 1.0) / 2.0)
        y = dy / ((ny - 1.0) / 2.0)
        z = dz / ((nz - 1.0) / 2.0)
        return torch.where(_dodecahedron_mask(x, y, z), -100.0, 0.0).to(rdt)

    raise errors.PotentialNotAvailableError()


def potential_scalar(config: Config, idx: Tuple[int, int, int]) -> complex:
    """V at one padded index (single-point evaluation)."""
    return complex(generate(config, shape=(1, 1, 1), offset=idx).reshape(()).item())


def potential_sub_scalar(config: Config) -> float:
    """Constant V(∞) per potential type (reference: src/potential.rs:346-363)."""
    pot = config.potential
    if pot is PotentialType.ELIPTICAL_COULOMB:
        return 1.0 / config.grid.dn
    if pot is PotentialType.SIMPLE_CORNELL:
        return 4.0 * config.mass
    if pot.variable_pot_sub:
        raise errors.PotentialNotAvailableError()
    return 0.0


def potential_sub_array(config: Config, device=None) -> torch.Tensor:
    """FullCornell's V(∞) array at the *work* size with work indices
    (reference: src/potential.rs:326-341,134-144), keeping the reference's
    own parenthesisation of ``md`` there."""
    if not config.potential.variable_pot_sub:
        raise errors.PotentialNotAvailableError()
    rdt = real_dtype(config)
    nx, ny, nz = config.grid.size.as_tuple()
    dn, cp = config.grid.dn, config.cornell
    fi, fj, fk = _axes(config.work_size(), (0, 0, 0), rdt, device)
    dx = fi - (nx + 1.0) / 2.0
    dy = fj - (ny + 1.0) / 2.0
    dz = fk - (nz + 1.0) / 2.0
    r2_safe = torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-300)
    aniso = 1.0 - dn * dn * dz * dz / (dn * dn * r2_safe)
    md = mu_debye(cp.t, cp.nf, cp.tc) * 1.0 + (
        0.07 * (cp.xi ** 0.2) * aniso * (1.0 + cp.xi) ** -0.29
    )
    return config.sig / md + 4.0 * config.mass


def build_ab(v: torch.Tensor, dt: float, v_shift: float = 0.0):
    """Semi-implicit factors ``B = 1/(1 + dt·V/2)``, ``A = (1 − dt·V/2)·B``
    (reference: src/potential.rs:101-110), with the energy gauge
    ``V → V − v_shift`` applied to the evolution factors only: a constant
    shift rescales ψ by a global factor that normalisation removes, and
    keeps f32 chunks of large-offset potentials out of underflow."""
    vs = v - v_shift
    b = 1.0 / (1.0 + dt * vs / 2.0)
    a = (1.0 - dt * vs / 2.0) * b
    return a, b


def generate_split(
    config: Config,
    shape: Optional[Tuple[int, int, int]] = None,
    offset: Tuple[int, int, int] = (0, 0, 0),
    device=None,
):
    """A Complex* potential as the (re, im) pair ``(V, absorb·V)`` of its
    real counterpart V."""
    if not config.potential.is_complex:
        raise errors.PotentialNotAvailableError()
    vr = generate(real_counterpart(config), shape, offset, device)
    return vr, config.absorb * vr


def build_ab_split(vr, vi, dt: float, v_shift: float = 0.0):
    """Split-complex factors B = 1/(1 + dt·V/2), A = (1 − dt·V/2)·B with
    V = vr + i·vi over real arrays; ``v_shift`` as in :func:`build_ab`,
    on the real part."""
    vr = vr - v_shift
    dr = 1.0 + dt * vr / 2.0
    di = dt * vi / 2.0
    mag = dr * dr + di * di
    br = dr / mag
    bi = -di / mag
    nr = 1.0 - dt * vr / 2.0
    ni = -dt * vi / 2.0
    ar = nr * br - ni * bi
    ai = nr * bi + ni * br
    return ar, ai, br, bi


def load_pot_sub(config: Config, log=None, device=None):
    """potential_sub with the reference's file preference and
    type-consistency checks (src/potential.rs:112-153): a work-size array
    for FullCornell, a positive scalar otherwise, (None, None) when
    V(∞) = 0."""
    from wafer_tpu.io import readers

    log = log or logging.getLogger("wafer")
    try:
        sub_from_file = readers.potential_sub(
            config.work_size(), config.output.file_type, log, input_dir=config.input_dir
        )
    except errors.FileNotFoundWaferError:
        sub_from_file = None

    if sub_from_file is not None:
        arr, scalar = sub_from_file
        if arr is None and scalar is not None and config.potential.variable_pot_sub:
            log.error(
                "Potential_sub input file contains a singular value, but potential "
                "type is FullCornell. Update or remove the potential file in the "
                "input directory before continuing."
            )
            raise errors.WrongPotentialSubDimsError()
        if arr is not None and scalar is None and not config.potential.variable_pot_sub:
            log.error(
                "Potential_sub input file contains an array, but potential type is "
                "not FullCornell. Update or remove the potential file in the input "
                "directory before continuing."
            )
            raise errors.WrongPotentialSubDimsError()
        log.info("Potential_sub loaded from disk")
        pot_sub_array = (
            torch.as_tensor(np.asarray(arr), dtype=real_dtype(config), device=device)
            if arr is not None
            else None
        )
        return pot_sub_array, (float(scalar) if scalar is not None else None)
    if config.potential.variable_pot_sub:
        log.info("Variable potential_sub calculated directly")
        return potential_sub_array(config, device=device), None
    single = potential_sub_scalar(config)
    log.info("Constant potential_sub calculated directly")
    # only a positive offset is kept (src/potential.rs:146-153)
    return None, (single if single > 0.0 else None)


def scan_v_min(config: Config, slabs: int = 8) -> float:
    """Finite minimum of the analytic V by x-slab scan in O(slab) memory
    (reference scan: src/potential.rs:156-161)."""
    px, py, pz = config.padded_size()
    step = max(1, -(-px // slabs))
    v_min = float("inf")
    for x0 in range(0, px, step):
        blk = generate(config, (min(step, px - x0), py, pz), (x0, 0, 0))
        v_min = min(v_min, _finite_min(blk))
    return v_min


def _finite_min(v: torch.Tensor) -> float:
    return float(torch.where(torch.isfinite(v), v, torch.inf).min())


def v_shift_and_pole_warn(config: Config, v_min: float, log) -> float:
    """The energy-gauge shift from a finite positive V minimum, and the
    semi-implicit pole warning (reference computes the inf silently,
    src/potential.rs:101-110,156-161). Only a positive offset is removed:
    for deep wells E₀ sits near 0 and shifting to v_min would inflate the
    per-chunk scale drift."""
    v_shift = max(v_min, 0.0) if math.isfinite(v_min) else 0.0
    if math.isfinite(v_min) and 1.0 + config.grid.dt * (v_min - v_shift) / 2.0 <= 0.0:
        log.warning(
            "Potential minimum %.6g reaches the semi-implicit pole for "
            "dt = %g (B = 1/(1+dt·V/2) diverges where V ≤ −2/dt = %.6g); "
            "reduce dt below %.6g or the run will abort non-finite.",
            v_min,
            config.grid.dt,
            -2.0 / config.grid.dt,
            2.0 / abs(v_min - v_shift) if v_min != v_shift else float("inf"),
        )
    return v_shift


def _save(config: Config, v: torch.Tensor, log) -> None:
    """``save_potential``: the potential's work area and, where it exists,
    potential_sub (reference: src/output.rs:85-141)."""
    from wafer_tpu.io import formats, run_dir, writers

    ft = config.output.file_type
    work = geometry.work_area(v, config.central_difference.ext)
    try:
        writers.potential(to_numpy(work), config.project_name, ft, output_root=config.output_root)
    except errors.WaferError as exc:
        log.warning("Could not write potential to disk: %s", exc)
    path = (
        f"{run_dir.get_project_dir(config.project_name, config.output_root)}/"
        f"potential_sub{ft.extension}"
    )
    try:
        if config.potential.variable_pot_sub:
            arr = to_numpy(potential_sub_array(config))
            writers._write(path, writers._encode_array(arr, ft))
        elif potential_sub_scalar(config) > 0.0:
            writers._write(path, formats.sub_single_to(ft.value, potential_sub_scalar(config)))
    except errors.WaferError as exc:
        log.warning("Could not write potential_sub to disk: %s", exc)


def load_arrays(config: Config, log=None, device=None) -> Potentials:
    """Load or generate V, build A/B and pot_sub
    (reference: src/potential.rs:75-175).

    A complex potential comes back as (re, im) pairs, with the reference's
    split-mode rule (wafer_tpu/solver.py:2086-2108): v_min, the gauge shift
    and pot_sub are those of the real counterpart, and ``save_potential``
    writes the real part only."""
    from wafer_tpu.io import readers, script as script_io

    log = log or logging.getLogger("wafer")
    rdt = real_dtype(config)
    split = config.potential.is_complex
    if split:
        if config.output.save_potential:
            log.warning("save_potential of a complex potential stores the real part only")
        v, v_im = generate_split(config, device=device)
        config = real_counterpart(config)
    elif config.potential is PotentialType.FROM_FILE:
        log.info("Loading potential from file")
        try:
            v = readers.potential(
                config.padded_size(),
                config.central_difference.bb,
                config.output.file_type,
                log,
                input_dir=config.input_dir,
            )
        except errors.WaferError as exc:
            raise errors.LoadPotentialError() from exc
        v = torch.as_tensor(np.asarray(v), dtype=rdt, device=device)
    elif config.potential is PotentialType.FROM_SCRIPT:
        if config.script_location is None:
            raise errors.ScriptNotFoundError()
        v = script_io.script_potential(
            config.script_location, config.grid, config.central_difference.bb, log
        )
        v = torch.as_tensor(np.asarray(v), dtype=rdt, device=device)
    else:
        log.info("Calculating potential array")
        v = generate(config, device=device)

    v_min = _finite_min(v)
    v_shift = v_shift_and_pole_warn(config, v_min, log)
    pot_sub_array, pot_sub_scalar = load_pot_sub(config, log, device=device)
    if config.output.save_potential:
        log.info("Saving potential to disk")
        _save(config, v, log)
    if split:
        ar, ai, br, bi = build_ab_split(v, v_im, config.grid.dt, v_shift)
        v, a, b = torch.stack([v, v_im]), torch.stack([ar, ai]), torch.stack([br, bi])
    else:
        a, b = build_ab(v, config.grid.dt, v_shift)
    return Potentials(
        v=v,
        a=a,
        b=b,
        pot_sub_array=pot_sub_array,
        pot_sub_scalar=pot_sub_scalar,
        v_min=v_min,
        v_shift=v_shift,
    )

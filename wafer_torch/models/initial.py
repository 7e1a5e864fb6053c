"""Initial conditions and symmetry constraints (counterpart of
``wafer_tpu/models/initial.py``; reference: src/config.rs:577-728).

Seeded noise comes from an explicit ``torch.Generator`` on the CPU, so a
seed gives the same field on every device. It cannot reproduce the
reference's ``jax.random`` draws: tests that compare the two packages
hand both the same initial array.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from wafer_torch import geometry
from wafer_torch.utils.host import real_dtype
from wafer_tpu import errors
from wafer_tpu.config import Config, InitialCondition


def _generator(*words: int) -> torch.Generator:
    seed = int(np.random.SeedSequence([w & 0xFFFFFFFF for w in words]).generate_state(1)[0])
    return torch.Generator().manual_seed(seed)


def generate_gaussian(config: Config, init_size, seed: Optional[int] = None, device=None):
    """Mean-0 Gaussian noise with σ = ``config.sig`` (reference:
    src/config.rs:636-642 draws from a thread rng; here the seed, or
    os.urandom without one, fixes the draw)."""
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    noise = torch.randn(init_size, generator=_generator(seed), dtype=real_dtype(config))
    return (config.sig * noise).to(device)


def generate_coulomb(config: Config, init_size, device=None) -> torch.Tensor:
    """Hydrogenic n=1, 2s, 2p₀, 2p±₁ superposition (reference:
    src/config.rs:650-668), with its quirks: the centre is ``init_size/2``
    in padded coordinates and the cosines carry a stray ``dn``. The r = 0
    cell takes the r → 0 limit with costheta = cosphi = 0."""
    rdt = real_dtype(config)
    dn, m = config.grid.dn, config.mass
    fi, fj, fk = (
        torch.arange(n, dtype=rdt, device=device).reshape([-1 if a == ax else 1 for a in range(3)])
        for ax, n in enumerate(init_size)
    )
    dx = fi - init_size[0] / 2.0
    dy = fj - init_size[1] / 2.0
    dz = fk - init_size[2] / 2.0
    r = dn * torch.sqrt(dx * dx + dy * dy + dz * dz)
    r_safe = torch.where(r > 0.0, r, 1.0)
    costheta = torch.where(r > 0.0, dn * dz / r_safe, 0.0)
    cosphi = torch.where(r > 0.0, dn * dx / r_safe, 0.0)
    mr2 = torch.exp(-m * r / 2.0)
    sin_term = torch.sqrt(torch.clamp(1.0 - costheta ** 2, min=0.0))
    return (
        torch.exp(-m * r)
        + (2.0 - m * r) * mr2
        + m * r * mr2 * costheta
        + m * r * mr2 * sin_term * cosphi
    )


def generate_boolean(init_size, dtype, device=None) -> torch.Tensor:
    """Parity test grid: 1 where i, j, k are all odd
    (reference: src/config.rs:676-683)."""
    i, j, k = (
        torch.arange(n, device=device).reshape([-1 if a == ax else 1 for a in range(3)]) % 2
        for ax, n in enumerate(init_size)
    )
    return (i * j * k).to(dtype)


def perturb_clone(
    config: Config,
    w: torch.Tensor,
    wnum: int,
    seed: Optional[int] = None,
    scale: float = 1e-3,
) -> torch.Tensor:
    """Seed state ``wnum`` from a converged lower state plus deterministic
    relative noise (documented divergence, docs/PARITY.md): in f32 an exact
    clone can Gram-Schmidt-cancel bitwise to the zero array. The noise is
    drawn on the interior from ``(seed, 7919·wnum)`` and zero-padded, so
    the Dirichlet shell stays clean."""
    ext = config.central_difference.ext
    gen = _generator(0 if seed is None else seed, 7919 * wnum)
    noise = torch.randn(config.grid.size.as_tuple(), generator=gen, dtype=w.dtype)
    noise = torch.nn.functional.pad(noise, (ext,) * 6).to(w.device)
    rms = torch.sqrt(torch.mean(geometry.work_area(w, ext) ** 2))
    return w + (scale * rms) * noise


def set_initial_conditions(
    config: Config, log=None, seed: Optional[int] = None, device=None
) -> torch.Tensor:
    """Generator → Dirichlet shell → symmetrisation
    (reference: src/config.rs:577-627)."""
    log = log or logging.getLogger("wafer")
    log.info("Setting initial conditions for wavefunction")
    init_size = config.padded_size()
    rdt = real_dtype(config)
    ic = config.init_condition
    if ic is InitialCondition.FROM_FILE:
        from wafer_tpu.io import readers

        try:
            w = readers.wavefunction(
                config.wavenum,
                init_size,
                config.central_difference.bb,
                config.output.file_type,
                log,
                input_dir=config.input_dir,
            )
        except errors.WaferError as exc:
            raise errors.LoadWavefunctionError(config.wavenum) from exc
        w = torch.as_tensor(np.asarray(w), dtype=rdt, device=device)
    elif ic is InitialCondition.GAUSSIAN:
        w = generate_gaussian(config, init_size, seed=seed, device=device)
    elif ic is InitialCondition.COULOMB:
        w = generate_coulomb(config, init_size, device=device)
    elif ic is InitialCondition.CONSTANT:
        w = torch.full(init_size, 0.1, dtype=rdt, device=device)
    elif ic is InitialCondition.BOOLEAN:
        w = generate_boolean(init_size, rdt, device=device)
    else:  # pragma: no cover
        raise errors.SetInitialConditionsError()
    w = geometry.zero_boundary(w, config.central_difference.ext)
    return symmetrise_wavefunction(config, w)


def symmetrise_wavefunction(config: Config, w: torch.Tensor) -> torch.Tensor:
    """Force (anti)symmetry about the y or z mid-plane (reference:
    src/config.rs:691-728). The net effect of the reference's sequential
    in-place loop, with writes clamped to interior planes (see the
    reference package's docstring for the derivation):

    - ``p ≤ mid`` and a self-mapped central plane: scaled by ``sign``;
    - ``p > mid`` with an interior mirror: the mirror's value (net sign²);
    - ``p > mid`` mirrored into the halo: ``sign``·halo, zero for solver
      arrays."""
    sym = config.init_symmetry
    axis = sym.axis
    if axis is None:
        return w
    ext = config.central_difference.ext
    size = config.grid.size.as_tuple()
    n = size[axis]

    p = np.arange(w.shape[axis])
    mid = (ext + n) // 2
    src = p.copy()
    upper = p > mid
    src[upper] = ext + n + 1 - p[upper]
    np.clip(src, 0, w.shape[axis] - 1, out=src)
    scale = np.ones(w.shape[axis])
    scale[(p <= mid) | (src == p) | (src < ext)] = sym.sign

    shape = [1, 1, 1]
    shape[axis] = w.shape[axis]
    mirrored = torch.index_select(w, axis, torch.as_tensor(src, device=w.device))
    mirrored = mirrored * torch.as_tensor(scale, dtype=w.dtype, device=w.device).reshape(shape)

    # interior y and z planes are written; all x
    # (reference loops: src/config.rs:701-726, halo-clamped)
    yj = np.arange(w.shape[1])
    zk = np.arange(w.shape[2])
    mask_y = (yj >= ext) & (yj < ext + size[1])
    mask_z = (zk >= ext) & (zk < ext + size[2])
    write = torch.as_tensor(mask_y[None, :, None] & mask_z[None, None, :], device=w.device)
    return torch.where(write, mirrored, w)

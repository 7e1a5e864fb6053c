"""Initial conditions and symmetry constraints (counterpart of
``wafer_tpu/models/initial.py``; reference: src/config.rs:577-728).

Seeded noise comes from an explicit ``torch.Generator`` on the CPU, so a
seed gives the same field on every device. It cannot reproduce the
reference's ``jax.random`` draws: tests that compare the two packages
hand both the same initial array.

For a complex potential ψ is an (re, im) pair, a ``(2, …)`` tensor, with
the reference's split rule (wafer_tpu/solver.py:1122-1192): a file's
complex array is split on the host, a previous state's pair is perturbed
per component, and the generators start from the real counterpart's field
with a zero imaginary part.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from wafer_torch import geometry
from wafer_torch.models.potentials import real_counterpart
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


def host_field(config: Config, arr, device=None) -> torch.Tensor:
    """A padded field read from disk as the solver's ψ: real, or for a
    complex potential the (re, im) pair, split on the host."""
    arr = np.asarray(arr)
    rdt = real_dtype(config)
    if config.potential.is_complex:
        return torch.stack([
            torch.as_tensor(np.real(arr), dtype=rdt, device=device),
            torch.as_tensor(np.imag(arr), dtype=rdt, device=device),
        ])
    return torch.as_tensor(arr, dtype=rdt, device=device)


def perturb_clone(
    config: Config,
    w: torch.Tensor,
    wnum: int,
    seed: Optional[int] = None,
    scale: float = 1e-3,
    component: int = 0,
    rms_from: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Seed state ``wnum`` from a converged lower state plus deterministic
    relative noise (documented divergence, docs/PARITY.md): in f32 an exact
    clone can Gram-Schmidt-cancel bitwise to the zero array. The noise is
    drawn on the interior from ``(seed, 7919·wnum + component)`` and
    zero-padded, so the Dirichlet shell stays clean; its amplitude is
    ``scale`` times the rms of ``rms_from`` (default ``w``). An (re, im)
    pair perturbs im as component 1 at the rms of re, as the reference's
    split path does."""
    if w.dim() == 4:
        return torch.stack([
            perturb_clone(config, w[0], wnum, seed, scale),
            perturb_clone(config, w[1], wnum, seed, scale, component=1, rms_from=w[0]),
        ])
    ext = config.central_difference.ext
    gen = _generator(0 if seed is None else seed, 7919 * wnum + component)
    noise = torch.randn(config.grid.size.as_tuple(), generator=gen, dtype=w.dtype)
    noise = torch.nn.functional.pad(noise, (ext,) * 6).to(w.device)
    ref = w if rms_from is None else rms_from
    rms = torch.sqrt(torch.mean(geometry.work_area(ref, ext) ** 2))
    return w + (scale * rms) * noise


def set_initial_conditions(
    config: Config, log=None, seed: Optional[int] = None, device=None
) -> torch.Tensor:
    """Generator → Dirichlet shell → symmetrisation
    (reference: src/config.rs:577-627); an (re, im) pair for a complex
    potential."""
    log = log or logging.getLogger("wafer")
    ic = config.init_condition
    if config.potential.is_complex and ic is not InitialCondition.FROM_FILE:
        re = set_initial_conditions(real_counterpart(config), log, seed=seed, device=device)
        return torch.stack([re, torch.zeros_like(re)])
    log.info("Setting initial conditions for wavefunction")
    init_size = config.padded_size()
    rdt = real_dtype(config)
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
        w = host_field(config, w, device)
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
    """Force (anti)symmetry about the y or z mid-plane of the last three
    axes, so an (re, im) pair is symmetrised per component (reference:
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

    dim = w.dim() - 3 + axis
    p = np.arange(w.shape[dim])
    mid = (ext + n) // 2
    src = p.copy()
    upper = p > mid
    src[upper] = ext + n + 1 - p[upper]
    np.clip(src, 0, w.shape[dim] - 1, out=src)
    scale = np.ones(w.shape[dim])
    scale[(p <= mid) | (src == p) | (src < ext)] = sym.sign

    shape = [1, 1, 1]
    shape[axis] = w.shape[dim]
    mirrored = torch.index_select(w, dim, torch.as_tensor(src, device=w.device))
    mirrored = mirrored * torch.as_tensor(scale, dtype=w.dtype, device=w.device).reshape(shape)

    # interior y and z planes are written; all x
    # (reference loops: src/config.rs:701-726, halo-clamped)
    yj = np.arange(w.shape[-2])
    zk = np.arange(w.shape[-1])
    mask_y = (yj >= ext) & (yj < ext + size[1])
    mask_z = (zk >= ext) & (zk < ext + size[2])
    write = torch.as_tensor(mask_y[None, :, None] & mask_z[None, None, :], device=w.device)
    return torch.where(write, mirrored, w)

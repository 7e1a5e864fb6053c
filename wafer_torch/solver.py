"""Convergence loop (counterpart of ``wafer_tpu/solver.py``; reference
``grid::run``/``solve``, src/grid.rs:31-246).

``run`` → ``_run_single`` → ``solve``. Each ``screen_update`` chunk runs on
the device without a host synchronisation; the host reads the four
observable scalars once per chunk to drive the convergence test, the
drift guard, the delayed re-orthogonalisation gate, snapshots and
progress output, at the reference's cadence (src/grid.rs:216-220).

A complex potential carries ψ, V, A and B as (re, im) pairs, ``(2, …)``
tensors, on every device and at both precisions — the reference's
split-complex path (``_solve_split``, wafer_tpu/solver.py:1089) — through
the same loop, with the split measure and sweep.

Backend rule: ``backend: auto`` runs the CUDA sweeps (``ops/hopper_stencil``
for real ψ, ``ops/hopper_split`` for pairs) for f32 on a CUDA device and the
plain torch ops (``ops/stencil``, ``ops/split_complex``) otherwise — f64 runs
the plain ops on every device, as the reference runs f64 on its XLA sweep;
``pallas`` demands the CUDA sweep; ``xla`` forces the plain ops.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from wafer_torch import geometry
from wafer_torch.errors import NotPortedError
from wafer_torch.models import initial, potentials as potentials_mod
from wafer_torch.models.potentials import Potentials
from wafer_torch.ops import gram_schmidt, hopper_split, hopper_stencil, split_complex, stencil
from wafer_torch.ops.observables import Observables, compute_observables_device
from wafer_torch.utils.host import real_dtype, to_numpy
from wafer_tpu import errors
from wafer_tpu.config import Config, PotentialType

# potentials whose B the CUDA sweep computes from coordinates; a complex
# potential looks up its real counterpart (Harmonic and Coulomb, the kinds
# of hopper_split.KINDS; FullCornell streams (Br, Bi))
_ANALYTIC_KINDS = {
    PotentialType.NO_POTENTIAL: "NoPotential",
    PotentialType.HARMONIC: "Harmonic",
    PotentialType.COULOMB: "Coulomb",
    PotentialType.SIMPLE_CORNELL: "SimpleCornell",
    PotentialType.PERIODIC: "Periodic",
}


@dataclass
class SolveResult:
    """Outcome of one state's convergence loop. ``phi`` is the (re, im)
    pair for a complex potential. ``chunk_seconds`` is the time spent in
    evolve chunks: CUDA-event time on a GPU, host time on the CPU."""

    wnum: int
    converged: bool
    observables: Observables
    steps: int
    phi: torch.Tensor
    chunk_seconds: float = 0.0


def _max_rel_overlap(phi: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """max_s |⟨l_s|ψ⟩| / (‖l_s‖·‖ψ‖): the measured lower-state admixture
    that overrides the delayed re-orthogonalisation gate; for (re, im)
    pairs the modulus of the conjugated complex overlap
    (wafer_tpu/solver.py:57-63)."""
    dims = phi.dim()
    pn = torch.sqrt(torch.sum(phi * phi))
    ln = torch.sqrt(torch.sum(stacked * stacked, dim=tuple(range(1, dims + 1))))
    ov = torch.tensordot(stacked, phi, dims=dims)  # Σ lᵣψᵣ + lᵢψᵢ for pairs
    if dims == 4:
        ov_im = (torch.tensordot(stacked[:, 0], phi[1], dims=3)
                 - torch.tensordot(stacked[:, 1], phi[0], dims=3))
        ov = torch.hypot(ov, ov_im)
    return torch.max(torch.abs(ov) / (ln * pn))


def _measure_and_prepare(
    phi, v, r2_grid, pot_sub_array, pot_sub_scalar, w_store, order, dn, mass, n_lower
) -> Tuple[Observables, torch.Tensor]:
    """Observables of the current ψ, read on the host in one transfer, then
    normalise, then orthogonalise (reference loop head:
    src/grid.rs:127-135). A pair ``phi`` (with pair ``v`` and ``w_store``)
    takes the split measure and yields a complex energy."""
    if phi.dim() == 4:
        store_r = store_i = None
        if n_lower:
            store_r, store_i = w_store[:, 0], w_store[:, 1]
        (e_re, e_im, *rest), pair = split_complex.measure_and_prepare_sc(
            phi[0], phi[1], v[0], v[1], r2_grid, pot_sub_array, pot_sub_scalar,
            store_r, store_i, order, dn, mass, n_lower,
        )
        e_re, e_im, norm2, v_inf, r2 = torch.stack([e_re, e_im, *rest]).tolist()
        energy = complex(e_re, e_im)
        phi = torch.stack(pair)
    else:
        scalars = compute_observables_device(
            phi, v, r2_grid, pot_sub_array, pot_sub_scalar, order, dn, mass
        )
        phi = gram_schmidt.normalise_wavefunction(phi, scalars[1])
        phi = gram_schmidt.orthogonalise_wavefunction(phi, w_store, n_lower)
        energy, norm2, v_inf, r2 = torch.stack(scalars).tolist()
    return Observables(energy=energy, norm2=norm2, v_infinity=v_inf, r2=r2), phi


def _host_field(phi: torch.Tensor, ext: int) -> np.ndarray:
    """ψ's work area on the host for the writers; a pair is fused to
    re + i·im (complex arrays exist only on the host)."""
    w = to_numpy(geometry.work_area(phi, ext))
    return w[0] + 1j * w[1] if phi.dim() == 4 else w


def stable_dt_bound(order: str, dn: float, mass: float) -> float:
    """Largest non-amplifying dt of the explicit kinetic update:
    2/λ_max with λ_max = (c₀ + 6Σ|cᵢ|)/(k·dn²·m). ThreePoint reduces to the
    reference's dn²·m/3 rule (src/config.rs:362-365)."""
    _offs, coeffs, center_c, k = geometry.stencil_coefficients(order)
    lam = (center_c + 6.0 * sum(abs(c) for c in coeffs)) / (k * dn * dn * mass)
    return 2.0 / lam


def eta(step: int, diff_old: float, diff_new: float, config: Config) -> Optional[float]:
    """Estimated ``screen_update`` cycles to convergence via point-slope fit
    of log₁₀(diff) (reference: src/grid.rs:254-283)."""
    if diff_new <= 0.0 or diff_old <= 0.0:
        return None
    x1 = float(step)
    y1 = math.log10(diff_new)
    rise = y1 - math.log10(diff_old)
    run = float(config.output.screen_update)
    if run == 0.0:
        return None
    m = rise / run
    if m == 0.0:
        return None
    x = (math.log10(config.tolerance) - y1) / m + x1
    if math.isfinite(x):
        estimate = math.floor((x - x1) / run)
        if estimate > 0.0:
            return estimate
    return None


def _select_initial_condition(
    config: Config, log, wnum: int, w_store: List[torch.Tensor], seed, device
) -> torch.Tensor:
    """IC preference: disk (current state, incl. ``_partial``) → previous
    converged state → configured generator (reference: src/grid.rs:60-100).
    A complex potential's ψ is an (re, im) pair (see ``models.initial``)."""
    from wafer_tpu.config import InitialCondition
    from wafer_tpu.io import readers

    if wnum > 0:
        try:
            wfn = readers.wavefunction(
                wnum,
                config.padded_size(),
                config.central_difference.bb,
                config.output.file_type,
                log,
                input_dir=config.input_dir,
            )
            log.info("Loaded (current) wavefunction %d from disk", wnum)
            if config.init_condition is not InitialCondition.FROM_FILE and wnum > config.wavenum:
                log.warning(
                    "Loaded a higher order wavefunction from disk although Initial "
                    "conditions are set to '%s'.",
                    config.init_condition.display(),
                )
            return initial.host_field(config, wfn, device)
        except errors.WaferError:
            log.info("Loaded wavefunction %d from memory as initial condition", wnum - 1)
            # seeded perturbation: an exact clone can Gram-Schmidt-cancel
            # bitwise to zero in f32 (see initial.perturb_clone)
            return initial.perturb_clone(config, w_store[wnum - 1], wnum, seed=seed)
    return initial.set_initial_conditions(config, log, seed=seed, device=device)


def _resolve_backend(config: Config, phi: torch.Tensor) -> str:
    """``"kernel"`` (the CUDA sweep; the pair sweep for a pair ``phi``) or
    ``"plain"`` (torch ops)."""
    if config.backend == "xla":
        return "plain"
    kernel_ok = phi.dtype == torch.float32 and phi.device.type == "cuda"
    if config.backend == "pallas":
        if not kernel_ok:
            raise errors.ConfigParseError(
                "backend: pallas requires precision f32 and a CUDA device"
            )
        return "kernel"
    return "kernel" if kernel_ok else "plain"


def _check_supported(config: Config) -> None:
    """Configurations the port does not run yet, each with the ROADMAP.md
    item that ports it."""
    if config.mesh.n_devices > 1:
        raise NotPortedError("a multi-device mesh", "A10")
    if config.multigrid:
        raise NotPortedError("multigrid", "A9")
    if (config.sync_update or 1) > 1:
        raise NotPortedError("sync_update > 1", "A9")
    if config.trace_dir:
        raise NotPortedError("trace_dir", "A11")
    if config.debug_nans:
        raise NotPortedError("debug_nans", "A11")


class _ChunkTimer:
    """Time of each evolve chunk: CUDA events on a GPU, read at the next
    measure (which synchronises on the chunk anyway), the host clock on
    the CPU."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._marks = None
        self.total = 0.0

    def _mark(self):
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        self._marks = [self._mark()]

    def stop(self) -> None:
        self._marks.append(self._mark())

    def read(self) -> Optional[float]:
        if self._marks is None:
            return None
        t0, t1 = self._marks
        self._marks = None
        if self._cuda:
            t1.synchronize()
            seconds = t0.elapsed_time(t1) / 1e3
        else:
            seconds = t1 - t0
        self.total += seconds
        return seconds


def solve(
    config: Config,
    log,
    debug_level: int,
    pots: Potentials,
    wnum: int,
    w_store: List[torch.Tensor],
    seed: Optional[int] = None,
    progress=None,
    ic_override: Optional[torch.Tensor] = None,
    *,
    device: torch.device,
) -> SolveResult:
    """Converge one state (reference ``solve``, src/grid.rs:50-246, and
    ``_solve_split`` for a complex potential, wafer_tpu/solver.py:1089).
    ``ic_override`` is an explicit padded initial ψ (an (re, im) pair for a
    complex potential) that bypasses the disk/previous-state/generator
    preference."""
    from wafer_tpu.io import writers
    from wafer_tpu.utils import terminal

    if seed is None:
        seed = config.seed
    if ic_override is not None:
        phi = ic_override
    else:
        phi = _select_initial_condition(config, log, wnum, w_store, seed, device)
    phi = phi.to(device=device, dtype=real_dtype(config)).contiguous()

    order = config.central_difference.value
    ext = config.central_difference.ext
    dn, dt, mass = config.grid.dn, config.grid.dt, config.mass
    su = config.output.screen_update
    backend = _resolve_backend(config, phi)
    log.info("Sweep backend for state %d: %s", wnum, backend)
    if config.precision == "f32" and config.tolerance < 1e-6:
        log.warning(
            "tolerance %.1e is below the f32 noise floor (~1e-6 relative; "
            "per-step normalisation injects rounding noise) — the run may "
            "never converge. Use precision: f64 for tighter tolerances.",
            config.tolerance,
        )

    r2_grid = geometry.r2_index_grid(
        config.work_size(), config.grid.size.as_tuple(), dtype=real_dtype(config), device=device
    )
    n_lower = wnum
    stacked = torch.stack(w_store[:n_lower]).contiguous() if n_lower > 0 else None

    # Delayed re-orthogonalisation (gate: delayed_gram_gate) bounds the
    # regrowth with the lowest stored-state energy: one Rayleigh quotient
    # per stored state, once per solve.
    delayed_gs = False
    dgs_state = DelayedGramState()
    e_lowest = None
    if n_lower > 0 and config.delayed_gram:
        e_ls = []
        for w in w_store[:n_lower]:
            obs_l, _w = _measure_and_prepare(
                w, pots.v, r2_grid, pots.pot_sub_array, pots.pot_sub_scalar,
                None, order, dn, mass, 0,
            )
            e_ls.append(obs_l.energy.real / obs_l.norm2)
        e_lowest = min(e_ls)

    split = config.potential.is_complex
    analytic = None
    b_int = None
    if backend == "kernel":
        kind = _ANALYTIC_KINDS.get(
            config.potential.real_counterpart if split else config.potential
        )
        if kind is not None:
            g = config.grid
            analytic = (
                kind, g.dn, g.dt, config.mass, g.size.x, g.size.y, g.size.z, config.sig,
                pots.v_shift,  # the gauge shift baked into the array a/b
            ) + ((config.absorb,) if split else ())
        else:
            b_int = geometry.work_area(pots.b, ext).contiguous()  # (Br, Bi) for a pair
        log.info(
            "Chunks run the CUDA %ssweep (%s B%s)",
            "pair " if split else "",
            "analytic" if analytic is not None else "streamed",
            f", {n_lower} stored-state streams" if n_lower else "",
        )

    # Per-step renormalisation guard (drift_guard): ψ's scale drifts by
    # exp(−(E − v_shift)·dt·screen_update) per chunk; past the f32 range's
    # e-fold budget the ground state is renormalised every step.
    per_step_norm = False
    efold_limit = 60.0 if config.precision == "f32" else 600.0

    def evolve(phi):
        """One ``screen_update`` chunk (reference ``evolve``,
        src/grid.rs:216). Delayed re-orthogonalisation runs the ground
        per-step-norm chunk without stored states and projects at the
        measure boundary (the gate engages only with stored states)."""
        psn = per_step_norm or delayed_gs
        store = None if delayed_gs else stacked
        n_store = 0 if store is None else n_lower
        if backend == "kernel" and split:
            return hopper_split.evolve_chunk_sc(
                phi, order, dt, dn, mass, su, analytic,
                per_step_norm=psn, store=store, b2=b_int,
            )
        if backend == "kernel":
            return hopper_stencil.evolve_chunk(
                phi, order, dt, dn, mass, su, analytic,
                per_step_norm=psn, store=store, b_int=b_int,
            )
        if split:
            lr = li = None
            if n_store:
                lr, li = store[:, 0], store[:, 1]
            pair = split_complex.evolve_chunk_sc(
                phi[0], phi[1], pots.a[0], pots.a[1], pots.b[0], pots.b[1], lr, li,
                order, dt, dn, mass, su, n_store, per_step_norm=psn,
            )
            return torch.stack(pair)
        return stencil.evolve_chunk(
            phi, pots.a, pots.b, store, order, dt, dn, mass, su, n_store,
            per_step_norm=psn,
        )

    terminal.print_observable_header(wnum)

    step = 0
    converged = False
    last_energy = float("inf")
    diff_old = float("inf")
    obs = None
    n_points = config.grid.size.x * config.grid.size.y * config.grid.size.z
    timer = _ChunkTimer(phi.device)

    while True:
        chunk_s = timer.read()
        if chunk_s:
            log.debug(
                "state %d step %d: %.0f steps/s, %.3g grid-point updates/s",
                wnum, step, su / chunk_s, n_points * su / chunk_s,
            )
        measured_delta = None
        if delayed_gs:
            # gate override input: the pre-projection admixture
            measured_delta = float(_max_rel_overlap(phi, stacked))
        obs, phi = _measure_and_prepare(
            phi, pots.v, r2_grid, pots.pot_sub_array, pots.pot_sub_scalar,
            stacked, order, dn, mass, n_lower,
        )
        if not (math.isfinite(obs.norm2) and obs.norm2 > 0.0):
            if obs.norm2 == 0.0:
                log.error(
                    "norm² is exactly zero at step %d: the state collapsed "
                    "to the zero array (a degenerate excited-state seed — "
                    "see models.initial.perturb_clone), not a dt "
                    "instability",
                    step,
                )
            raise errors.NonFiniteError("norm²", step)
        norm_energy = obs.energy / obs.norm2
        # engage only where dt is stable: past the bound, renormalising
        # would mask a divergent evolution the NonFinite guard must catch.
        # Both gates read Re(E): the drift rate is Re(E) − v_shift.
        if n_lower == 0 and dt <= stable_dt_bound(order, dn, mass):
            per_step_norm = drift_guard(
                per_step_norm, norm_energy.real, pots.v_shift, dt, su, efold_limit, log
            )
        if n_lower > 0 and e_lowest is not None:
            delayed_gs = dgs_state.update(
                norm_energy.real, e_lowest, dt, su, config.tolerance, log,
                measured_delta=measured_delta,
            )
        tau = step * dt

        # Snapshot lifecycle (reference: src/grid.rs:137-158): the
        # symmetrisation persists in the live ψ, the stale rescale only in
        # the written file (docs/PARITY.md divergence 8). A pair is
        # symmetrised per component and written as re + i·im.
        if config.output.snap_update is not None and step % config.output.snap_update == 0:
            phi = initial.symmetrise_wavefunction(config, phi)
            snap = gram_schmidt.normalise_wavefunction(phi, obs.norm2)
            log.info("Saving partially converged wavefunction %d to disk.", wnum)
            try:
                writers.wavefunction(
                    _host_field(snap, ext), wnum, False,
                    config.project_name, config.output.file_type,
                    output_root=config.output_root,
                )
            except errors.WaferError as exc:
                log.warning(
                    "Could not output partial wavefunction per snap_update request: %s", exc
                )

        diff = abs(norm_energy - last_energy)
        if diff < config.tolerance:
            if progress is not None:
                progress.finish()
            print(terminal.print_measurements(tau, diff, obs))
            writers.finalise_measurement(
                obs, wnum, float(config.grid.size.x), config.project_name,
                config.output.file_type, output_root=config.output_root,
            )
            if config.output.snap_update is not None:
                log.info("Removing partially converged wavefunction %d from disk.", wnum)
                try:
                    writers.remove_partial(
                        wnum, config.project_name, config.output.file_type,
                        output_root=config.output_root,
                    )
                except errors.WaferError as exc:
                    log.warning(
                        "The temporary wavefunction_%d_partial%s file could not be removed "
                        "from the output directory: %s",
                        wnum, config.output.file_type.extension, exc,
                    )
            converged = True
            break
        last_energy = norm_energy

        if progress is not None:
            estimate = eta(step, diff_old, diff, config)
            if estimate is not None:
                cycles_done = step / su
                percent = math.floor(100.0 - (estimate / (cycles_done + estimate) * 100.0))
                if math.isfinite(percent):
                    progress.set_position(int(percent))
            progress.set_message(terminal.print_measurements(tau, diff, obs))

        if config.max_steps is not None and step > config.max_steps:
            break

        timer.start()
        phi = evolve(phi)
        timer.stop()
        diff_old = diff
        step += su

    if config.output.save_wavefns:
        log.info("Saving wavefunction %d to disk", wnum)
        try:
            writers.wavefunction(
                _host_field(phi, ext), wnum, converged,
                config.project_name, config.output.file_type,
                output_root=config.output_root,
            )
        except errors.WaferError as exc:
            log.warning("Could not write wavefunction to disk: %s", exc)

    if not converged:
        raise errors.MaxStepError()

    log.info("Calculation Converged")
    w_store.append(phi)
    return SolveResult(
        wnum=wnum, converged=converged, observables=obs, steps=step, phi=phi,
        chunk_seconds=timer.total,
    )


def drift_guard(
    per_step_norm: bool,
    energy_real: float,
    v_shift: float,
    dt: float,
    su: int,
    efold_limit: float,
    log,
) -> bool:
    """Re-evaluate the f32 scale-drift guard from the freshest energy
    (PARITY divergence 7): the drift is ``2·|E − v_shift|·dt·su`` norm²
    e-folds per chunk; engage per-step renormalisation above
    ``efold_limit`` and disengage below half of it (hysteresis)."""
    drift = 2.0 * abs(energy_real - v_shift) * dt * su
    if not per_step_norm and drift > efold_limit:
        log.info(
            "Large potential offset (≈%.0f norm² e-folds per chunk): "
            "renormalising the ground state every step",
            drift,
        )
        return True
    if per_step_norm and drift < 0.5 * efold_limit:
        log.info(
            "Potential-offset drift fell to ≈%.0f norm² e-folds per "
            "chunk: resuming per-chunk normalisation",
            drift,
        )
        return False
    return per_step_norm


# δ₀ is the rounding-level post-projection residual budget (measured
# ≤ ~4e-7 on the reference's f32 paths); a measured pre-projection
# admixture above the fixed release threshold 100·δ₀ releases the gate.
_DGS_DELTA0 = 1e-6
_DGS_RELEASE_DELTA = 100.0 * _DGS_DELTA0


class DelayedGramState:
    """Delayed-GS gate with the release cooldown and the learned δ₀
    (reference: wafer_tpu/solver.py DelayedGramState). An admixture-
    triggered release starts a short cooldown and back-solves the
    effective per-chunk seed ``δ₀ = measured/exp(ΔE·dt·su)``; a ×0.7 decay
    per released boundary re-admits delayed mode after a transient."""

    COOLDOWN_CHUNKS = 4
    DELTA0_DECAY = 0.7

    def __init__(self) -> None:
        self.engaged = False
        self._cooldown = 0
        self.delta0 = _DGS_DELTA0

    def update(
        self,
        energy_now: float,
        e_lowest: float,
        dt: float,
        su: int,
        tolerance: float,
        log,
        measured_delta: Optional[float] = None,
    ) -> bool:
        was = self.engaged
        if not was and self.delta0 > _DGS_DELTA0:
            self.delta0 = max(_DGS_DELTA0, self.delta0 * self.DELTA0_DECAY)
        if self._cooldown > 0:
            self._cooldown -= 1
            self.engaged = False
        else:
            self.engaged = delayed_gram_gate(
                self.engaged, energy_now, e_lowest, dt, su, tolerance, log,
                measured_delta=measured_delta, delta0=self.delta0,
            )
        if (
            was and not self.engaged
            and measured_delta is not None
            and measured_delta > _DGS_RELEASE_DELTA
        ):
            self._cooldown = self.COOLDOWN_CHUNKS
            de = max(0.0, energy_now - e_lowest)
            amp = math.exp(min(de * dt * su, 700.0))
            learned = measured_delta / amp
            if learned > self.delta0:
                self.delta0 = learned
                log.info(
                    "Delayed re-orthogonalisation: learned per-chunk "
                    "regrowth seed %.2e (measured %.2e / amplification "
                    "%.3g) — the gate re-engages only when its projected "
                    "bias clears tolerance again",
                    learned, measured_delta, amp,
                )
        return self.engaged


def delayed_gram_gate(
    engaged: bool,
    energy_now: float,
    e_lowest: float,
    dt: float,
    su: int,
    tolerance: float,
    log,
    measured_delta: Optional[float] = None,
    delta0: float = _DGS_DELTA0,
) -> bool:
    """Numerics gate for delayed re-orthogonalisation (reference per-step
    cadence: src/grid.rs:674-681; docs/PARITY.md divergence 12).

    After one chunk without in-chunk projections the lower-state admixture
    is ``δ = δ₀·exp(ΔE·dt·su)`` with ``ΔE = E_t − min(E_l)``, and the
    measured-energy bias at the next boundary is ``δ²·ΔE``. Delay engages
    while that bias is below tolerance/100 and releases above
    tolerance/10. A measured pre-projection admixture above the fixed
    release threshold ``_DGS_RELEASE_DELTA`` releases it whatever the
    model says."""
    de = max(0.0, energy_now - e_lowest)
    bias = delta0 * delta0 * math.exp(min(2.0 * de * dt * su, 700.0)) * de
    if engaged and measured_delta is not None and measured_delta > _DGS_RELEASE_DELTA:
        log.info(
            "Delayed re-orthogonalisation released: measured lower-state "
            "admixture %.2e exceeds the %.0e release threshold — resuming "
            "per-step Gram-Schmidt",
            measured_delta, _DGS_RELEASE_DELTA,
        )
        return False
    if not engaged and bias < tolerance / 100.0:
        log.info(
            "Delayed re-orthogonalisation engaged: projected regrowth bias "
            "%.2e per chunk << tolerance %.1e (dE=%.3g); excited chunks run "
            "the per-step-norm ground ladder, projecting at measure "
            "boundaries",
            bias, tolerance, de,
        )
        return True
    if engaged and bias > tolerance / 10.0:
        log.info(
            "Delayed re-orthogonalisation released: regrowth bias %.2e "
            "approaches tolerance %.1e — resuming per-step Gram-Schmidt",
            bias, tolerance,
        )
        return False
    return engaged


def _warn_marginal_dt(config: Config, log) -> None:
    """Warn when dt sits within 2% of the explicit stability bound, where
    the zone-corner (checkerboard) mode is undamped for any potential."""
    bound = stable_dt_bound(config.central_difference.value, config.grid.dn, config.mass)
    if config.grid.dt > 0.98 * bound:
        log.warning(
            "dt=%g is at/near the explicit stability bound %.6g: the "
            "zone-corner (checkerboard) mode is undamped there "
            "(amplification 1 for any potential), so long imaginary-time "
            "runs drift toward the lattice mode instead of the ground "
            "state. Prefer dt <= %.6g (95%% of the bound).",
            config.grid.dt, bound, 0.95 * bound,
        )


def run(
    config: Config,
    log=None,
    debug_level: int = 3,
    seed: Optional[int] = None,
    progress_factory=None,
    *,
    device: torch.device,
) -> List[SolveResult]:
    """Solve all requested states on ``device`` (reference ``run``,
    src/grid.rs:31-47). Configurations the port does not run yet raise
    :class:`~wafer_torch.errors.NotPortedError`."""
    log = log or logging.getLogger("wafer")
    _check_supported(config)
    _warn_marginal_dt(config, log)
    return _run_single(config, log, debug_level, seed, progress_factory, device=device)


def _run_single(
    config: Config,
    log,
    debug_level: int = 3,
    seed: Optional[int] = None,
    progress_factory=None,
    ic_overrides=None,
    *,
    device: torch.device,
) -> List[SolveResult]:
    """Load potentials, preload lower states when restarting, then solve
    each state in order. ``ic_overrides``: optional per-state padded
    initial ψ."""
    pots = potentials_mod.load_arrays(config, log, device=device)

    w_store: List[torch.Tensor] = []
    if config.wavenum > 0:
        from wafer_tpu.io import readers

        w_store.extend(
            initial.host_field(config, w, device)
            for w in readers.load_wavefunctions(config, log)
        )

    log.info("Starting calculation")
    results = []
    for wnum in range(config.wavenum, config.wavemax + 1):
        progress = progress_factory(wnum) if progress_factory is not None else None
        results.append(
            solve(
                config, log, debug_level, pots, wnum, w_store, seed=seed,
                progress=progress,
                ic_override=ic_overrides.get(wnum) if ic_overrides else None,
                device=device,
            )
        )
    return results

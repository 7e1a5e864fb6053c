"""Convergence loop (counterpart of ``wafer_tpu/solver.py``; reference
``grid::run``/``solve``, src/grid.rs:31-246).

``run`` → ``_run_single`` → ``solve``, or with a ``multigrid`` schedule
``run`` → ``_run_multigrid`` → ``_run_single`` at each level, coarse to
fine. The CUDA sweep runs at every grid size: the reference's large-grid
dispatch (blocked resident, K-fused and GS-fused kernels) has no picker
here. Each ``screen_update`` chunk runs on
the device without a host synchronisation; the host enqueues each
boundary's measure behind the chunk that is still running and reads the
four observable scalars once per chunk to drive the convergence test, the
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

import dataclasses
import logging
import math
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from wafer_torch import chunk_graph, errors, geometry
from wafer_torch.batch import BatchRunner, pick_batch_k
from wafer_torch.config import (
    Config, Grid, Index3, InitialCondition, MeshConfig, require_port_config,
)
from wafer_torch.io import readers, writers
from wafer_torch.io.trilerp import trilerp_resize
from wafer_torch.models import initial, potentials as potentials_mod
from wafer_torch.models.potentials import Potentials
from wafer_torch.ops import gram_schmidt, hopper_split, hopper_stencil, split_complex, stencil
from wafer_torch.ops.observables import Observables, compute_observables_device
from wafer_torch.parallel import distributed
from wafer_torch.utils import terminal
from wafer_torch.utils.host import host_work_area, resolve_device
from wafer_torch.utils.spans import span

@dataclass
class SolveResult:
    """Outcome of one state's convergence loop. ``phi`` is the (re, im)
    pair for a complex potential. ``chunk_seconds`` is the time spent in
    evolve chunks: CUDA-event time on a GPU, host time on the CPU; under
    ``sync_update`` batching it includes the batches' measures. ``batch``
    counts a batched state's batches, chunks, idle chunks (run after the
    device's verdict) and CUDA-graph captures (``BatchRunner.stats``); None
    for the per-chunk loop. ``graphs`` holds the chunks' route and, on the
    kernels, the state's segment captures, their host ms and replays
    (``ChunkGraphs.take_stats``), or the route alone. ``gate`` counts the
    delayed-GS gate of an excited state: its chunks run delayed (no
    stored-state streams, projected at the boundary) and with the stored
    states, and the gate's engagements and releases
    (:meth:`DelayedGramState.counts`); None where the gate does not run (a
    ground state, ``delayed_gram: false``, ``sync_update`` batching)."""

    wnum: int
    converged: bool
    observables: Observables
    steps: int
    phi: torch.Tensor
    chunk_seconds: float = 0.0
    batch: Optional[dict] = None
    graphs: Optional[dict] = None
    gate: Optional[dict] = None


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


def _measure_device(
    phi, v, r2_grid, pot_sub_array, pot_sub_scalar, w_store, order, dn, mass, n_lower
) -> Tuple[tuple, torch.Tensor]:
    """Observables of the current ψ as 0-d tensors on its device (energy,
    or Re E and Im E for a pair, then norm², V∞, ⟨r²⟩), then normalise,
    then orthogonalise (reference loop head: src/grid.rs:127-135), with no
    host read: a batch's measure. A pair ``phi`` (with pair ``v`` and
    ``w_store``) takes the split measure."""
    if phi.dim() == 4:
        store_r = store_i = None
        if n_lower:
            store_r, store_i = w_store[:, 0], w_store[:, 1]
        sums, pair = split_complex.measure_and_prepare_sc(
            phi[0], phi[1], v[0], v[1], r2_grid, pot_sub_array, pot_sub_scalar,
            store_r, store_i, order, dn, mass, n_lower,
        )
        return tuple(sums), torch.stack(pair)
    scalars = compute_observables_device(
        phi, v, r2_grid, pot_sub_array, pot_sub_scalar, order, dn, mass
    )
    phi = gram_schmidt.normalise_wavefunction(phi, scalars[1])
    phi = gram_schmidt.orthogonalise_wavefunction(phi, w_store, n_lower)
    return tuple(scalars), phi


def read_observables(sums) -> Observables:
    """A measure's sums (:func:`_measure_device`) as observables: 0-d
    tensors, read on the host in one transfer, or the floats of such a
    read; five sums are a pair's, with a complex energy."""
    vals = list(sums)
    if torch.is_tensor(vals[0]):
        vals = torch.stack(vals).tolist()
    energy = complex(vals[0], vals[1]) if len(vals) == 5 else vals[0]
    norm2, v_inf, r2 = vals[-3:]
    return Observables(energy=energy, norm2=norm2, v_infinity=v_inf, r2=r2)


def read_boundary(sums, delta=None) -> Tuple[Observables, Optional[float]]:
    """A chunk boundary's numbers read on the host in one transfer: the
    measure's sums and, with the delayed-GS gate engaged, ``delta``, the
    admixture measured before the projection (None without it)."""
    if delta is None:
        return read_observables(sums), None
    *vals, measured = torch.stack([*sums, delta]).tolist()
    return read_observables(vals), measured


def _measure_and_prepare(
    phi, v, r2_grid, pot_sub_array, pot_sub_scalar, w_store, order, dn, mass, n_lower
) -> Tuple[Observables, torch.Tensor]:
    """:func:`_measure_device` with the observables read on the host in
    one transfer (the per-chunk loop's measure)."""
    sums, phi = _measure_device(
        phi, v, r2_grid, pot_sub_array, pot_sub_scalar, w_store, order, dn, mass, n_lower
    )
    return read_observables(sums), phi


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
    """A process of a multi-process run (``WAFER_COORDINATOR``; the run is
    started here when the CLI has not started it) holds only its shards of
    a mesh: the configuration must name a multi-device one. Checked before
    any solve, so a multigrid run raises before its coarse levels."""
    if distributed.maybe_initialize_distributed() and config.mesh.n_devices <= 1:
        raise errors.ConfigParseError(
            f"a multi-process run (WAFER_COORDINATOR, {distributed.process_count()} "
            "processes) needs a multi-device mesh in the configuration: each process "
            "solves only its own shards"
        )


def _has_nan(phi) -> bool:
    """NaN anywhere in ψ (a tensor, or a list of shard blocks), read on the
    host in one transfer."""
    if isinstance(phi, torch.Tensor):
        return bool(torch.isnan(phi).any())
    dev = phi[0].device
    return bool(torch.stack([torch.isnan(b).any().to(dev) for b in phi]).any())


def _check_nans(obs: Optional[Observables], phi, what: str, step: int) -> None:
    """``debug_nans``: raise :class:`~wafer_torch.errors.NonFiniteError` at
    the first NaN among the observables and ψ (``what`` names ψ's place in
    the loop; ψ None checks the observables alone). NaN only, as
    ``jax_debug_nans``; the norm² guard still catches Inf."""
    if obs is not None:
        for name, val in (("energy", obs.energy), ("norm²", obs.norm2),
                          ("V∞", obs.v_infinity), ("⟨r²⟩", obs.r2)):
            if math.isnan(complex(val).real) or math.isnan(complex(val).imag):
                raise errors.NonFiniteError(name, step)
    if phi is not None and _has_nan(phi):
        raise errors.NonFiniteError(what, step)


class _ChunkTimer:
    """Time of each evolve chunk, or of a batch's iterations (their
    measures included, their CUDA-graph captures not): CUDA events on a
    GPU, read once the next boundary's measure is enqueued or at the batch's
    read (which synchronise on the chunk anyway), the host clock on the
    CPU. ``start``/``stop`` pairs add up until ``read``."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._marks = []
        self.total = 0.0

    def _mark(self):
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        self._marks.append(self._mark())

    def stop(self) -> None:
        self._marks.append(self._mark())

    def read(self) -> Optional[float]:
        if not self._marks:
            return None
        marks, self._marks = self._marks, []
        seconds = 0.0
        for t0, t1 in zip(marks[::2], marks[1::2]):
            if self._cuda:
                t1.synchronize()
                seconds += t0.elapsed_time(t1) / 1e3
            else:
                seconds += t1 - t0
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
    graphs: Optional[chunk_graph.ChunkGraphs] = None,
) -> SolveResult:
    """Converge one state (reference ``solve``, src/grid.rs:50-246, and
    ``_solve_split`` for a complex potential, wafer_tpu/solver.py:1089).
    ``ic_override`` is an explicit padded initial ψ (an (re, im) pair for a
    complex potential) that bypasses the disk/previous-state/generator
    preference. ``graphs``: the run's bound chunks (:func:`chunk_graphs`),
    which the kernel chunks take; the chunks that hold this state's stored
    states or streamed B are released when it ends. Without it each chunk
    binds its own launchers."""
    require_port_config(config)
    if seed is None:
        seed = config.seed
    # a state's set-up, from its initial condition to its first measure
    with span("wafer.state_setup"):
        with span("wafer.initial_condition"):
            if ic_override is not None:
                phi = ic_override
            else:
                phi = _select_initial_condition(config, log, wnum, w_store, seed, device)
            phi = phi.to(device=device, dtype=config.real_dtype).contiguous()

        order = config.central_difference.value
        ext = config.central_difference.ext
        dn, dt, mass = config.grid.dn, config.grid.dt, config.mass
        su = config.output.screen_update
        backend = _resolve_backend(config, phi)
        log.info("Sweep backend for state %d: %s", wnum, backend)
        _warn_tolerance(config, log)

        r2_grid = geometry.r2_index_grid(
            config.work_size(), config.grid.size.as_tuple(), dtype=config.real_dtype, device=device
        )
        n_lower = wnum
        stacked = torch.stack(w_store[:n_lower]).contiguous() if n_lower > 0 else None

        # Delayed re-orthogonalisation (gate: delayed_gram_gate) bounds the
        # regrowth with the lowest stored-state energy: one Rayleigh quotient
        # per stored state, once per solve; inactive under batching.
        e_lowest = None
        if n_lower > 0 and config.delayed_gram and batching(config):
            log_delayed_gram_inactive(log)
        if n_lower > 0 and config.delayed_gram and not batching(config):
            e_ls = []
            for w in w_store[:n_lower]:
                obs_l, _w = _measure_and_prepare(
                    w, pots.v, r2_grid, pots.pot_sub_array, pots.pot_sub_scalar,
                    None, order, dn, mass, 0,
                )
                e_ls.append(obs_l.energy.real / obs_l.norm2)
            e_lowest = min(e_ls)

        split = config.potential.is_complex
        # the chunks' copy of the stored states, bf16 by the reference's rule
        # (cast once a solve; `stacked` itself otherwise): the measure and the
        # admixture gate keep the f32 `stacked`
        stream_dtype = hopper_stencil.exc_stream_dtype(config, n_lower, backend == "kernel")
        stacked_stream = stacked if stacked is None else stacked.to(stream_dtype)
        analytic = None
        b_int = None
        if backend == "kernel":
            analytic = hopper_stencil.analytic_params(config, pots.v_shift)
            if analytic is None:
                b_int = geometry.work_area(pots.b, ext).contiguous()  # (Br, Bi) for a pair
            log.info(
                "Chunks run the CUDA %ssweep (%s B%s)",
                "pair " if split else "",
                "analytic" if analytic is not None else "streamed",
                f", {n_lower} stored-state streams"
                + (" in bf16" if stream_dtype == torch.bfloat16 else "") if n_lower else "",
            )

    def measure_device(phi):
        return _measure_device(
            phi, pots.v, r2_grid, pots.pot_sub_array, pots.pot_sub_scalar,
            stacked, order, dn, mass, n_lower,
        )

    def evolve(phi, per_step_norm, delayed_gs, done=None):
        """One ``screen_update`` chunk (reference ``evolve``,
        src/grid.rs:216). Delayed re-orthogonalisation runs the ground
        per-step-norm chunk without stored states and projects at the
        measure boundary (the gate engages only with stored states).
        ``done``: a batch's flag, which the kernels read (the plain ops
        compute whatever it holds)."""
        psn = per_step_norm or delayed_gs
        store = None if delayed_gs else stacked_stream
        n_store = 0 if store is None else n_lower
        if backend == "kernel" and split:
            return hopper_split.evolve_chunk_sc(
                phi, order, dt, dn, mass, su, analytic,
                per_step_norm=psn, store=store, b2=b_int, done=done, graphs=graphs,
            )
        if backend == "kernel":
            return hopper_stencil.evolve_chunk(
                phi, order, dt, dn, mass, su, analytic,
                per_step_norm=psn, store=store, b_int=b_int, done=done, graphs=graphs,
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

    timer = _ChunkTimer(phi.device)
    batch = batch_runner(config, log, measure_device, evolve, n_lower, [phi.device],
                         stream_dtype=stream_dtype)
    gate = None if e_lowest is None else DelayedGramState()

    def release():
        if batch is not None:
            batch.close()
        if graphs is not None:
            graphs.release(stacked_stream, b_int)

    try:
        # a converged state is released in its end (``wafer.state_finish``)
        obs, step, phi = converge(
            config, log, wnum, phi, measure_device, evolve,
            overlap=lambda phi: _max_rel_overlap(phi, stacked),
            e_lowest=e_lowest, v_shift=pots.v_shift, progress=progress, timer=timer,
            batch=batch, on_finish=release, gate=gate,
        )
    except BaseException:
        release()
        raise
    w_store.append(phi)
    counts = log_gate(log, wnum, step, gate)
    return SolveResult(
        wnum=wnum, converged=True, observables=obs, steps=step, phi=phi,
        chunk_seconds=timer.total, batch=None if batch is None else batch.stats(),
        graphs=graph_stats(graphs, [phi.device], backend == "kernel"), gate=counts,
    )


def log_gate(log, wnum: int, steps: int, gate: Optional["DelayedGramState"]) -> Optional[dict]:
    """A converged state's delayed-GS counts (None without a gate), logged
    beside its steps."""
    if gate is None:
        return None
    counts = gate.counts()
    log.info(
        "State %d converged in %d steps: %d delayed-GS and %d stored-state chunks, "
        "the gate engaged %d and released %d times",
        wnum, steps, counts["delayed_chunks"], counts["stored_chunks"],
        counts["engaged"], counts["released"],
    )
    return counts


def chunk_graphs(config: Config, log, devices, processes: int = 1,
                 kernel: bool = True) -> Optional[chunk_graph.ChunkGraphs]:
    """A run's bound chunks (:class:`~wafer_torch.chunk_graph.ChunkGraphs`)
    on the route ψ's layout takes (:func:`chunk_graph.route`: graphs where
    ψ lies on one CUDA device of one process, eager bound launchers where it
    spans several devices or processes), chosen once and logged; None on
    the plain ops. ``devices``: this process's devices of ψ; ``kernel``:
    whether the chunks take the kernels. The caller closes it when the run
    ends."""
    chosen = chunk_graph.route(devices, processes, kernel)
    log.info("Evolve chunks run %s", chunk_graph.describe(chosen, devices, processes))
    return None if chosen == "plain" else chunk_graph.ChunkGraphs(chosen)


def graph_stats(graphs: Optional[chunk_graph.ChunkGraphs], devices, kernel: bool) -> dict:
    """A state's record of its chunks' route (:attr:`SolveResult.graphs`):
    without ``graphs`` the kernel chunks bind their launchers each chunk
    (``eager``)."""
    if graphs is not None:
        return graphs.take_stats()
    chosen = chunk_graph.route(devices, 1, kernel)
    return {"route": "eager" if chosen == "graph" else chosen}


def batching(config: Config) -> bool:
    """Whether ``sync_update`` batches chunks (the per-chunk loop at 1 or
    without the key)."""
    return (config.sync_update or 1) > 1


def log_delayed_gram_inactive(log) -> None:
    """The reference's note that batching turns the delayed-GS gate off
    (wafer_tpu/solver.py:407-413)."""
    log.info(
        "delayed_gram is inactive under sync_update batching: the "
        "gate re-evaluates per measure (and reads a per-boundary "
        "admixture), which the device-batched scan cannot replay "
        "without breaking its exact per-chunk-equivalence contract"
    )


def batch_runner(config: Config, log, measure_device, evolve, n_lower: int,
                 devices, processes: int = 1,
                 stream_dtype: torch.dtype = torch.float32) -> Optional[BatchRunner]:
    """The state's :class:`~wafer_torch.batch.BatchRunner` under
    ``sync_update > 1`` (None otherwise): CUDA graphs when ψ lives on one
    CUDA device of one process, eager iterations when it spans several
    devices or ``processes`` (no graph captures a collective) or lives on
    the CPU, the route chosen here and logged. ``devices``: this process's
    devices of ψ; ``stream_dtype``: the chunks' stored-state streams."""
    if not batching(config):
        return None
    devs = set(devices)
    graphs = processes == 1 and len(devs) == 1 and next(iter(devs)).type == "cuda"
    if graphs:
        route = "as a CUDA graph of one chunk iteration"
    elif processes > 1:
        route = f"eagerly (ψ spans {processes} processes)"
    elif len(devs) > 1:
        route = f"eagerly (ψ spans {len(devs)} devices)"
    else:
        route = "eagerly (no CUDA device)"
    log.info("sync_update %d: batches of up to %d chunks a host read, run %s",
             config.sync_update, config.sync_update, route)
    return BatchRunner(measure_device, evolve, config.tolerance,
                       pair=config.potential.is_complex, n_lower=n_lower, graphs=graphs,
                       stream_dtype=stream_dtype)


def _warn_tolerance(config: Config, log) -> None:
    if config.precision == "f32" and config.tolerance < 1e-6:
        log.warning(
            "tolerance %.1e is below the f32 noise floor (~1e-6 relative; "
            "per-step normalisation injects rounding noise) — the run may "
            "never converge. Use precision: f64 for tighter tolerances.",
            config.tolerance,
        )


def converge(
    config: Config,
    log,
    wnum: int,
    phi,
    measure_device,
    evolve,
    *,
    overlap,
    e_lowest: Optional[float],
    v_shift: float,
    progress,
    timer: "_ChunkTimer",
    gather=lambda phi: phi,
    scatter=lambda padded: padded,
    batch: Optional[BatchRunner] = None,
    on_finish=None,
    gate: Optional["DelayedGramState"] = None,
):
    """The convergence loop of one state (reference src/grid.rs:126-246),
    shared by the single-device solve and the sharded one
    (``parallel/solver_sharded``): measure, guards and gates, snapshots and
    the convergence test every ``screen_update`` steps, one evolve chunk in
    between. ``measure_device(phi)`` returns (the observables' sums as
    0-d tensors, normalised and orthogonalised ψ) with no host read,
    ``evolve(phi, per_step_norm, delayed_gs)`` the next ψ,
    ``overlap(phi)`` the delayed-GS gate's measured admixture as a 0-d
    tensor; ``gate`` the :class:`DelayedGramState` the loop drives and
    counts into (a fresh one when None);
    ``gather``/``scatter`` carry ψ to and from the padded global array
    (the identity on one device) for snapshots and the saved file.
    Returns (Observables, steps, ψ); raises MaxStepError past
    ``max_steps``.

    The phases run inside spans (:func:`~wafer_torch.utils.spans.span`),
    which name them in a profiler's trace: ``wafer.measure`` (the
    measure and, after a chunk run with the delayed-GS gate engaged, the
    admixture in ``wafer.admixture``, enqueued on the stream behind the
    chunk that is still running),
    ``wafer.chunk_wait`` (the host waiting for the last chunk to end),
    ``wafer.host_read`` (the boundary's one read of the measure's sums and
    the admixture: :func:`read_boundary`), ``wafer.boundary`` (guards, gates,
    snapshots, the convergence test and the progress text),
    ``wafer.evolve_chunk``, ``wafer.state_finish`` (the converged state's
    files, then ``on_finish()``), ``wafer.snapshot``,
    ``wafer.write_wavefunction`` and ``wafer.batch``. No span is open while
    ``progress`` runs, since its ``finish`` may end a span of the caller's
    that holds the state. With ``config.debug_nans`` ψ is checked for NaN
    after every chunk and the observables and ψ after every measure (one
    host read each), raising :class:`~wafer_torch.errors.NonFiniteError`
    at the first.

    With ``batch`` (``sync_update > 1``) the loop asks
    :func:`~wafer_torch.batch.pick_batch_k` at each boundary how many
    chunks the device may run, and from the second chunk on runs that many
    per host read (reference wafer_tpu/solver.py:771-1060): the batch's
    rows are replayed through this loop, one per chunk, with the device's
    verdict in place of ``diff < tolerance`` and ψ taken as the converged
    row's measured ψ, so the printed rows, the guards, snapshots and
    ``max_steps`` are the per-chunk loop's. The drift guard's verdict
    takes effect at the next batch, as in the reference. With
    ``debug_nans`` each replayed row is checked, the converged ψ at its
    row and the batch's last ψ when the loop takes it up.

    In a multi-process run every process runs this loop on the same totals
    and so takes the same branches; ``gather`` and ``scatter`` run on every
    process, and only process 0 writes files."""
    ext = config.central_difference.ext
    writes = distributed.process_index() == 0
    order = config.central_difference.value
    dn, dt, mass = config.grid.dn, config.grid.dt, config.mass
    su = config.output.screen_update
    n_lower = wnum
    delayed_gs = False
    dgs_state = DelayedGramState() if gate is None else gate

    # Per-step renormalisation guard (drift_guard): ψ's scale drifts by
    # exp(−(E − v_shift)·dt·screen_update) per chunk; past the f32 range's
    # e-fold budget the ground state is renormalised every step.
    per_step_norm = False
    efold_limit = 60.0 if config.precision == "f32" else 600.0

    terminal.print_observable_header(wnum)

    step = 0
    converged = False
    last_energy = float("inf")
    diff_old = float("inf")
    obs = None
    n_points = config.grid.size.x * config.grid.size.y * config.grid.size.z
    k_sync = (config.sync_update or 1) if batch is not None else 1
    rows_pending: list = []
    batch_phi = batch_conv = None

    while True:
        measured_delta = None
        dev_done = None
        k = 0 if rows_pending else pick_batch_k(
            step, k_sync, su, config.output.snap_update, config.max_steps)
        if k == 1:
            # enqueued behind the chunk that is still running; read once it ends
            with span("wafer.measure"):
                delta = None
                if delayed_gs:
                    with span("wafer.admixture"):
                        # gate override input: the pre-projection admixture
                        delta = overlap(phi)
                sums, phi = measure_device(phi)
        with span("wafer.chunk_wait"):
            chunk_s = timer.read()
        if chunk_s:
            log.debug(
                "state %d step %d: %.0f steps/s, %.3g grid-point updates/s",
                wnum, step, su / chunk_s, n_points * su / chunk_s,
            )
        if rows_pending:
            obs, dev_done = rows_pending.pop(0)
            if config.debug_nans:
                _check_nans(obs, None, "ψ after the measure", step)
        elif k > 1:
            with span("wafer.batch"):
                out = batch.run(phi, last_energy, k, per_step_norm, timer)
            batch_s = timer.read()
            log.debug(
                "state %d step %d: device batch of %d chunks (%d idle) in %.3g s, "
                "%.3g grid-point updates/s", wnum, step, k, out.idle, batch_s or 0.0,
                n_points * su * (k - out.idle) / batch_s if batch_s else 0.0,
            )
            rows_pending = list(out.rows)
            batch_phi, batch_conv = out.phi, out.conv
            continue
        else:
            with span("wafer.host_read"):
                obs, measured_delta = read_boundary(sums, delta)
            if config.debug_nans:
                _check_nans(obs, phi, "ψ after the measure", step)
        with span("wafer.boundary"):
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
                    per_step_norm, norm_energy.real, v_shift, dt, su, efold_limit, log
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
                with span("wafer.snapshot"):
                    sym = initial.symmetrise_wavefunction(config, gather(phi))
                    phi = scatter(sym)
                    snap = gram_schmidt.normalise_wavefunction(sym, obs.norm2)
                    if writes:
                        log.info("Saving partially converged wavefunction %d to disk.", wnum)
                        try:
                            writers.wavefunction(
                                host_work_area(snap, ext), wnum, False,
                                config.project_name, config.output.file_type,
                                output_root=config.output_root,
                            )
                        except errors.WaferError as exc:
                            log.warning(
                                "Could not output partial wavefunction per snap_update "
                                "request: %s", exc,
                            )

            diff = abs(norm_energy - last_energy)
            converged = dev_done if dev_done is not None else diff < config.tolerance
            if converged and dev_done is not None:
                phi = batch_conv  # the measured ψ of this row
                rows_pending.clear()
                batch_phi = batch_conv = None
                if config.debug_nans:
                    _check_nans(None, phi, "ψ after the measure", step)
            percent = message = None
            if not converged:
                last_energy = norm_energy
                if progress is not None:
                    estimate = eta(step, diff_old, diff, config)
                    if estimate is not None:
                        cycles_done = step / su
                        percent = math.floor(
                            100.0 - (estimate / (cycles_done + estimate) * 100.0))
                    message = terminal.print_measurements(tau, diff, obs)

        if converged:
            if progress is not None:
                progress.finish()
            with span("wafer.state_finish"):
                print(terminal.print_measurements(tau, diff, obs))
                if writes:
                    writers.finalise_measurement(
                        obs, wnum, float(config.grid.size.x), config.project_name,
                        config.output.file_type, output_root=config.output_root,
                    )
                if writes and config.output.snap_update is not None:
                    log.info("Removing partially converged wavefunction %d from disk.", wnum)
                    try:
                        writers.remove_partial(
                            wnum, config.project_name, config.output.file_type,
                            output_root=config.output_root,
                        )
                    except errors.WaferError as exc:
                        log.warning(
                            "The temporary wavefunction_%d_partial%s file could not be "
                            "removed from the output directory: %s",
                            wnum, config.output.file_type.extension, exc,
                        )
                if on_finish is not None:
                    on_finish()
            break

        if progress is not None:
            if percent is not None and math.isfinite(percent):
                progress.set_position(int(percent))
            progress.set_message(message)

        if config.max_steps is not None and step > config.max_steps:
            break

        if rows_pending or batch_phi is not None:
            # a batch's chunk: its next row, or after its last the evolved ψ
            diff_old = diff
            step += su
            if not rows_pending:
                phi, batch_phi, batch_conv = batch_phi, None, None
                if config.debug_nans:
                    _check_nans(None, phi, "ψ after the evolve chunk", step)
            continue

        timer.start()
        with span("wafer.evolve_chunk"):
            phi = evolve(phi, per_step_norm, delayed_gs)
        timer.stop()
        dgs_state.ran(delayed_gs)
        diff_old = diff
        step += su
        if config.debug_nans:
            _check_nans(None, phi, "ψ after the evolve chunk", step)

    if config.output.save_wavefns:
        with span("wafer.write_wavefunction"):
            field = gather(phi)
            if writes:
                log.info("Saving wavefunction %d to disk", wnum)
                try:
                    writers.wavefunction(
                        host_work_area(field, ext), wnum, converged,
                        config.project_name, config.output.file_type,
                        output_root=config.output_root,
                    )
                except errors.WaferError as exc:
                    log.warning("Could not write wavefunction to disk: %s", exc)

    if not converged:
        raise errors.MaxStepError()

    log.info("Calculation Converged")
    return obs, step, phi


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
    per released boundary re-admits delayed mode after a transient. It
    counts the chunks run delayed and with the stored states
    (:meth:`ran`), and its engagements and releases."""

    COOLDOWN_CHUNKS = 4
    DELTA0_DECAY = 0.7

    def __init__(self) -> None:
        self.engaged = False
        self._cooldown = 0
        self.delta0 = _DGS_DELTA0
        self.delayed_chunks = self.stored_chunks = 0
        self.engagements = self.releases = 0

    def ran(self, delayed: bool) -> None:
        """Count a chunk by the route it ran: delayed, or with the stored states."""
        if delayed:
            self.delayed_chunks += 1
        else:
            self.stored_chunks += 1

    def counts(self) -> dict:
        return {"delayed_chunks": self.delayed_chunks, "stored_chunks": self.stored_chunks,
                "engaged": self.engagements, "released": self.releases}

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
        self.engagements += self.engaged and not was
        self.releases += was and not self.engaged
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
    device: Optional[torch.device] = None,
    mesh=None,
) -> List[SolveResult]:
    """Solve all requested states on ``device`` (reference ``run``,
    src/grid.rs:31-47). A ``multigrid`` schedule runs the coarse→fine
    level ladder (:func:`_run_multigrid`). A multi-device ``mesh`` config
    runs the sharded driver (``parallel/solver_sharded.run_sharded``) on
    ``mesh``, a :class:`~wafer_torch.parallel.mesh.Mesh`; without one, on
    the configured shape over the visible CUDA devices (the CPU is one
    device), as the reference's mesh takes ``jax.devices()``; in a
    multi-process run (``WAFER_COORDINATOR``, see
    :mod:`~wafer_torch.parallel.distributed`) an equal share of every
    process's devices, each process solving its own shards. ``device``
    defaults to this process's first device of the mesh, and without a mesh
    to the CLI's device (:func:`~wafer_torch.utils.host.resolve_device`:
    CUDA, the CPU only under ``WAFER_DEVICE=cpu``). ``mesh.slices > 1``
    builds a multi-slice mesh (``parallel/multislice.make_multislice_mesh``).
    ``trace_dir`` is ignored here, as the reference's ``run`` ignores it:
    the CLI wraps the run in the profiler. A multi-process run without a
    multi-device mesh in the configuration raises
    :class:`~wafer_torch.errors.ConfigParseError` before any solve."""
    require_port_config(config)
    log = log or logging.getLogger("wafer")
    _check_supported(config)
    _warn_marginal_dt(config, log)
    if device is None and mesh is None:
        device = resolve_device()
    sharded = config.mesh.n_devices > 1
    if sharded and mesh is None:
        from wafer_torch.parallel.mesh import make_mesh
        from wafer_torch.parallel.multislice import make_multislice_mesh

        # one shard per visible CUDA device, or on the CPU its one device;
        # in a multi-process run an equal share of every process's devices
        cpu = device is not None and device.type == "cpu"
        devices = [device] if cpu and distributed.process_count() == 1 else None
        if config.mesh.slices > 1:
            mesh = make_multislice_mesh(config.mesh.as_tuple(), config.mesh.slices, devices)
        else:
            mesh = make_mesh(config.mesh.as_tuple(), devices)
    if device is None:
        device = mesh.local_devices[0]
    if config.multigrid:
        return _run_multigrid(
            config, log, debug_level, seed, progress_factory, device=device, mesh=mesh
        )
    if sharded:
        from wafer_torch.parallel.solver_sharded import run_sharded

        return run_sharded(config, log, seed=seed, mesh=mesh, progress_factory=progress_factory)
    return _run_single(config, log, debug_level, seed, progress_factory, device=device)


def _level_grid(config: Config, d: int) -> Grid:
    """The grid of multigrid divisor ``d``: the same box (dn·d) and the
    same stability margin (dt·d²)."""
    s = config.grid.size
    return Grid(
        size=Index3(s.x // d, s.y // d, s.z // d),
        dn=config.grid.dn * d,
        dt=config.grid.dt * d * d,
    )


def _upsample_state(phi: torch.Tensor, cfg_to: Config) -> torch.Tensor:
    """Trilinearly resample a converged padded state (an (re, im) pair
    componentwise) onto ``cfg_to``'s grid on its own device, re-framed with
    the zero Dirichlet shell and re-symmetrised (reference
    ``_upsample_state``, wafer_tpu/solver.py:1959-1977). The resampling is
    f64, cast to the level's dtype afterwards, as the reference's numpy
    promotion does."""
    ext = cfg_to.central_difference.ext
    work = geometry.work_area(phi, ext)
    comps = work if phi.dim() == 4 else work[None]
    up = torch.stack([trilerp_resize(c, cfg_to.work_size()) for c in comps])
    up = torch.nn.functional.pad(up.to(cfg_to.real_dtype), (ext,) * 6)
    return initial.symmetrise_wavefunction(cfg_to, up if phi.dim() == 4 else up[0])


def _run_multigrid(
    config: Config,
    log,
    debug_level: int,
    seed: Optional[int],
    progress_factory,
    *,
    device: torch.device,
    mesh=None,
) -> List[SolveResult]:
    """Coarse→fine multigrid ladder (reference ``_run_multigrid``,
    wafer_tpu/solver.py:1980-2071): solve every state on each level of the
    divisor ladder and upsample the converged states as the next level's
    initial conditions. Each level keeps the box (dn·d) and the stability
    margin (dt·d²); intermediate levels write no wavefunction, potential or
    snapshot files and converge to ``multigrid_tolerance``; the final level
    runs the configuration as it is. With a multi-device mesh the coarse
    levels solve on ``device`` and only the final level runs sharded, on
    ``mesh``, from the upsampled states; in a multi-process run every
    process solves the coarse levels alike (as the reference's SPMD
    program does) and puts its own shards of the final level."""
    divisors = list(config.multigrid) + [1]
    ic_overrides = None
    results: List[SolveResult] = []
    for li, d in enumerate(divisors):
        final = d == 1
        lvl_grid = _level_grid(config, d)
        lvl_out = config.output if final else dataclasses.replace(
            config.output, save_wavefns=False, save_potential=False, snap_update=None,
        )
        lvl_cfg = dataclasses.replace(
            config,
            grid=lvl_grid,
            output=lvl_out,
            multigrid=None,
            multigrid_tolerance=None,
            mesh=config.mesh if final else MeshConfig(1, 1, 1),
            tolerance=(
                config.tolerance if final else (config.multigrid_tolerance or config.tolerance)
            ),
        )
        log.info(
            "Multigrid level %d/%d: %d x %d x %d (dn=%g, dt=%g, tol=%g)",
            li + 1, len(divisors),
            lvl_grid.size.x, lvl_grid.size.y, lvl_grid.size.z,
            lvl_grid.dn, lvl_grid.dt, lvl_cfg.tolerance,
        )
        if lvl_cfg.mesh.n_devices > 1:
            from wafer_torch.parallel.solver_sharded import run_sharded

            results = run_sharded(
                lvl_cfg, log, seed=seed, mesh=mesh, progress_factory=progress_factory,
                ic_overrides=ic_overrides,
            )
        else:
            results = _run_single(
                lvl_cfg, log, debug_level, seed, progress_factory,
                ic_overrides=ic_overrides, device=device,
            )
        if not final:
            nxt_cfg = dataclasses.replace(config, grid=_level_grid(config, divisors[li + 1]))
            ic_overrides = {r.wnum: _upsample_state(r.phi, nxt_cfg) for r in results}
    return results


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
    """One-resolution run: load potentials, preload lower states when
    restarting, then solve each state in order. ``ic_overrides``: optional
    per-state padded initial ψ (the multigrid hand-over)."""
    require_port_config(config)
    with span("wafer.load_potentials"):
        pots = potentials_mod.load_arrays(config, log, device=device)

    w_store: List[torch.Tensor] = []
    if config.wavenum > 0:
        w_store.extend(
            initial.host_field(config, w, device)
            for w in readers.load_wavefunctions(config, log)
        )

    log.info("Starting calculation")
    backend = _resolve_backend(config, torch.empty(0, dtype=config.real_dtype, device=device))
    graphs = chunk_graphs(config, log, [device], kernel=backend == "kernel")
    results = []
    try:
        for wnum in range(config.wavenum, config.wavemax + 1):
            progress = progress_factory(wnum) if progress_factory is not None else None
            results.append(
                solve(
                    config, log, debug_level, pots, wnum, w_store, seed=seed,
                    progress=progress,
                    ic_override=ic_overrides.get(wnum) if ic_overrides else None,
                    device=device, graphs=graphs,
                )
            )
    finally:
        if graphs is not None:
            graphs.close()
    return results

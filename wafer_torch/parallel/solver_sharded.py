"""The sharded convergence driver on a device mesh (counterpart of
``wafer_tpu/parallel/solver_sharded.py`` and, for complex potentials, of
``sharded_split.run_sharded_split``).

Each state runs the single-device convergence loop (``solver.converge``)
with ψ held as this process's per-shard blocks (every shard's in a
single-process run; in a multi-process run every process selects the same
seeded initial state and puts its own shards): the measure and the chunk are
:class:`ShardedOps`' (:class:`ShardedSplitOps`' for (re, im) pairs; on a
multi-slice mesh :class:`MultiSliceOps`' and :class:`MultiSliceSplitOps`',
whose chunks exchange x faces once per window), and snapshots and the
written wavefunction go through the gathered global array. Analytic
potentials are generated per shard; file and script potentials, and
``save_potential``, need the global array. Only process 0 writes files.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import torch
import torch.nn.functional as F

from wafer_torch import errors, geometry, solver
from wafer_torch.config import Config, PotentialType
from wafer_torch.io import readers
from wafer_torch.models import initial, potentials as potentials_mod
from wafer_torch.parallel import multislice
from wafer_torch.parallel.mesh import AXIS_NAMES, make_mesh


def run_sharded(
    config: Config,
    log=None,
    seed: Optional[int] = None,
    mesh=None,
    progress_factory=None,
    ic_overrides=None,
) -> list:
    """Solve all requested states on ``mesh`` (default: the configured mesh
    shape over :func:`~wafer_torch.parallel.mesh.take_devices`, a
    multi-slice mesh when ``mesh.slices > 1``).
    ``ic_overrides``: optional ``{wnum: padded ψ}`` initial states (the
    multigrid hand-over). Returns the single-device ``SolveResult``s, with
    ψ gathered into the padded global array on this process's first device
    of the mesh (on every process)."""
    log = log or logging.getLogger("wafer")
    if seed is None:
        seed = config.seed
    if mesh is None:
        mesh = (multislice.make_multislice_mesh(config.mesh.as_tuple(), config.mesh.slices)
                if config.mesh.slices > 1 else make_mesh(config.mesh.as_tuple()))
    if mesh.slices > 1:
        if config.potential.is_complex:
            multislice.check_split_factorisation(mesh)
        multislice.log_windows(config, mesh, log)
    dev = mesh.local_devices[0]
    blocked = config.potential not in (
        PotentialType.FROM_FILE, PotentialType.FROM_SCRIPT
    ) and not config.output.save_potential
    if blocked:
        pots = potentials_mod.load_arrays_meta(config, log)
    else:
        pots = potentials_mod.load_arrays(config, log, device=dev)

    # interior global arrays on the mesh's first device
    w_store: List[torch.Tensor] = []
    if config.wavenum > 0:
        w_store.extend(
            geometry.work_area(initial.host_field(config, w, dev), config.central_difference.ext)
            for w in readers.load_wavefunctions(config, log)
        )

    log.info(
        "Starting calculation (sharded over mesh %s)", dict(zip(AXIS_NAMES, mesh.shape))
    )
    graphs = solver.chunk_graphs(config, log, mesh.local_devices, mesh.processes,
                                 kernel=_use_pallas(config, mesh) is not False
                                 and config.real_dtype == torch.float32)
    results = []
    try:
        for wnum in range(config.wavenum, config.wavemax + 1):
            progress = progress_factory(wnum) if progress_factory is not None else None
            results.append(
                _solve_state(
                    config, log, mesh, wnum, w_store, pots, seed, progress,
                    ic_override=ic_overrides.get(wnum) if ic_overrides else None,
                    graphs=graphs,
                )
            )
    finally:
        if graphs is not None:
            graphs.close()
    return results


def _use_pallas(config: Config, mesh):
    """The backend key as solver._resolve_backend reads it: xla forces the
    plain sweep (False), pallas demands the kernels (True), auto takes them
    for f32 (None: :class:`ShardedOps` decides)."""
    if config.backend == "xla":
        return False
    if config.backend == "pallas":
        if (config.real_dtype != torch.float32
                or any(d.type != "cuda" for d in mesh.local_devices)):
            raise errors.ConfigParseError("backend: pallas requires precision f32 and a CUDA device")
        return True
    return None


def _select_ic(config: Config, log, wnum, w_store, seed, device, ic_override=None):
    """The interior initial ψ: an explicit override, else disk (current
    state, incl. ``_partial``) → previous converged state → configured
    generator (reference: src/grid.rs:60-100)."""
    ext = config.central_difference.ext
    if ic_override is not None:
        log.info(
            "Using explicit in-memory initial condition for state %d (multigrid hand-over)", wnum
        )
        return geometry.work_area(ic_override.to(device=device, dtype=config.real_dtype), ext)
    if wnum > 0:
        try:
            wfn = readers.wavefunction(
                wnum, config.padded_size(), config.central_difference.bb,
                config.output.file_type, log, input_dir=config.input_dir,
            )
            log.info("Loaded (current) wavefunction %d from disk", wnum)
            return geometry.work_area(initial.host_field(config, wfn, device), ext)
        except errors.WaferError:
            log.info("Loaded wavefunction %d from memory as initial condition", wnum - 1)
            # seeded perturbation: an exact clone can Gram-Schmidt-cancel
            # bitwise to zero in f32; interior arrays draw the same noise
            # field as the padded driver
            return initial.perturb_clone(config, w_store[wnum - 1], wnum, seed=seed, padded=False)
    return geometry.work_area(initial.set_initial_conditions(config, log, seed=seed, device=device), ext)


def _solve_state(config, log, mesh, wnum, w_store, pots, seed, progress, ic_override=None,
                 graphs=None):
    """One state on the mesh; ``graphs``, the run's bound chunks
    (``solver.chunk_graphs``), whose chunks holding this state's stored
    states or streamed B are released when it ends."""
    n_lower = wnum
    ext = config.central_difference.ext
    split = config.potential.is_complex
    dev = mesh.local_devices[0]
    rdt = config.real_dtype
    use_pallas = _use_pallas(config, mesh)
    sub_deferred = pots.v is None and pots.pot_sub_array is None and config.potential.variable_pot_sub
    try:
        ops = multislice.ops_class(mesh, split)(
            config, mesh, n_lower, pot_sub_scalar=pots.pot_sub_scalar, use_pallas=use_pallas,
            v_shift=pots.v_shift,
        )
    except ValueError as exc:
        raise errors.ConfigParseError(f"mesh {mesh.shape} cannot run this grid: {exc}") from exc
    log.info(
        "Sweep backend for state %d on mesh %s: %s (%s B%s)", wnum, mesh.shape,
        "kernel" if ops.use_pallas else "plain",
        "analytic" if ops.analytic is not None else "streamed",
        ", stored-state streams in bf16" if ops.stream_dtype == torch.bfloat16 else "",
    )
    solver._warn_tolerance(config, log)

    phi = ops.put(_select_ic(config, log, wnum, w_store, seed, dev, ic_override))
    g = config.grid
    if pots.v is None:
        # interior block at offset o sits at padded index o + ext
        def v_block(shp, off):
            off = tuple(o + ext for o in off)
            if split:
                return torch.stack(potentials_mod.generate_split(config, shp, off, device=dev))
            return potentials_mod.generate(config, shp, off, device=dev)

        v = ops.put_blocks(v_block)
        r2 = ops.put_blocks(
            lambda shp, off: geometry.r2_index_grid(
                shp, g.size.as_tuple(), dtype=rdt, device=dev, offset=off
            )
        )
    else:
        v = ops.put(geometry.work_area(pots.v, ext), halo=False)
        r2 = ops.put(
            geometry.r2_index_grid(config.work_size(), g.size.as_tuple(), dtype=rdt, device=dev),
            halo=False,
        )
    b = None
    if ops.analytic is None:
        if split:
            b = [torch.stack(potentials_mod.build_ab_split(vb[0], vb[1], g.dt, pots.v_shift)[2:])
                 for vb in v]
        else:
            b = [potentials_mod.build_ab(vb, g.dt, pots.v_shift)[1] for vb in v]
    if pots.pot_sub_array is not None:
        sub = ops.put(pots.pot_sub_array, halo=False)
    elif sub_deferred:
        sub = ops.put_blocks(
            lambda shp, off: potentials_mod.potential_sub_array(config, shp, off, device=dev)
        )
    else:
        sub = ops.dummy_pot_sub()
    # the chunks stream the stored states in ops.stream_dtype (bf16 by the
    # reference's rule); the measure and the admixture gate hold them in
    # the run's precision
    stored = torch.stack(w_store[:n_lower]) if n_lower else None
    store_stream = ops.put_store(stored)
    store = store_stream if ops.stream_dtype == rdt else ops.put(stored)
    del stored

    def measure_device(phi, store=store):
        return ops.measure(phi, v, r2, sub, store)

    def measure(phi, store=store):
        sums, phi = measure_device(phi, store)
        return solver.read_observables(sums), phi

    # delayed re-orthogonalisation: the lowest stored-state Rayleigh
    # quotient, once per solve; delayed chunks run the ground
    # per-step-norm chunk without stored states; inactive under batching
    e_lowest = None
    if n_lower > 0 and config.delayed_gram and solver.batching(config):
        solver.log_delayed_gram_inactive(log)
    if n_lower > 0 and config.delayed_gram and not solver.batching(config):
        e_lowest = min(
            obs.energy.real / obs.norm2
            for obs, _p in (measure(ops.put(w), store=None) for w in w_store[:n_lower])
        )

    ops.graphs = graphs if ops.use_pallas else None

    def evolve(phi, per_step_norm, delayed_gs, done=None):
        if delayed_gs:
            return ops.evolve_chunk_psn(phi, None, b, None, done=done)
        chunk = ops.evolve_chunk_psn if per_step_norm else ops.evolve_chunk
        return chunk(phi, None, b, store_stream, done=done)

    def scatter(padded):
        return ops.put(geometry.work_area(padded, ext))

    timer = solver._ChunkTimer(dev)
    batch = solver.batch_runner(config, log, measure_device, evolve, n_lower,
                                mesh.local_devices, mesh.processes,
                                stream_dtype=ops.stream_dtype)
    gate = None if e_lowest is None else solver.DelayedGramState()
    try:
        obs, step, phi = solver.converge(
            config, log, wnum, phi, measure_device, evolve,
            overlap=lambda phi: ops.max_rel_overlap(phi, store),
            e_lowest=e_lowest, v_shift=pots.v_shift, progress=progress, timer=timer,
            gather=lambda phi: F.pad(ops.get(phi), (ext,) * 6), scatter=scatter, batch=batch,
            gate=gate,
        )
    finally:
        if batch is not None:
            batch.close()
        if graphs is not None:
            graphs.release(*(b or ()), *(store_stream or ()))
    interior = ops.get(phi)
    w_store.append(interior)
    return solver.SolveResult(
        wnum=wnum, converged=True, observables=obs, steps=step,
        phi=F.pad(interior, (ext,) * 6), chunk_seconds=timer.total,
        batch=None if batch is None else batch.stats(),
        graphs=solver.graph_stats(ops.graphs, mesh.local_devices, ops.use_pallas),
        gate=solver.log_gate(log, wnum, step, gate),
    )

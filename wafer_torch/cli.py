"""Application shell: ``wafer-torch [-c FILE] [-s FILE] [-d ...]`` —
the counterpart of ``wafer_tpu/cli.py`` (reference: src/main.rs:94-240).

With ``WAFER_COORDINATOR``, ``WAFER_NUM_PROCESSES`` and
``WAFER_PROCESS_ID`` set (the reference's ``jax.distributed`` entry) the
process is one rank of a multi-process run
(:mod:`~wafer_torch.parallel.distributed`): the configuration's mesh spans
every rank, each rank solving its own shards. Process 0 alone creates the
run directory, the log file and the output; the other ranks log to the
screen, their rank in the banner. ``torch.distributed`` is shut down on
every exit; a rank that fails returns 1, and its peers' next collective
fails or times out.

The device is CUDA unless ``WAFER_DEVICE`` names another
(``WAFER_DEVICE=cpu`` runs the plain torch ops on the CPU); without CUDA
and without that variable the CLI raises
:class:`~wafer_torch.errors.DeviceUnavailableError`. A config with a
multi-device ``mesh`` (a multi-slice one for ``mesh.slices > 1``) runs on
one shard per visible CUDA device (the CPU is one device; in a
multi-process run each rank's device) and fails, as the reference does,
when there are fewer devices than shards;
``solver.run(config, mesh=...)`` places several shards on one device.

``trace_dir`` wraps the run in ``torch.profiler.profile`` (CPU activity,
and CUDA activity on a CUDA device), as the reference wraps it in
``jax.profiler.trace``: on exit, also after an error, the trace is written
as Chrome trace JSON into ``trace_dir`` (created if missing), one file
``<host>_<pid>.<time ns>.pt.trace.json`` a run. The profiler holds every
event in host memory until the run ends. ``debug_nans`` is read by the
solve loop (``solver.converge``).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from wafer_torch import __version__, errors
from wafer_torch.config import Config
from wafer_torch.io import run_dir
from wafer_torch.parallel import distributed
from wafer_torch.utils import logging as wlog, terminal
from wafer_torch.utils.host import resolve_device


def _format_elapsed(time_taken: float) -> str:
    """Elapsed-time summary (reference: src/main.rs:215-238)."""
    if time_taken < 60.0:
        return f"Simulation complete. Elapsed time: {time_taken:.3f} seconds."
    if time_taken < 3600.0:
        minutes = int(time_taken // 60)
        seconds = time_taken - 60.0 * minutes
        return f"Simulation complete. Elapsed time: {minutes} minutes, {seconds:.3f} seconds."
    hours = int(time_taken // 3600)
    minutes = int((time_taken - 3600.0 * hours) // 60)
    seconds = time_taken - 3600.0 * hours - 60.0 * minutes
    return (
        f"Simulation complete. Elapsed time: {hours} hours, {minutes} minutes, "
        f"{seconds:.3f} seconds."
    )


def device_count(device: torch.device) -> int:
    """Devices of the run's platform that this process sees: what the
    reference's banner prints (``len(jax.devices())``)."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def profiled(trace_dir, device: torch.device):
    """``torch.profiler.profile`` writing its Chrome trace into
    ``trace_dir`` on exit (CUDA activity too on a CUDA device), or no
    profiler when ``trace_dir`` is empty."""
    if not trace_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir),
                   acc_events=True)


def main(argv=None) -> int:
    start_time = time.time()
    parser = argparse.ArgumentParser(
        prog="wafer-torch",
        description=(
            "Exploits a Wick-rotated time-dependent Schrödinger equation to solve "
            "for time-independent solutions in three dimensions."
        ),
    )
    parser.add_argument("-c", "--config", metavar="FILE", default="wafer.yaml",
                        help='The configuration file to use (default is "wafer.yaml")')
    parser.add_argument("-s", "--script", metavar="FILE", default="gen_potential.py",
                        help='The potential generation script to use (default is "gen_potential.py")')
    parser.add_argument("-d", dest="debug", action="count", default=0,
                        help="Raises screen debug level. -d for INFO alerts, -dd for DEBUG alerts")
    parser.add_argument("--version", action="version", version=__version__)
    args = parser.parse_args(argv)

    # the multi-process entry: no-op unless WAFER_COORDINATOR is set
    try:
        multi = distributed.maybe_initialize_distributed()
    except errors.WaferError as err:
        print(f"Error: {err}")
        return 1
    try:
        return _run(args, start_time, multi)
    finally:
        distributed.shutdown()


def _run(args, start_time: float, multi: bool) -> int:
    """The CLI after the multi-process entry: configuration, logging,
    banner and the solve."""
    device = distributed.runtime().device if multi else resolve_device()
    primary = distributed.process_index() == 0

    try:
        config = Config.load(args.config, script=args.script, setup_output=primary)
    except errors.WaferError as err:
        print(f"Error loading configuration: {err}")
        cause = err.__cause__
        while cause is not None:
            print(f"caused by: {cause}")
            cause = cause.__cause__
        return 1

    log_location = None
    if primary:
        log_location = (run_dir.get_project_dir(config.project_name, config.output_root)
                        + "/simulation.log")
    try:
        log = wlog.setup_logging(log_location, args.debug)
    except errors.WaferError as err:
        print(f"Error initialising log file: {err}")
        return 1

    log.info("Starting Wafer solver (version %s, torch %s)", __version__, torch.__version__)
    if args.debug > 0:
        log.warning("Debugging information displayed on screen. Progress bar hidden.")
    log.info("Checking/creating directories")
    try:
        if primary:
            run_dir.check_input_dir(config.input_dir)
    except errors.WaferError as err:
        log.critical("%s", err)
        return 1

    term_width = terminal.get_term_size()
    sha = terminal.git_sha(short=term_width <= 97)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    process = (distributed.process_index(), distributed.process_count()) if multi else None
    terminal.print_banner(sha, device_count(device), kind, process)

    log.info("Loading Configuation from disk")
    config.print(term_width)

    debug_level = wlog.screen_level_as_usize(args.debug)

    def progress_factory(wnum):
        if debug_level == 3:
            return terminal.ProgressBar(enabled=True)
        return None

    from wafer_torch import solver
    from wafer_torch.parallel.mesh import make_mesh
    from wafer_torch.parallel.multislice import make_multislice_mesh

    mesh = None
    if config.mesh.n_devices > 1:
        try:
            if config.mesh.slices > 1:
                mesh = make_multislice_mesh(config.mesh.as_tuple(), config.mesh.slices)
            else:
                mesh = make_mesh(config.mesh.as_tuple())
        except ValueError as err:
            log.critical("%s", err)
            return 1

    try:
        with profiled(config.trace_dir, device):
            solver.run(config, log, debug_level, progress_factory=progress_factory,
                       device=device, mesh=mesh)
    except errors.WaferError as err:
        log.critical("%s", err)
        cause = err.__cause__
        while cause is not None:
            log.critical("caused by: %s", cause)
            cause = cause.__cause__
        return 1

    print(_format_elapsed(time.time() - start_time))
    log.info("Simulation completed")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Application shell: ``wafer-torch [-c FILE] [-s FILE] [-d ...]`` —
the counterpart of ``wafer_tpu/cli.py`` (reference: src/main.rs:94-240),
one process, no ``jax.distributed``.

The device is CUDA unless ``WAFER_DEVICE`` names another
(``WAFER_DEVICE=cpu`` runs the plain torch ops on the CPU); without CUDA
and without that variable the CLI raises
:class:`~wafer_torch.errors.DeviceUnavailableError`. A config with a
multi-device ``mesh`` runs on one shard per visible CUDA device (the CPU
is one device) and fails, as the reference does, when there are fewer
devices than shards; ``solver.run(config, mesh=...)`` places several
shards on one device.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from wafer_torch import __version__, errors
from wafer_torch.config import Config
from wafer_torch.io import run_dir
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

    device = resolve_device()

    try:
        config = Config.load(args.config, script=args.script)
    except errors.WaferError as err:
        print(f"Error loading configuration: {err}")
        cause = err.__cause__
        while cause is not None:
            print(f"caused by: {cause}")
            cause = cause.__cause__
        return 1

    log_location = run_dir.get_project_dir(config.project_name, config.output_root) + "/simulation.log"
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
        run_dir.check_input_dir(config.input_dir)
    except errors.WaferError as err:
        log.critical("%s", err)
        return 1

    term_width = terminal.get_term_size()
    sha = terminal.git_sha(short=term_width <= 97)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    terminal.print_banner(sha, device_count(device), kind)

    log.info("Loading Configuation from disk")
    config.print(term_width)

    debug_level = wlog.screen_level_as_usize(args.debug)

    def progress_factory(wnum):
        if debug_level == 3:
            return terminal.ProgressBar(enabled=True)
        return None

    from wafer_torch import solver
    from wafer_torch.parallel.mesh import make_mesh

    mesh = None
    if config.mesh.n_devices > 1 and config.mesh.slices == 1:
        try:
            mesh = make_mesh(config.mesh.as_tuple())
        except ValueError as err:
            log.critical("%s", err)
            return 1

    try:
        solver.run(config, log, debug_level, progress_factory=progress_factory, device=device,
                   mesh=mesh)
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

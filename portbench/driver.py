"""The cell's closed loop: one physicist's jobs, one at a time, back to back.

Each job is one ``wafer_torch.solver.run(config, seed=…, device=cuda:0)``,
the call ``wafer_torch.cli.main`` makes after it parses a file. The only
hook the harness puts into it is the solve loop's progress object, the
role the CLI's progress bar plays: it is told of each state's start and of
every chunk boundary, where it counts the chunks that finished and, once
the window's time is up, stops the job in flight.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import sys
import time

import torch
from torch.profiler import record_function

from portbench.check import port_states
from portbench.record import Solve
from portbench.trace import STATE_SPAN
from wafer_torch.errors import WaferError


def synchronize(device) -> None:
    """Wait for the card (the CPU tests drive the loop without one)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class WindowClosed(Exception):
    """The window's time is up: the job in flight stops at its next chunk
    boundary or state start."""


class _Progress:
    """One state's progress hook: ``set_message`` runs after each measure
    that did not converge, and an evolve chunk follows it; so when it runs
    again, or ``finish`` runs, every chunk counted so far has finished."""

    def __init__(self, loop: "Loop", wnum: int):
        self.loop, self.chunks = loop, 0
        self.span = None
        if loop.traced:
            self.span = record_function(f"{STATE_SPAN}{wnum}")
            self.span.__enter__()

    def set_position(self, percent: int) -> None:
        pass

    def set_message(self, msg: str) -> None:
        if self.loop.closed():
            self.finish()
            raise WindowClosed
        self.chunks += 1

    def finish(self) -> None:
        self.loop.chunks += self.chunks
        self.chunks = 0
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None


class Loop:
    """Runs jobs of ``config`` on ``device`` until ``deadline`` (host
    ``perf_counter`` seconds; None: never closes), counting the chunks
    that finish."""

    def __init__(self, config, device, deadline=None, traced=False):
        self.config, self.device = config, device
        self.deadline, self.traced = deadline, traced
        self.chunks = 0
        self.log = logging.getLogger("portbench.wafer")

    def closed(self) -> bool:
        return self.deadline is not None and time.perf_counter() >= self.deadline

    def progress(self, wnum: int) -> _Progress:
        if self.closed():
            raise WindowClosed
        return _Progress(self, wnum)

    def job(self, seed: int):
        """One ``solver.run``: its results, or None if the window closed
        first."""
        from wafer_torch import solver

        span = record_function("portbench.solve") if self.traced else contextlib.nullcontext()
        try:
            with span:
                return solver.run(self.config, self.log, seed=seed,
                                  progress_factory=self.progress, device=self.device)
        except WindowClosed:
            return None


def warm_up(config, device, seed: int) -> None:
    """One chunk of every route the cell's solves take, at its shapes: the
    same job with a tolerance every second measure meets, so each state
    stops after one chunk, and with per-step Gram-Schmidt, so each excited
    state runs its stored-state route (the delayed-GS chunks are the
    ground state's per-step-norm route, which state 0 runs)."""
    warm = dataclasses.replace(config, tolerance=1e30, delayed_gram=False)
    Loop(warm, device).job(seed)
    synchronize(device)


@dataclasses.dataclass
class Window:
    window_s: float
    chunk_steps: int
    solves: list
    results: list  # each finished solve's states on the host (``check.port_states``)
    errors: int  # solves that raised the port's error: answers that never came
    trace: object = None


def window(config, device, seconds: float, seeds: list, session=None) -> Window:
    """Jobs back to back for ``seconds``; job k solves from initial-condition
    seed ``seeds[k mod len(seeds)]``. With a profiler ``session``, started
    before the window opens, the stretch up to the end of the first
    finished job is traced."""
    if session is not None:
        session.start()
    t0 = time.perf_counter()
    loop = Loop(config, device, deadline=t0 + seconds, traced=session is not None)
    solves, results, trace, errors = [], [], None, 0
    k = 0
    while not loop.closed():
        ts = time.perf_counter()
        try:
            out = loop.job(seeds[k % len(seeds)])
        except WaferError as err:
            print(f"portbench: solve {k} raised {err!r}", file=sys.stderr)
            errors, k = errors + 1, k + 1
            continue
        if out is None:
            break
        synchronize(device)
        solves.append(Solve(
            seconds=time.perf_counter() - ts,
            steps=sum(r.steps for r in out),
            chunk_seconds=sum(r.chunk_seconds for r in out),
            capture_ms=sum((r.graphs or {}).get("capture_ms", 0.0) for r in out),
        ))
        if session is not None:
            trace, session, loop.traced = session.stop(), None, False
        results.append(port_states(out))
        del out
        k += 1
    synchronize(device)
    window_s = time.perf_counter() - t0
    if session is not None:
        trace = session.stop()
    steps = loop.chunks * config.output.screen_update
    return Window(window_s=window_s, chunk_steps=steps, solves=solves, results=results,
                  errors=errors, trace=trace)


def fresh(config, device, seed: int):
    """One job more, once the window has closed, from the initial condition
    ``seed``: its states on the host, or None if it raised the port's
    error. The window's jobs come from the traffic's fixed pool; this one
    is new with every ``--seed``."""
    try:
        out = Loop(config, device).job(seed)
    except WaferError as err:
        print(f"portbench: the job after the window raised {err!r}", file=sys.stderr)
        return None
    synchronize(device)
    return port_states(out)

"""What one run leaves for the metric readers (``portbench/metrics``).

A reader is ``read(record) -> float | None``; None means the run had
nothing for it to read, and the metric is left out of the result.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Solve:
    """One ``solver.run`` that finished in the window: its host wall
    seconds, its steps, the CUDA-event seconds of its evolve chunks and
    its graph-capture milliseconds, each summed over its states."""

    seconds: float
    steps: int
    chunk_seconds: float
    capture_ms: float


@dataclass
class Trace:
    """The profiled stretch of a ``--trace 1`` run, from the start of the
    window to the end of its first finished solve.

    ``device_ops``: (name, start s, seconds, state) of every kernel, copy
    and set on the card, ``state`` the number of the state being solved
    when it ran (−1 outside any); ``spans``: (name, start s, seconds) of the
    host's ``wafer.*`` and ``portbench.*`` spans; ``window_s``: the
    stretch on the host clock. Times are on the profiler's clock."""

    window_s: float
    device_ops: List[Tuple[str, float, float, int]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)


@dataclass
class Record:
    """A run: the cell's shape, the window and what finished in it."""

    grid: Tuple[int, int, int]
    b_streams: bool
    setup_s: float
    window_s: float
    chunk_steps: int  # every step of every chunk finished in the window
    solves: List[Solve] = field(default_factory=list)
    trace: Optional[Trace] = None

    @property
    def points(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

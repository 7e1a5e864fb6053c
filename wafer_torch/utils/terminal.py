"""Terminal UX: banner, observable tables, summaries, progress bar.

The port's copy of ``wafer_tpu/utils/terminal.py``: the same text.

Replicates the reference's fixed-width output (src/output.rs:61-77,422-603)
and the indicatif-style ETA progress bar (src/grid.rs:104-120,198-209).
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import time
from typing import Optional, Tuple
_ORDINALS = {1: "st", 2: "nd", 3: "rd"}


def ordinal(n: int) -> str:
    if 10 <= n % 100 <= 20:
        return f"{n}th"
    return f"{n}{_ORDINALS.get(n % 10, 'th')}"


def get_term_size() -> int:
    """Terminal width clamped to [70, 100] (reference: src/output.rs:710-720)."""
    width = shutil.get_terminal_size(fallback=(100, 24)).columns
    if width <= 70:
        return 70
    return min(width, 100)


def git_sha(short: bool = True) -> str:
    """Build provenance: best-effort git SHA (the reference bakes it in via
    vergen, build.rs:1-13)."""
    try:
        args = ["git", "rev-parse", "--short" if short else "HEAD", "HEAD"]
        if short:
            args = ["git", "rev-parse", "--short", "HEAD"]
        out = subprocess.run(args, capture_output=True, text=True, timeout=2)
        if out.returncode == 0:
            return out.stdout.strip()
    except Exception:
        pass
    return "unknown"


def print_banner(sha: str, n_devices: int, device_kind: str = "device",
                 process: Optional[Tuple[int, int]] = None) -> None:
    """ASCII banner with build SHA and device count
    (reference: src/output.rs:61-77 prints thread count; we print the
    participating accelerator count), and in a multi-process run this
    process's (rank, processes)."""
    blue = "\033[34m"
    reset = "\033[0m"
    print(f"                    {blue}___{reset}")
    print(f"   __      ____ _  {blue}/ __\\{reset}__ _ __")
    print(f"   \\ \\ /\\ / / _` |{blue}/ /{reset} / _ \\ '__|")
    print(f"    \\ V  V / (_| {blue}/ _\\{reset}|  __/ |    Current build SHA1: {sha}")
    print(
        f"     \\_/\\_/ \\__,{blue}/ /{reset}   \\___|_|    "
        f"Parallel tasks running on {n_devices} {device_kind}{'s' if n_devices != 1 else ''}"
        + (f", process {process[0]} of {process[1]}." if process else ".")
    )
    print(f"              {blue}\\__/{reset}")
    print()


def print_observable_header(wnum: int) -> None:
    """Observable table header (reference: src/output.rs:422-494)."""
    width = get_term_size()
    spacer = (width - 69) // 2
    col2 = 37
    rspace = spacer + 1 if 2 * spacer + 69 < width else spacer
    title = (
        " Ground state caclulation "
        if wnum == 0
        else f" {ordinal(wnum)} excited state caclulation "
    )
    print()
    print(
        "═" * spacer
        + "╤"
        + "═" * 12
        + "╤"
        + title.center(col2, "═")
        + "╤"
        + "═" * 16
        + "╤"
        + "═" * rspace
    )
    print(
        " " * spacer
        + "│"
        + "Time (τ)".center(12)
        + "│"
        + "Energy".center(20)
        + "│"
        + "rᵣₘₛ".center(16)
        + "│"
        + "Difference".center(16)
        + "│"
    )
    print(
        "─" * spacer
        + "┼"
        + "─" * 12
        + "┼"
        + "─" * 20
        + "┼"
        + "─" * 16
        + "┼"
        + "─" * 16
        + "┼"
        + "─" * rspace
    )


def print_measurements(tau: float, diff: float, observables) -> str:
    """One row of the observable table (reference: src/output.rs:497-521)."""
    width = get_term_size()
    spacer = (width - 69) // 2
    energy = observables.energy / observables.norm2
    if isinstance(energy, complex):
        energy = energy.real
    r_rms = (observables.r2 / observables.norm2) ** 0.5
    if tau > 0.0:
        return (
            " " * spacer
            + f"│{tau:>11.3f} │{energy:>19.10e} │{r_rms:15.5f} │{diff:15.5e} │"
        )
    return (
        " " * spacer
        + f"│{tau:>11.3f} │{energy:>19.10e} │{r_rms:15.5f} │{'--   ':>15} │"
    )


def print_summary(out: dict) -> None:
    """Per-state final summary (reference: src/output.rs:561-603)."""
    width = get_term_size()
    spacer = (width - 69) // 2
    rspace = spacer + 1 if 2 * spacer + 69 < width else spacer
    print(
        "═" * spacer
        + "╧"
        + "═" * 12
        + "╧"
        + "═" * 20
        + "╧"
        + "═" * 16
        + "╧"
        + "═" * 16
        + "╧"
        + "═" * rspace
    )
    if out["state"] == 0:
        print(f"══▶ Ground state energy = {out['energy']}")
        print(f"══▶ Ground state binding energy = {out['binding_energy']}")
    else:
        state = ordinal(out["state"])
        print(f"══▶ {state} excited state energy = {out['energy']}")
        print(f"══▶ {state} excited state binding energy = {out['binding_energy']}")
    if "energy_im" in out:
        print(f"══▶ Im(energy) = {out['energy_im']}")
    print(f"══▶ rᵣₘₛ = {out['r']}")
    print(f"══▶ L/rᵣₘₛ = {out['l_r']}")
    print()


class ProgressBar:
    """ETA progress bar on stderr (indicatif counterpart,
    reference: src/grid.rs:104-120)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled and sys.stderr.isatty()
        self.position = 0
        self.message = ""
        self.start = time.time()

    def set_position(self, percent: int) -> None:
        self.position = max(0, min(100, percent))
        self._draw()

    def set_message(self, msg: str) -> None:
        self.message = msg
        self._draw()

    def _draw(self) -> None:
        if not self.enabled:
            return
        width = get_term_size()
        bar_width = max(10, width - 24)
        filled = int(bar_width * self.position / 100)
        elapsed = time.time() - self.start
        mins, secs = divmod(int(elapsed), 60)
        hrs, mins = divmod(mins, 60)
        bar = "█" * filled + "░" * (bar_width - filled)
        sys.stderr.write(
            f"\r[{hrs:02d}:{mins:02d}:{secs:02d}] |{bar}| {self.position:3d}%"
        )
        sys.stderr.flush()

    def finish(self) -> None:
        if self.enabled:
            sys.stderr.write("\r" + " " * (get_term_size() + 2) + "\r")
            sys.stderr.flush()

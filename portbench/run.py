"""Run one cell of the port's benchmark once, on one CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (CUDA, the kernel library from ``wafer_torch/_kernels``, one chunk
of each of the cell's routes), then the cell's jobs back to back for
``--seconds`` (``portbench/driver.py``), with the card's clocks and power
sampled beside them, then one job more from an initial condition drawn
from ``--seed``, then the check of every finished job against the plain
reference (``portbench/check.py``). The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; its last key,
``checks``, holds each compared number beside its limit, as do the last
lines of standard error. Without a CUDA card, or with ``jax``, ``jaxlib``,
``flax`` or ``wafer_tpu`` loaded once the window has closed, it prints no
result and exits 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "wafer_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name, taken whole, is one the port's
    run must never load."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def fail(message: str) -> int:
    print(f"portbench: {message}", file=sys.stderr)
    return 2


class Clocks:
    """``nvidia-smi`` sampling the SM clock, power draw and temperature of
    card 0 every half second, in one process of its own, while the window
    runs; nothing where the tool is missing."""

    QUERY = ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits", "-lms", "500"]

    def __init__(self):
        try:
            self.proc = subprocess.Popen(self.QUERY, stdout=subprocess.PIPE,
                                         stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self) -> str:
        """End the sampling and wait for it; the samples' summary."""
        if self.proc is None:
            return "not read"
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        if not rows:
            return "not read"
        cols = list(zip(*rows))
        parts = [f"{name} {min(c):g}/{sorted(c)[len(c) // 2]:g}/{max(c):g}"
                 for name, c in zip(("sm MHz", "power W", "temp C"), cols)]
        return f"{len(rows)} samples, min/median/max " + ", ".join(parts)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # the reference's default excited stream (bf16), whatever the caller's
    # environment says; a library that would load JAX by itself is kept from it
    os.environ.pop("WAFER_EXC_STREAM", None)
    os.environ.pop("WAFER_DEVICE", None)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        return fail("no CUDA device: the benchmark runs only on the card")
    from portbench import spec

    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        return fail(f"{args.workload} needs {cell['chips']} cards")
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        return measure(args, bench, cell, device, Path(work))


def measure(args, bench, cell, device, work: Path) -> int:
    import torch

    from portbench import bytes as bytes_model, check, driver, spec, trace
    from portbench.record import Record

    mix = spec.traffic(cell["traffic"])
    raw = spec.run_raw(spec.configuration(cell["config"]), mix)
    limits = spec.limits(cell["name"])
    (work / "input").mkdir()
    config = spec.port_config(raw, work)
    from wafer_torch.io import run_dir

    run_dir.check_output_dir(config.project_name, config.output_root)

    cuda = device.type == "cuda"
    driver.warm_up(config, device, spec.solve_seed(args.seed, -1))
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T_START
    session = trace.Session(device) if args.trace else None
    clocks = Clocks() if cuda else None
    try:
        win = driver.window(config, device, args.seconds, spec.job_seeds(mix, args.seed), session)
    finally:
        card = clocks.stop() if clocks else "not read"
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    fresh_seed = spec.solve_seed(args.seed, 0)
    fresh = driver.fresh(config, device, fresh_seed)
    answers = win.results + ([fresh] if fresh is not None else [])
    errors = win.errors + (fresh is None)
    judge = check.Judge(raw, device)
    per_solve = []
    while answers:
        per_solve.append(judge.solve(answers.pop(0)))
    worst, failed = check.verdict(per_solve, limits)
    attempted, failed = len(per_solve) + errors, failed + errors

    record = Record(grid=tuple(config.grid.size.as_tuple()),
                    b_streams=raw["potential"] not in bytes_model.B_FROM_COORDINATES,
                    setup_s=setup_s, window_s=win.window_s, chunk_steps=win.chunk_steps,
                    solves=win.solves, trace=win.trace)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, cell["name"], kind):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": 1,
           "memory_peak_bytes": memory_peak}
    result = {"correct": attempted > 0 and failed == 0, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = trace.busy_seconds(win.trace)
        dev["window_s"] = win.trace.window_s
        result["breakdown"] = trace.breakdown(win.trace)
    result["checks"] = {name: {"value": _number(worst.get(name)), "limit": limit}
                        for name, limit in limits.items()}

    found = forbidden_modules()
    if found:
        return fail(f"loaded once the window closed: {', '.join(found)}")
    print(f"portbench: {cell['name']} seed {args.seed}: {len(win.solves)} solves in "
          f"{win.window_s:.3f} s, {win.chunk_steps} steps, and one after it from initial "
          f"condition {fresh_seed}; {errors} raised; peak {memory_peak} bytes; "
          f"card {power_limit()}; {card}", file=sys.stderr)
    for name, limit in limits.items():
        print(f"check {name} {worst.get(name)} limit {limit}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


def _number(value):
    """A reading as JSON takes it: a number, or its text where it is not
    finite (a NaN reads over every limit)."""
    return value if value is None or math.isfinite(value) else str(value)


if __name__ == "__main__":
    # the checkout's root, not this folder, heads the path: the harness's
    # modules are imported as ``portbench.*`` and shadow nothing
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())

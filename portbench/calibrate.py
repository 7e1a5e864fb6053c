"""The readings the correctness limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 [--control 3]

Sound runs: ``--seeds`` jobs of the cell through the timed path's own
call (``driver.Loop.job``: ``solver.run`` at the cell's sizes), from the
traffic's pool of initial conditions and, past its end, from further
seeds, each judged by ``check.Judge``; the largest reading
of each number over them is its lower reading. The control
(``--control``): the plain reference's own solve (``reference/evolve.py``)
in bfloat16, the precision below the configuration's f32, in the
program's place, on that many seeds, judged the same way; the smallest
reading of each number over them is its upper reading. One JSON line a
job on standard output. The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

# The control's precision: bfloat16, the step below the f32 that every
# configuration states, and so the lower precision a change to the program
# would be tempted to take.
CONTROL_DTYPE = "bfloat16"
# Each of the control's states stops after this many ``screen_update``
# chunks if its energy has not settled under the tolerance first: 40 × 500
# steps are an imaginary time of 60 or more in every configuration.
CONTROL_CHUNKS = 40


def sound(cell, raw, mix, config, device, seeds: int, base: int):
    import torch

    from portbench import check, driver, spec

    judge = check.Judge(raw, device)
    loop = driver.Loop(config, device)
    driver.warm_up(config, device, spec.solve_seed(base, -1))
    ics = spec.pool(mix)[:seeds]
    ics += [spec.solve_seed(base, k) for k in range(seeds - len(ics))]
    for k, ic in enumerate(ics):
        t0 = time.perf_counter()
        results = loop.job(ic)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        numbers = judge.solve(check.port_states(results))
        print(json.dumps({"cell": cell, "side": "program", "seed": ic, "k": k, "wall_s": wall,
                          "steps": [r.steps for r in results],
                          "energies": [str(r.observables.energy / r.observables.norm2)
                                       for r in results], **numbers}), flush=True)


def control(cell, raw, device, seeds: int, base: int):
    import torch

    from portbench import check, spec
    from portbench.reference import evolve

    judge = check.Judge(raw, device)
    dtype = getattr(torch, CONTROL_DTYPE)
    solver = evolve.Solver(raw, dtype, device)
    for k in range(seeds):
        t0 = time.perf_counter()
        states, lower, steps = [], [], []
        for w in range(int(raw["wavemax"]) + 1):
            psi, n = solver.solve_state(spec.solve_seed(base, 1000 * k + w), lower,
                                        CONTROL_CHUNKS)
            lower.append(psi)
            steps.append(n)
            states.append((psi if psi.shape[0] == 2 else psi[0], solver.observables(psi)))
        numbers = judge.solve(states)
        print(json.dumps({"cell": cell, "side": f"control {CONTROL_DTYPE}", "seed": base, "k": k,
                          "wall_s": time.perf_counter() - t0, "steps": steps,
                          "energies": [str(s[1]["energy"] / s[1]["norm2"]) for s in states],
                          **numbers}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--seed", type=int, default=2**31 + 7)
    args = p.parse_args(argv)
    import tempfile

    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.workload(spec.benchmark(), args.workload)
    mix = spec.traffic(cell["traffic"])
    raw = spec.run_raw(spec.configuration(cell["config"]), mix)
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        work = Path(work)
        (work / "input").mkdir()
        config = spec.port_config(raw, work)
        from wafer_torch.io import run_dir

        run_dir.check_output_dir(config.project_name, config.output_root)
        if args.seeds:
            sound(cell["name"], raw, mix, config, device, args.seeds, args.seed)
    if args.control:
        control(cell["name"], raw, device, args.control, args.seed)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())

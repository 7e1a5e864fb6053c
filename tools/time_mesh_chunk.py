#!/usr/bin/env python3
"""Time the host-bound mesh chunk on one CUDA card: 500-step 256³ Harmonic
chunks through ``parallel.ShardedOps`` on a (4, 2, 1) mesh with every shard
on the card (ground and per-step-norm, three of each; CUDA events), the
same per-step-norm chunk on one device (chip_smoke phase 3's, K1 + K2 a
step), and ``chip_smoke.mesh_step_vs_single``'s one S = 1 step (exchange,
eight K1, one K2) beside the single-device step.

    python3 tools/time_mesh_chunk.py [label]
    python3 tools/time_mesh_chunk.py --ab OTHER_ROOT [--pairs N]

The first form prints one JSON line of ms per step. At this size the
host's launches and face copies set the step time, so it spreads from run
to run on one card. The second compares this tree with the checkout at
OTHER_ROOT (this file is copied into its ``tools/``): N pairs of runs, each
a process of its own, in turns (other, this, this, other, ...), then one
JSON line a tree of the median and quartiles of every metric over all its
runs' samples.
"""

import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

METRICS = ("ground_ms_per_step", "psn_ms_per_step", "one_device_psn_ms_per_step",
           "mesh_step_ms", "single_step_ms")


def one_run(label):
    import torch

    import chip_smoke as cs
    from wafer_torch import geometry
    from wafer_torch.ops import _build, hopper_stencil as hs
    from wafer_torch.parallel import make_mesh
    from wafer_torch.parallel.sharded import ShardedOps

    if not torch.cuda.is_available():
        print("time_mesh_chunk: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    _build.library()
    steps = 500
    cfg = cs.smoke_config((256,) * 3, "Harmonic", 0.0375, 4e-4, steps)
    ops = ShardedOps(cfg, make_mesh((4, 2, 1), [dev] * 8), 0)
    blocks = ops.put(geometry.work_area(cs.harmonic_state(256, 0.0375, gen, dev), 1))
    ground = [cs.cuda_ms(lambda: ops.evolve_chunk(blocks, None, None, None), 1) / steps
              for _ in range(3)]
    psn = [cs.cuda_ms(lambda: ops.evolve_chunk_psn(blocks, None, None, None), 1) / steps
           for _ in range(3)]
    phi = cs.harmonic_state(256, 0.0375, gen, dev)
    an = ("Harmonic", 0.0375, 4e-4, 1.0, 256, 256, 256, 1.0, 0.0)
    one = [cs.cuda_ms(lambda: hs.evolve_chunk(phi, "ThreePoint", 4e-4, 0.0375, 1.0, steps, an,
                                               per_step_norm=True), 1) / steps
           for _ in range(3)]
    _diff, _red, mesh_ms, single_ms = cs.mesh_step_vs_single((4, 2, 1), gen, dev)
    print(json.dumps({"label": label, "ground_ms_per_step": ground,
                      "psn_ms_per_step": psn, "one_device_psn_ms_per_step": one,
                      "mesh_step_ms": mesh_ms, "single_step_ms": single_ms}))
    return 0


def quartiles(xs):
    q1, med, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return {"median": med, "q1": q1, "q3": q3, "n": len(xs)}


def ab(other, pairs):
    other = Path(other).resolve()
    (other / "tools").mkdir(exist_ok=True)
    shutil.copy(__file__, other / "tools" / Path(__file__).name)
    trees = {"other": other, "this": ROOT}
    samples = {label: {m: [] for m in METRICS} for label in trees}
    for i in range(pairs):
        for label in (("other", "this") if i % 2 == 0 else ("this", "other")):
            root = trees[label]
            out = subprocess.run([sys.executable, str(root / "tools" / Path(__file__).name), label],
                                 cwd=root, stdout=subprocess.PIPE, text=True, check=True).stdout
            run = json.loads(out.strip().splitlines()[-1])
            print(json.dumps(run), flush=True)
            for m in METRICS:
                samples[label][m] += run[m] if isinstance(run[m], list) else [run[m]]
    for label, root in trees.items():
        print(json.dumps({"tree": str(root), "label": label,
                          **{m: quartiles(samples[label][m]) for m in METRICS}}))
    return 0


def main(argv):
    if argv[:1] == ["--ab"]:
        pairs = int(argv[argv.index("--pairs") + 1]) if "--pairs" in argv else 10
        return ab(argv[1], pairs)
    return one_run(argv[0] if argv else "")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Time ``sync_update`` batching against the per-chunk loop on one CUDA
card, in turns: phase 4's 256³ harmonic config (``chip_smoke``'s
MAIN_PATH_CONFIG, ``delayed_gram: false``) through ``solver.run``, per
chunk (``sync_update: 1``) and batched (``sync_update: K``), alternately
(per chunk, batched, batched, per chunk, ...), every shard of a mesh on
the card.

    python3 tools/time_batched.py [--mesh X,Y,Z] [--states N] [--k K] [--pairs P]

Prints one JSON line per run (each state's wall seconds on the host clock
around its solve, ``solver.solve`` or on a mesh ``_solve_state``, chunk
seconds from ``SolveResult.chunk_seconds``, steps and the batch's
counters) and a last JSON line of the medians of each
state's wall and chunk seconds per mode. The host's clock spreads on a
machine that shares its cores, so compare the two modes only within one
call.
"""

import argparse
import json
import logging
import math
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv):
    import torch

    import chip_smoke as cs
    from wafer_torch import solver
    from wafer_torch.config import Config
    from wafer_torch.io import run_dir
    from wafer_torch.ops import _build
    from wafer_torch.parallel import make_mesh, solver_sharded

    ap = argparse.ArgumentParser(prog="time_batched.py")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--states", type=int, default=1)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_batched: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _build.library()
    shape = None if args.mesh is None else tuple(int(x) for x in args.mesh.split(","))
    text = (cs.MAIN_PATH_CONFIG.replace("wavemax: 1", f"wavemax: {args.states - 1}")
            + "delayed_gram: false\n")
    if shape is not None:
        text += "mesh: {x: %d, y: %d, z: %d}\n" % shape
    log = logging.getLogger("wafer")
    log.setLevel(logging.WARNING)
    runs = {1: [], args.k: []}
    order = []
    for p in range(args.pairs):
        order += [1, args.k] if p % 2 == 0 else [args.k, 1]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="wafer_torch_batched_") as tmp:
        os.chdir(tmp)
        try:
            for sync in order:
                with open("t.yaml", "w") as fh:
                    fh.write(text + f"sync_update: {sync}\n")
                cfg = Config.load("t.yaml")
                run_dir.reset_proj_date()
                run_dir.check_output_dir(cfg.project_name)
                mesh = None if shape is None else make_mesh(shape, [dev] * math.prod(shape))
                walls = []
                owner, name = (solver, "solve") if mesh is None else (solver_sharded,
                                                                      "_solve_state")
                orig = getattr(owner, name)

                def timed(*a, _orig=orig, **k):
                    t = time.perf_counter()
                    out = _orig(*a, **k)  # ends on a host read of the state's scalars
                    walls.append(time.perf_counter() - t)
                    return out

                setattr(owner, name, timed)
                try:
                    res = solver.run(cfg, log, device=dev, mesh=mesh)
                finally:
                    setattr(owner, name, orig)
                row = {"sync_update": sync, "mesh": shape,
                       "states": [{"wnum": r.wnum, "steps": r.steps, "wall_s": w,
                                   "chunk_s": r.chunk_seconds, "batch": r.batch}
                                  for r, w in zip(res, walls)]}
                runs[sync].append(row)
                print(json.dumps(row), flush=True)
        finally:
            os.chdir(cwd)

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    print(json.dumps({str(sync): [
        {"wnum": s, "wall_s": median([r["states"][s]["wall_s"] for r in rows]),
         "chunk_s": median([r["states"][s]["chunk_s"] for r in rows])}
        for s in range(args.states)] for sync, rows in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

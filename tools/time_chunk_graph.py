#!/usr/bin/env python3
"""Time one device's and a mesh's per-chunk chunks with and without the
chunk graphs (``wafer_torch/chunk_graph.py``), and what one capture costs,
on one CUDA card.

    python3 tools/time_chunk_graph.py [--eager-only] [--reps N]

Part 1: 500-step chunks (``hopper_stencil.evolve_chunk``) at 64×64×128,
128³ and 256³ (Harmonic, ThreePoint), ground and S = 1, and 500-step
chunks of phase 4's config on a (4, 2, 1) mesh on the card, each the host
wall of a chunk ended by a synchronise: eagerly (each chunk binds its own
launchers; in a tree without chunk graphs, its own loop), and kept by key
in a ``ChunkGraphs("graph")`` with ``GRAPH_STEPS`` 16, 64 and a whole
chunk (the segment then tiles the chunk's middle: ``graph_steps``). The
median of the chunks after the first two (a key's eager chunks) and the
key's capture ms. ``--eager-only`` times the eager chunks alone (another
tree's, for a comparison in turns).

Part 2 (not with ``--eager-only``): one 166-step segment of a 64×64×128
ground chunk captured by hand three times in this process, the host ms of
each phase (the capture stream made by ``torch.cuda.Stream`` from torch's
stream pool, or by ``chunk_graph.capture_stream`` through libcuda; the
launchers bound to it; ``capture_begin``; recording; ``capture_end``; a
replay's host call and its sync), then 8 chunks eager and through a
``ChunkGraphs``, each with its host enqueue ms, device ms (CUDA events)
and wall ms.

Prints one JSON line per measurement and a last JSON line of them all.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def noise_state(shape, seed, dev):
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(seed)
    w = F.pad(torch.randn(shape, generator=gen, device=dev), (1,) * 6)
    return (w / torch.sqrt((w * w).sum())).contiguous()


def chunk_walls(run, reps):
    """Host ms of ``reps`` calls of ``run()``, each ended by a synchronise."""
    import torch

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return walls


def variants(eager_only):
    return ["eager"] if eager_only else ["eager", 16, 64, 100000]


def graphs_for(variant):
    """A ChunkGraphs at GRAPH_STEPS ``variant``, or None (eager)."""
    if variant == "eager":
        return None
    from wafer_torch import chunk_graph

    chunk_graph.GRAPH_STEPS = variant
    chunk_graph.graph_steps.cache_clear()
    return chunk_graph.ChunkGraphs("graph")


def part1(dev, eager_only, reps, out):
    import torch

    import chip_smoke as cs
    from wafer_torch import geometry
    from wafer_torch.ops import hopper_stencil as hs
    from wafer_torch.parallel import make_mesh
    from wafer_torch.parallel.sharded import ShardedOps

    for shape, dn, dt in (((64, 64, 128), 0.15, 0.006), ((128, 128, 128), 0.075, 0.0016),
                          ((256, 256, 256), 0.0375, 0.0004)):
        an = ("Harmonic", dn, dt, 1.0, *shape, 1.0, 0.0)
        phi = noise_state(shape, 1, dev)
        low = noise_state(shape, 2, dev)[None]
        for mode in ("ground", "S1"):
            store = low if mode == "S1" else None
            for v in variants(eager_only):
                graphs = graphs_for(v)
                kw = {} if graphs is None else {"graphs": graphs}
                walls = chunk_walls(lambda: hs.evolve_chunk(
                    phi, "ThreePoint", dt, dn, 1.0, 500, an, store=store, **kw), reps)
                row = {"chunk": f"{shape[0]}x{shape[1]}x{shape[2]} {mode}", "variant": v,
                       "median_ms": sorted(walls[2:])[len(walls[2:]) // 2], "walls_ms": walls}
                if graphs is not None:
                    row.update(graphs.take_stats())
                    graphs.close()
                out.append(row)
                print(json.dumps(row), flush=True)
    cfg = cs.smoke_config((256,) * 3, "Harmonic", 0.0375, 0.0004, 500)
    phi = noise_state((256, 256, 256), 3, dev)
    for v in variants(eager_only):
        ops = ShardedOps(cfg, make_mesh((4, 2, 1), [dev] * 8), 0)
        ops.graphs = graphs_for(v)
        blocks = ops.put(geometry.work_area(phi, 1))
        walls = chunk_walls(lambda: ops.evolve_chunk(blocks, None, None, None), max(6, reps // 2))
        row = {"chunk": "(4, 2, 1) 256^3 ground", "variant": v,
               "median_ms": sorted(walls[2:])[len(walls[2:]) // 2], "walls_ms": walls}
        if ops.graphs is not None:
            row.update(ops.graphs.take_stats())
            ops.graphs.close()
        out.append(row)
        print(json.dumps(row), flush=True)


def part2(dev, out):
    import torch

    from wafer_torch import chunk_graph
    from wafer_torch.ops import hopper_stencil as hs

    shape, dn, dt = (64, 64, 128), 0.15, 0.006
    an = ("Harmonic", dn, dt, 1.0, *shape, 1.0, 0.0)
    phi = noise_state(shape, 4, dev)
    steps = 166
    for stream_from in ("torch pool", "libcuda"):
        for trial in range(3):
            chunk = hs.DeviceChunk(phi, "ThreePoint", 0.05, analytic=an)
            for t in range(3):  # the launches' one-time set-up, outside the timing
                chunk.step(chunk.eager, t, chunk.bufs[t % 2], chunk.bufs[(t + 1) % 2])
            torch.cuda.synchronize()
            marks = [time.perf_counter()]
            made = None
            if stream_from == "libcuda":
                made = chunk_graph.capture_stream(dev)
                stream = made.__enter__()
            else:
                stream = torch.cuda.Stream(dev)
            marks.append(time.perf_counter())
            launch = chunk.launchers(stream)
            marks.append(time.perf_counter())
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                graph.capture_begin()
                marks.append(time.perf_counter())
                for j in range(steps):
                    chunk.step(launch, 1 + j, chunk.bufs[j % 2], chunk.bufs[(j + 1) % 2])
                marks.append(time.perf_counter())
                graph.capture_end()
                marks.append(time.perf_counter())
            if made is not None:
                made.__exit__(None, None, None)
            graph.replay()
            marks.append(time.perf_counter())
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            names = ["stream", "launchers", "capture_begin", f"record {steps} steps",
                     "capture_end", "replay host", "replay sync"]
            row = {"capture": stream_from, "trial": trial,
                   **{n: (marks[i + 1] - marks[i]) * 1e3 for i, n in enumerate(names)}}
            out.append(row)
            print(json.dumps(row), flush=True)
    for variant in ("eager", 64):
        graphs = graphs_for(variant)
        rows = []
        for _ in range(8):
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            hs.evolve_chunk(phi, "ThreePoint", dt, dn, 1.0, 500, an,
                            **({} if graphs is None else {"graphs": graphs}))
            e1.record()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rows.append({"host_enqueue_ms": (t1 - t0) * 1e3, "device_ms": e0.elapsed_time(e1),
                         "wall_ms": (t2 - t0) * 1e3})
        row = {"chunks": "64x64x128 ground", "variant": variant, "per_chunk": rows}
        if graphs is not None:
            row.update(graphs.take_stats())
            graphs.close()
        out.append(row)
        print(json.dumps(row), flush=True)


def main(argv):
    import torch

    ap = argparse.ArgumentParser(prog="time_chunk_graph.py")
    ap.add_argument("--eager-only", action="store_true")
    ap.add_argument("--reps", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_chunk_graph: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from wafer_torch.ops import _build

    dev = torch.device("cuda", 0)
    _build.library()
    out = []
    part1(dev, args.eager_only, args.reps, out)
    if not args.eager_only:
        part2(dev, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

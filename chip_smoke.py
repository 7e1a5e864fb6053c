#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure raises and the script exits non-zero):

1. Card, versions, and the build of ``wafer_torch/csrc`` with nvcc; the
   main paths' sweep instantiations (MAIN_SWEEPS: K1 at ThreePoint with
   S = 0..2, K3 with S = 0, 1, K1 bf16 with S = 1, 2, K1's costly-B kernels
   alike) must spill nothing
   and fit by their registers the blocks an SM their launch bounds ask
   for, each printed with its registers, spills and blocks an SM.
2. Each CUDA kernel against its plain torch version on the card: orders
   3/5/7 × analytic B for the five potential kinds and streamed B × 0, 1
   or 2 stored states × identity and non-identity coefficients, on a
   64×64×128 grid, plus one 256³ case. Tolerances (f32 reordering):
   ψ' ≤ 1e-6·max|ψ'|; ‖ψ'‖² ≤ 1e-5 relative; ⟨l|ψ'⟩ ≤ 1e-5 of ‖l‖·‖ψ'‖.
   Then the grids that do not fill the sweep's 16 × 32 tiles (RAGGED: odd
   extents, one smaller than a tile, one with fewer x-planes than a
   segment) × the orders × the kinds × S = 0..5 (RAGGED_MODES), and two
   launches on the same input, which must agree bit for bit.
   Then K1 with Coulomb and SimpleCornell B (its kernel's B from one rsqrt,
   the plain version's from IEEE sqrt and divides) at the examples' dn and
   dt: the core inside even, odd and mixed grids and at shard origins,
   ThreePoint and SevenPoint, S = 0..2 with f32 and bf16 stored states
   (COSTLY_B_BLOCKS, COSTLY_B_MODES), at the same tolerances.
3. 500-step ground, per-step-norm and excited (S = 1) chunks at 256³
   through the kernels and through the plain torch ops, timed with CUDA
   events; ψ ≤ 1e-4·max|ψ| and ‖ψ‖² ≤ 1e-4 relative after 500 steps.
2e. K2 (``csrc/finish_coef.cu``) against its plain version on partial rows
    FINISH_ROWS × columns FINISH_NRED (reductions and coefficients within
    1e-5 relative), two launches on the same partials bit for bit, and
    1,000 launches in a row against a fresh launch (the ticket resets). Then device times with the device held (``held_times``: K2 is
    shorter than its host enqueue, so ``cuda_ms`` would time the host): K2,
    K2 as one block and ``partials.sum(dim=0)``, at 512³'s 16,384 rows
    (n_red 1-3), 256³'s 2,048 (n_red 1, 2) and 100,003; and the host µs a
    call of the chunk's bound launcher and of ``finish_coef``.
4. The main path: ``wafer_torch.cli.main`` on a 256³ f32 Harmonic config,
   ground and first excited state, |E − oracle| < 5e-3, with launch
   counters showing that the kernels ran and the plain sweep did not.

The complex-ψ slice adds, for the CUDA pair sweep K3 (re, im pairs):

2b. K3 (and K2 on its 1 + 2S partials) against the plain versions:
    orders 3/5/7 × ComplexHarmonic and ComplexCoulomb analytic B and
    streamed (Br, Bi) × S = 0, 1, 2 × identity and non-identity
    coefficients on 64×64×128, plus one 256³ case; the tolerances of 2;
    the ragged grids and the repeat launches of 2 for K3.
3b. 500-step 256³ complex chunks (ground analytic, ground streamed,
    per-step-norm, excited S = 1), kernel against the plain split ops;
    the tolerances of 3.
4b. The complex main path through ``wafer_torch.cli.main``: a 256³
    ComplexHarmonic run (absorb 0.2) with E₀ and E₁ within 5e-3 of
    (n + 3/2)·√(1 + 0.2i) in Re and in Im, and
    ``examples/complex_cornell.yaml`` as it stands (ComplexFullCornell
    256³, streamed B), which must converge with Im E > 0 and Im/Re within
    20 % of 0.2. K3 must launch and the plain split sweep must not run.

The large-grid slice (multigrid to 512³, where the reference runs its
large-grid kernels B4–B6; on the card K1 + K2 compute their chunks) adds:

2c. K1 (and K2 on its partials) against the plain versions at 512³
    ThreePoint: analytic Harmonic and streamed B × S = 0 (without and with
    the coefficients), 1 and 2; the tolerances of 2. Per-launch times of
    K1 at 512³, each beside its bound (K2's are 2e's).
3c. 100-step 512³ chunks, one per dispatch the reference sends to B4–B6:
    ground analytic (B6), ground streamed (B5), per-step-norm ground (B4,
    S = 0), excited S = 1 and S = 2 (B4); kernel against the plain ops,
    timed with CUDA events; the tolerances of 3.
4c. The multigrid main path through ``wafer_torch.cli.main``:
    ``examples/multigrid_512.yaml`` as it stands (128³ → 256³ → 512³,
    |E₀ − 1.5| < 5e-3), and the same file with ``wavemax: 1``
    (|E₁ − 2.5| < 1e-2). K1 must launch at every level and the plain sweep
    must not run; each level and state prints its steps, wall time, chunk
    time (CUDA events) and grid-point updates per second.

The sharded slice (a single-process device mesh, every shard a block on
the one card, where the reference runs its mesh kernels B12–B15 and the
sharded modes of B2/B5/B8; on the card K1 and K3 take the block's global
origin) adds:

2d. K1 and K3 with an origin on each shard block of a (4, 2, 1) mesh of a
    64×64×128 grid against their plain versions: orders 3/5/7 × the five
    real analytic kinds and streamed B (K1), ComplexHarmonic,
    ComplexCoulomb and streamed (Br, Bi) (K3) × S = 0 (with and without
    the coefficients), 1, 2, and the ragged grids of 2 at an origin inside
    a larger grid; the tolerances of 2. Then one sharded step
    (halo exchange, K1 per shard with S = 1 into its rows of one partials
    buffer, one K2) on (4, 2, 1) and (8, 1, 1) meshes at 256³ against the
    single-device step on the whole grid, Coulomb (its pole on a seam of
    the 8-way mesh): ψ′ bit for bit, reductions within 1e-12 relative.
3d. 100-step 512³ chunks through ``parallel.ShardedOps`` on (8, 1, 1) and
    (4, 2, 1) meshes, all shards on the card, against the single-device
    chunk: ground analytic, ground streamed and complex ground analytic
    bit for bit, per-step-norm and excited S = 1 within the tolerances of
    3; each mesh ms/step beside the single-device ms/step, the bound and
    the halo exchange alone.
4d. The sharded main path through ``solver.run(config, mesh=...)`` with
    eight or four shards on the card: ``examples/multigrid_sharded_512.yaml``
    as it stands (|E₀ − 1.5| < 5e-3; 128³ and 256³ on one device, 512³ on
    an (8, 1, 1) mesh), phase 4's config on a (4, 2, 1) mesh and phase 4b's
    on a (2, 2, 1) mesh, each held to its oracle, to phase 4/4b's step
    counts within one chunk and energies within 1e-5. K1 (K3) launches on
    every sharded state, K2 on every state whose chunks reduce, and the
    plain sweeps never run.

The multi-slice slice (the reference's ``(slice, gx, gy, gz)`` mesh on one
process: x faces exchanged once per window of ``slice_update`` steps into
halos that deep, every shard on the card; K1/K3 sweep deep blocks with a
reduction window and zero the planes outside the grid) adds:

2f. K1 and K3 with a reduction window (the middle half of the planes) and
    x origins that put planes below the grid, none outside it, or planes
    past its end, against their plain versions: RAGGED × orders × Coulomb
    and streamed B × S = 0..2 with and without the coefficients, and
    136 × 256 × 512 deep blocks (a 2 × (2, 2, 1) shard of 512³ with 4-deep
    pads) at x origins −4, 124 and 380; the tolerances of 2, the planes
    outside the grid exactly zero, repeats bit for bit, and the full window
    (0, nx) the default launch bit for bit.
3e. 100-step 512³ chunks through ``MultiSliceOps`` on 2 × (2, 2, 1)
    (Coulomb ground, per-step-norm, S = 1) and ``MultiSliceSplitOps`` on
    2 × (2, 1, 1) (ComplexHarmonic ground) against one device: ground
    chunks bit for bit, the others within the tolerances of 3; each ms/step
    beside the flat (4, 2, 1) / (4, 1, 1) chunk, one device, the bound (the
    deep sweeps' recomputed planes and the exchanges included) and the x
    exchange of one window alone.
4e. ``solver.run`` on ``make_multislice_mesh(…, [cuda:0] * n)``: phase 4's
    config on 2 × (2, 2, 1) and 4b's on 2 × (2, 1, 1), each state within
    5e-3 of its oracle and within 1e-5 and 500 steps of one device, K1/K3
    launched in every state, K2 in the excited ones, the plain sweeps never.
4f. The diagnostics: a 128³ harmonic run through ``cli.main`` with
    ``trace_dir``, whose Chrome trace must hold K1's kernel events and the
    loop's spans, and the loop's wall split from it into chunk kernels,
    measure kernels, the host read and Python between launches; a traced
    64³ complex harmonic run of two states, whose trace must name K3 and
    K2; then ``debug_nans`` with ψ set to NaN by the second chunk must
    raise NonFiniteError naming that chunk.

The batching slice (``sync_update > 1``: k chunks a host read, the verdict
on the card, a CUDA graph of one chunk iteration replayed k times, and a
done flag in K1/K2/K3 that makes the chunks after the verdict do nothing)
adds:

2g. K1 and K3 with a batch's done flag, on RAGGED × Coulomb and streamed
    B × S = 0..3 and at 256³ (S = 0, 1): the flag clear is the launch
    without it bit for bit (ψ' and partial rows), the flag set writes
    nothing (ψ' and the rows keep a sentinel); K2 on 7 to 100,003 rows:
    the flag clear is the default launch bit for bit, flagged launches
    leave ``red``, ``coef`` and the ticket as they were, and a live launch
    after them is within 1e-5 of the plain version with the ticket zero.
    Then a 500-step 256³ chunk (K1 ground, K1 + K2 at S = 1, K3 ground)
    captured as a CUDA graph, replayed with the flag clear and set: the
    device ms of a working and of an idle chunk.
4g. Each main path per chunk (``delayed_gram: false``, which batching
    turns off) and with ``sync_update: 8``: phase 4's 256³ E₀ + E₁, 4b's
    complex harmonic, ``examples/multigrid_512.yaml`` (peak allocated
    memory at each level), phase 4's config on (4, 2, 1) and 4f's 128³;
    every state at the same steps with E/N within 1e-12 relative, the
    batch's iterations run under ``torch.cuda.set_sync_debug_mode("error")``
    (nothing reads the card before the batch's one read), graphs captured,
    K1/K3 launched and the plain sweeps never; each state's walls, chunk
    times, device ms a chunk, idle chunks, captures and capture ms, and
    whether the two runs agree bit for bit. Then 4f's traced 128³ run
    batched, its loop's wall split as 4f splits it.

The multi-process slice (``WAFER_COORDINATOR``: ranks started as fresh
interpreters by ``start_ranks``, each with the env trio, a free port on
127.0.0.1, its own directory and a timeout; on one card the ranks share
it, so the data travels over gloo with CUDA tensors staged through pinned
host buffers) adds:

3h. 100-step 256³ chunks (phase 4's harmonic, K1 ground and S = 1 with
    K2 over the gathered rows) on a flat (2, 1, 1) mesh over two ranks and
    on 2 × (2, 2, 1) with a slice a rank, against the single-process chunk
    on the same mesh: ψ bit for bit on both ranks (SHA-256), the measure's
    sums within 1e-12 relative; ms/step and the exchange alone on each
    rank beside one process's; which gloo collectives take CUDA tensors as
    they are (``probe_gloo_cuda``).
4h. ``wafer_torch.cli`` as two ranks on the card (each rank's device list
    its card four, two or one times): phase 4's config on 2 × (2, 2, 1)
    (E₀, E₁), 4b's complex harmonic on 2 × (2, 1, 1) (E₀) and phase 4's on
    a flat (2, 1, 1) (E₀), each within 5e-3 of its oracle, at the steps of
    the single-process run on the same mesh (4e's; a run of its own for
    the flat mesh) with E/N within 1e-12 relative, K1/K3 launched on every
    rank, the plain sweeps never, and only rank 0's output directory. With
    two cards or more 4h.1 runs again over NCCL, a card a rank.

The bf16 stored-state slice (``WAFER_EXC_STREAM``, default ``bf16``: the
stored states stream in bf16 on one device and on meshes that shard one
axis, through K1's bf16 sweep (``csrc/stencil_sweep_bf16.cu``), counted
as ``sweep_step_bf16``;
phases 4, 4c, 4g and 4h's flat run take it by default, 3h adds a
2 × (2, 1, 1) S = 1 chunk whose deep pads cross the ranks as bf16 bytes)
adds:

2i. K1 with a bf16 store against its plain version on the same bf16
    values, the tolerances of 2: orders 3/5/7 × Harmonic, Coulomb and
    streamed B × S = 1, 2, 3 (3: the run-time count) × identity and not on
    64×64×128, one 256³ case, the RAGGED grids with and without a block
    origin, reduction windows with planes outside the grid; repeats bit
    for bit; the done flag (clear: the default launch bit for bit; set:
    nothing written) on the RAGGED grids and 64×64×128; and the bf16
    launch bit for bit the f32 launch on the same values (upcast), ψ' and
    partial rows, orders 3/5/7 × S = 1..3 × the RAGGED grids (odd padded
    rows) and 64×64×128, without an origin, with one whose oz is odd, and
    with one and a reduction window.
3i. K1 S = 1 per launch at 256³ with bf16 and f32 stores; 500-step 256³
    S = 1 and 100-step 512³ S = 1 and S = 2 chunks, each stream against the
    plain chunk on its values (the tolerances of 3), and the (8, 1, 1)
    512³ S = 1 mesh chunk against one device on the same streams; each
    ms/step beside its bound with 2- or 4-byte stored states and its share
    of it (bound ÷ time).
4i. Phase 4 again with ``WAFER_EXC_STREAM=f32``: E₀ the same, E₁ within
    1e-5 of phase 4's bf16 E₁, no bf16 launch; one 500-step chunk from the
    converged E₁ with the converged E₀ stored, whose overlap with the f32
    store (``solver._max_rel_overlap``) is printed for both streams (bf16
    at most 10× f32's or 1e-6); ``multigrid_512.yaml`` with ``wavemax: 1``
    with f32 streams beside 4c's bf16 run, both E₁ within 1e-2 of 2.5.

The per-chunk path as one device program (``wafer_torch/chunk_graph.py``:
on one card each chunk's steps replayed from a CUDA graph captured once a
key) adds:

4j. The per-chunk runs of ``examples/harmonic_ground.yaml``,
    ``harmonic_excited.yaml``, ``cornell.yaml``, ``complex_harmonic.yaml``
    and ``coulomb_states.yaml`` through the CLI, each state's route,
    wall, chunk seconds, captures and their host ms and replays printed
    beside those of phase 4's 256³ E₀/E₁, 4b's runs, 4d's (4, 2, 1) and
    4e's runs and 4f's traced 128³ run (and 4f's share of the loop's wall
    spent in Python between launches); every state of every per-chunk run
    on the card must take the graph route, and every state of six chunks
    or more must capture or replay a segment (a key's first two chunks
    run eagerly).
    ``python3 tools/compare_launches.py --other <tree> --solves --walls
    --pairs N`` holds these runs' states bit for bit against another tree
    and times both trees' walls in alternating processes.

K1's many-state slice (three and four stored states on kernels of their
own, csrc/stencil_sweep_many.cu) and the wide route (K1 with five stored
states or more, K3 with three stored pairs or more, the count read at run
time: csrc/stencil_sweep_wide.cu) add to phase 1 their kernels (two
blocks an SM, no spill; the wide route's blocks an SM and depth with its
shared memory at each count, and the most stored states its rings hold at
each order), to phases 2 and 2i (f32, bf16 stores)
``many_state_cases`` with S = 3, 4, 5, 6, 8, 9 (MANY_S) and their 256³
times beside the bound (``many_state_times``), to phase 2b K3 with S = 3,
4, 5 (``pair_wide_cases``, ``pair_wide_times``), and:

2w. ``wide_cap_cases``: the wide route (K1 f32 and bf16, K3) at each order
    with as many stored states as its rings hold, one more and (ThreePoint)
    WIDE_FAR more, the states past the rings read where they are used,
    against the plain version; windows, repeats, the done flag and bf16 =
    f32 on its values past the cap.

4k. ``wafer_torch.cli.main`` on SIX_STATE_CONFIG (phase 4's 256³ box,
    ``wavemax: 5``, a seeded Gaussian IC) with bf16 and with f32 streams:
    every level within 5e-3 of 1.5, 2.5, 2.5, 2.5, 3.5, 3.5, the two
    streams' energies within 1e-5, the many-state kernels and the wide
    route of the stream launched and the plain sweep never; each state's
    launches printed (the fourth with S = 3, the fifth with S = 4, the
    sixth with S = 5).
4l. ``wafer_torch.cli.main`` on COMPLEX_HARMONIC_CONFIG with
    ``wavemax: 3``: four complex states within 5e-3 of
    (n + 3/2)·√(1 + 0.2i) in Re and Im, the fourth on K3's wide route
    (S = 3), the plain sweeps never.

    python3 chip_smoke.py --example examples/sharded_512.yaml --mesh 8,1,1
    python3 chip_smoke.py --example examples/multislice_512.yaml --mesh 2,2,1 --no-save
    python3 chip_smoke.py --example examples/multislice_512.yaml --mesh 4,2,1 --slices 1 --no-save
    python3 chip_smoke.py --example examples/multislice_512.yaml --mesh 2,2,1 --procs 2 --no-save

runs one example through the sharded main path alone (after phase 1) and
prints its states; the mesh takes the file's ``mesh.slices`` unless
``--slices`` says otherwise (1: the flat mesh); ``--procs N`` runs it
through the CLI as N ranks on the card, the mesh's shards dealt out
equally.

Each main-path run resets the launch counters just before it and reads
them just after. A bound is the least time of the same work, whatever
kernel does it: ψ read and ψ' written once, B and each stored state read
once, over the card's byte rate (or its f32 rate, if larger); K2's counts
the partial rows the sweep's launch wrote. The long kernels (K1, K3,
chunks) are timed with CUDA events around back-to-back calls
(``cuda_ms``); K2 with the device held (``held_times``). Prints the card's name and power
limit, a JSON line of the chunk timings, a JSON line of per-kernel results
(time, plain time, bound, library call, launches on the main paths), and
as its last line the device summary JSON.
"""

import cmath
import contextlib
import hashlib
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
import types

from portbench import bytes as _bytes
from portbench.bytes import (  # noqa: F401  the bytes model behind every bound here
    HBM_BYTES_PER_S, finish_work, step_bound_ms, sweep_work)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


# The main paths' sweep instantiations, (kernel, EXT, S), and the blocks an
# SM must hold of each: K1 at ThreePoint with S = 0..2, K3 with S = 0 and
# 1, K1's bf16 sweep with S = 1 and 2, each of K1's with its costly-B
# kernel (Coulomb, SimpleCornell, Periodic) too, as their launch bounds ask
# (min_blocks in csrc/stencil_sweep.cu and stencil_sweep_bf16.cu,
# kMinBlocks in split_sweep.cu and stencil_sweep_many.cu), K1 at S = 0 as
# nvcc fits it without a bound, and K1's many-state kernels (f32 and bf16
# stores, S = 3 and 4, a kernel each) with two blocks an SM, three for the
# costly kinds' S = 3 (min_blocks in csrc/stencil_sweep_many.cu). Phase 1
# requires each, with and without the plane checks, to spill nothing and to
# fit that many blocks an SM by its registers.
MAIN_SWEEPS = {("sweep_step_kernel", 1, 0): 3, ("sweep_step_kernel", 1, 1): 3,
               ("sweep_step_kernel", 1, 2): 3, ("sweep_step_sc_kernel", 1, 0): 2,
               ("sweep_step_sc_kernel", 1, 1): 2, ("sweep_step_bf16_kernel", 1, 1): 3,
               ("sweep_step_bf16_kernel", 1, 2): 3, ("sweep_step_costly_kernel", 1, 0): 3,
               ("sweep_step_costly_kernel", 1, 1): 3, ("sweep_step_costly_kernel", 1, 2): 3,
               ("sweep_step_bf16_costly_kernel", 1, 1): 3,
               ("sweep_step_bf16_costly_kernel", 1, 2): 3,
               **{(k, 1, s): 3 if "costly" in k and s == 3 else 2
                  for k in ("sweep_step_many_kernel", "sweep_step_bf16_many_kernel",
                            "sweep_step_many_costly_kernel", "sweep_step_bf16_many_costly_kernel")
                  for s in (3, 4)}}
# The wide route's kernels (csrc/stencil_sweep_wide.cu): the stored-state
# counts each takes, read at run time
WIDE_S = {"sweep_step_wide_kernel": "5+", "sweep_step_bf16_wide_kernel": "5+",
          "sweep_step_sc_wide_kernel": "3+"}
MAIN_SWEEPS.update({(k, 1, s): 2 for k, s in WIDE_S.items()})
SWEEP_THREADS = {"sweep_step_kernel": 256, "sweep_step_bf16_kernel": 256,
                 "sweep_step_sc_kernel": 512, "sweep_step_costly_kernel": 256,
                 "sweep_step_bf16_costly_kernel": 256, "sweep_step_many_kernel": 256,
                 "sweep_step_bf16_many_kernel": 256, "sweep_step_many_costly_kernel": 256,
                 "sweep_step_bf16_many_costly_kernel": 256, "sweep_step_wide_kernel": 256,
                 "sweep_step_bf16_wide_kernel": 256, "sweep_step_sc_wide_kernel": 256}
SWEEP_NAMES = {"sweep_step_kernel": "K1 f32", "sweep_step_bf16_kernel": "K1 bf16",
               "sweep_step_sc_kernel": "K3", "sweep_step_costly_kernel": "K1 f32 costly B",
               "sweep_step_bf16_costly_kernel": "K1 bf16 costly B",
               "sweep_step_many_kernel": "K1 f32 many-state",
               "sweep_step_bf16_many_kernel": "K1 bf16 many-state",
               "sweep_step_many_costly_kernel": "K1 f32 many-state costly B",
               "sweep_step_bf16_many_costly_kernel": "K1 bf16 many-state costly B",
               "sweep_step_wide_kernel": "K1 f32 wide",
               "sweep_step_bf16_wide_kernel": "K1 bf16 wide",
               "sweep_step_sc_wide_kernel": "K3 wide"}


def ptxas_report(log):
    """{mangled kernel: {"registers", "spill_stores", "spill_loads"}} from
    the ``-Xptxas -v`` report in a build log (``_build.build``'s ``.log``)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "spill_stores": 0, "spill_loads": 0}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if name is not None and m:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m[1]), int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if name is not None and m:
            out[name]["registers"] = int(m[1])
    return out


def sweep_instance(name):
    """(kernel, EXT, S, plane checks) of a sweep kernel's mangled name (a
    wide-route kernel's S is WIDE_S's, the counts it takes, with " past the
    rings" for its kernel of the states its rings do not hold; S -1: a tree
    before it, whose run-time count was a template argument), or None for
    another kernel."""
    m = re.search(r"(sweep_step(?:_sc|_bf16)?_wide_kernel)ILi(\d+)ELb([01])E(?:Lb([01])E)?", name)
    if m is not None:
        over = " past the rings" if m[4] == "1" else ""
        return m[1], int(m[2]), WIDE_S[m[1]] + over, m[3] == "1"
    m = re.search(r"(sweep_step(?:_sc|_bf16)?(?:_many)?(?:_costly)?_kernel)ILi(\d+)ELi(n?\d+)"
                  r"ELb([01])E", name)
    if m is None:
        return None
    return m[1], int(m[2]), int(m[3].replace("n", "-")), m[4] == "1"


def blocks_per_sm(registers, threads):
    """Blocks of ``threads`` threads an H100 SM holds by their registers
    (65,536 an SM, given to a warp in units of 256) and threads (2,048)."""
    per_warp = -(-registers * 32 // 256) * 256
    return min(65536 // per_warp // (threads // 32), 2048 // threads)


def register_check(log):
    """The main paths' sweeps in a build log (MAIN_SWEEPS, both forms; K1's
    at EXT 1 also have a form without the unroll): rows (kernel, EXT,
    S, plane checks, registers, spill bytes, blocks an SM, blocks asked),
    and the failures: the rows that spill or hold fewer blocks than asked,
    and each (kernel, EXT, S, plane checks) missing from the log."""
    rows = []
    for name, rep in sorted(ptxas_report(log).items()):
        inst = sweep_instance(name)
        if inst is None or inst[:3] not in MAIN_SWEEPS:
            continue
        spill = rep["spill_stores"] + rep["spill_loads"]
        blocks = blocks_per_sm(rep["registers"], SWEEP_THREADS[inst[0]])
        rows.append((*inst, rep["registers"], spill, blocks, MAIN_SWEEPS[inst[:3]]))
    failed = [r for r in rows if r[5] > 0 or r[6] < r[7]]
    found = {r[:4] for r in rows}
    failed += [(*key, win, "missing") for key in MAIN_SWEEPS for win in (False, True)
               if (*key, win) not in found]
    return sorted(rows), failed


def wide_occupancy(pair, bf16, ext, n_store, streamed=False):
    """(blocks an SM, dynamic shared bytes, stored states in its rings) of
    the wide route's launch at EXT ``ext`` with ``n_store`` stored states
    (``pair``: K3's; else K1's, ``bf16`` on a bf16 store), B ``streamed`` or
    from coordinates, from the card's occupancy calculator."""
    from wafer_torch.ops import hopper_stencil as hs

    return hs.wide_layout(pair, bf16, ext, n_store, streamed)


def wide_cap(pair, bf16, ext, streamed):
    """The most stored states the wide route's rings hold at EXT ``ext``
    (past them a launch reads the rest where they are used)."""
    from wafer_torch.ops import hopper_stencil as hs

    s = hs.wide_min(pair)
    while wide_occupancy(pair, bf16, ext, s + 1, streamed)[2] == s + 1:
        s += 1
    return s


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


_CYCLES_PER_MS = []  # torch.cuda._sleep's cycles per millisecond, measured once


def held_times(fn, n=100):
    """(device µs, host µs) per call of ``fn``, for kernels shorter than
    their host enqueue, where ``cuda_ms`` would time the host. A
    ``torch.cuda._sleep`` holds the device while the host enqueues ``n``
    calls (≤ 200, so the launch queue never fills), timed with
    ``time.perf_counter``: the host µs. CUDA events recorded after the sleep
    and after the n calls then time the device alone running them back to
    back. If the start event has completed by the time the host is done,
    the sleep ran out too early, and the measurement is taken again with a
    longer one."""
    import torch

    fn()
    torch.cuda.synchronize()
    if not _CYCLES_PER_MS:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        b.synchronize()
        _CYCLES_PER_MS.append(1e7 / a.elapsed_time(b))
    hold_ms = 5.0
    for _ in range(6):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(hold_ms * _CYCLES_PER_MS[0]))
        t0.record()
        h = time.perf_counter()
        for _ in range(n):
            fn()
        host = time.perf_counter() - h
        t1.record()
        held = not t0.query()
        t1.synchronize()
        if held:
            return t0.elapsed_time(t1) * 1e3 / n, host * 1e6 / n
        hold_ms = max(2.0 * hold_ms, 3e3 * host)
    raise RuntimeError("chip_smoke: the device could not be held for the host's enqueue")


def largest_error(errs):
    """The largest error, or inf if any is NaN (max() can step over one)."""
    errs = list(errs)
    return math.inf if any(math.isnan(e) for e in errs) else max(errs)


def bound(work):
    """(bound_ms, bound_by) of ``work`` = (bytes, flops): ``portbench.bytes.bound`` in ms."""
    seconds, by = _bytes.bound(work)
    return seconds * 1e3, by


def padded_noise(shape, ext, gen, dev):
    import torch
    import torch.nn.functional as F

    return F.pad(torch.randn(shape, generator=gen, device=dev), (ext,) * 6)


def analytic_for(kind, n):
    """(kind, dn, dt, mass, nx, ny, nz, sig, vshift) with sensible physics."""
    if kind == "SimpleCornell":
        return (kind, 0.35, 0.004, 4.65, *n, 0.223, 18.0)
    return (kind, 0.2, 0.004, 1.0, *n, 1.0, 0.0)


def kernel_vs_plain(order, kind, n_store, identity, n, gen, dev, stream=None):
    """One K1 + K2 case on the card against the plain versions; ``stream``
    (a dtype) casts the stored states, which both then read.
    Returns (ψ' abs err, ψ' rel err, reduction rel err, K2 abs err)."""
    import torch

    from wafer_torch import geometry
    from wafer_torch.ops import hopper_stencil as hs

    ext = geometry.EXT[order]
    psi = padded_noise(n, ext, gen, dev)
    store = None
    if n_store:
        store = torch.stack([padded_noise(n, ext, gen, dev) for _ in range(n_store)])
        store = store / torch.sqrt((store * store).sum(dim=(1, 2, 3), keepdim=True))
        store = store.to(stream or store.dtype)
    analytic = b_int = None
    if kind == "streamed":
        b_int = (1.0 / (1.0 + 0.002 * torch.rand(n, generator=gen, device=dev))).contiguous()
    else:
        analytic = analytic_for(kind, n)
    coef = torch.zeros(1 + n_store, device=dev)
    coef[0] = 1.0
    if not identity:
        coef = torch.tensor([0.9] + [0.05 * (s + 1) for s in range(n_store)], device=dev)
    apply = n_store > 0 or not identity  # ground mode: no correction, no sums
    _o, _c, _cc, k = geometry.stencil_coefficients(order)
    scale = 0.004 / (k * 0.2 * 0.2)
    kw = dict(order=order, scale=scale, analytic=analytic, b_int=b_int, store=store,
              apply_coef=apply)
    out_k, out_p = torch.empty_like(psi), torch.empty_like(psi)
    part_k = part_p = None
    if apply:
        part_k = torch.empty(hs.num_partials(psi, order), 1 + n_store,
                             dtype=torch.float64, device=dev)
        part_p = torch.empty(1, 1 + n_store, dtype=torch.float64, device=dev)
    hs.sweep_step(psi, out_k, coef, part_k, **kw)
    hs.sweep_step_plain(psi, out_p, coef, part_p, **kw)
    torch.cuda.synchronize()
    psi_abs = (out_k - out_p).abs().max().item()
    psi_rel = psi_abs / out_p.abs().max().item()
    red_rel = k2_abs = 0.0
    if apply:
        red_k = torch.empty(1 + n_store, dtype=torch.float64, device=dev)
        red_p, red_q = torch.empty_like(red_k), torch.empty_like(red_k)
        c_k, c_p = torch.empty_like(coef), torch.empty_like(coef)
        hs.finish_coef(part_k, red_k, c_k)
        hs.finish_coef_plain(part_p, red_p, c_p)
        hs.finish_coef_plain(part_k, red_q, c_p)  # same partials, plain order
        torch.cuda.synchronize()
        n2 = red_p[0].item()
        scale_s = [n2] + [n2 ** 0.5] * n_store  # ‖l_s‖ = 1
        red_rel = largest_error(abs(a - b) / s
                                for a, b, s in zip(red_k.tolist(), red_p.tolist(), scale_s))
        k2_abs = (red_k - red_q).abs().max().item()
    return psi_abs, psi_rel, red_rel, k2_abs


def pair_kernel_vs_plain(order, kind, n_store, identity, n, gen, dev):
    """One K3 + K2 case on the card against the plain versions. Returns
    (ψ' abs err, ψ' rel err, reduction rel err, K2 abs err)."""
    import torch

    from wafer_torch import geometry
    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs

    ext = geometry.EXT[order]

    def pair():
        return torch.stack([padded_noise(n, ext, gen, dev) for _ in range(2)])

    psi = pair()
    store = None
    if n_store:
        store = torch.stack([pair() for _ in range(n_store)])
        store = store / torch.sqrt((store * store).sum(dim=(1, 2, 3, 4), keepdim=True))
    analytic = b2 = None
    if kind == "streamed":
        d = 1.0 + 0.002 * torch.rand(n, generator=gen, device=dev)
        di = 0.0004 * torch.rand(n, generator=gen, device=dev)
        mag = d * d + di * di
        b2 = torch.stack([d / mag, -di / mag]).contiguous()
    else:
        analytic = (kind, 0.2, 0.004, 1.0, *n, 1.0, 0.0, 0.2)
    n_red = 1 + 2 * n_store
    coef = torch.zeros(n_red, device=dev)
    coef[0] = 1.0
    if not identity:
        coef = torch.tensor([0.9] + [0.05 * (s + 1) for s in range(2 * n_store)], device=dev)
    apply = n_store > 0 or not identity
    _o, _c, _cc, k = geometry.stencil_coefficients(order)
    scale = 0.004 / (k * 0.2 * 0.2)
    kw = dict(order=order, scale=scale, analytic=analytic, b2=b2, store=store, apply_coef=apply)
    out_k, out_p = torch.empty_like(psi), torch.empty_like(psi)
    part_k = part_p = None
    if apply:
        part_k = torch.empty(hsp.num_partials(psi, order), n_red, dtype=torch.float64, device=dev)
        part_p = torch.empty(1, n_red, dtype=torch.float64, device=dev)
    hsp.sweep_step_sc(psi, out_k, coef, part_k, **kw)
    hsp.sweep_step_sc_plain(psi, out_p, coef, part_p, **kw)
    torch.cuda.synchronize()
    psi_abs = (out_k - out_p).abs().max().item()
    psi_rel = psi_abs / out_p.abs().max().item()
    red_rel = k2_abs = 0.0
    if apply:
        red_k = torch.empty(n_red, dtype=torch.float64, device=dev)
        red_p, red_q = torch.empty_like(red_k), torch.empty_like(red_k)
        c_k, c_p = torch.empty_like(coef), torch.empty_like(coef)
        hs.finish_coef(part_k, red_k, c_k)
        hs.finish_coef_plain(part_p, red_p, c_p)
        hs.finish_coef_plain(part_k, red_q, c_p)  # same partials, plain order
        torch.cuda.synchronize()
        n2 = red_p[0].item()
        scale_s = [n2] + [n2 ** 0.5] * (2 * n_store)  # ‖l_s‖ = 1
        red_rel = largest_error(abs(a - b) / s
                                for a, b, s in zip(red_k.tolist(), red_p.tolist(), scale_s))
        k2_abs = (red_k - red_q).abs().max().item()
    return psi_abs, psi_rel, red_rel, k2_abs


# Grids that do not fill the sweeps' tiles: odd extents, a grid smaller
# than one 8 x 32 tile, and one with fewer x-planes than a 32-plane segment.
RAGGED = ((37, 45, 29), (5, 6, 7), (9, 40, 70))
# (S, apply): ground, the coefficients alone, 1-2 stored states (kept in
# registers), 3 and 4 (K1's many-state kernels; K3's wide route) and 5 (the
# wide route of both)
RAGGED_MODES = ((0, False), (0, True), (1, True), (2, True), (3, True), (4, True), (5, True))
# K1's counts of stored states past its kernels of each count: its
# many-state kernels' (3, 4) and its wide route's (5 on), whose states walk
# in fours through the unrolled loops (9 crosses two of them)
MANY_S = (3, 4, 5, 6, 8, 9)
# K3's counts on its wide route, and the counts K1's and K3's times are
# taken at
PAIR_WIDE_S = (3, 4, 5)
MANY_TIMED_S = (3, 4, 5, 6, 8)


def ragged_vs_plain(order, kind, n_store, apply, pair, n, with_origin, gen, dev, stream=None):
    """K1 (``pair``: K3) on a padded block of interior extents ``n`` against
    its plain version, with noise in the halo too, as a shard block's halo
    holds its neighbours' faces. ``with_origin`` puts the block at (3, 5, 2)
    of a global grid 7 larger on each axis, whose B the sweep reads there;
    ``stream`` (K1's bf16) casts the stored states both read.
    Returns (ψ' rel err, reduction rel err)."""
    import torch

    from wafer_torch import geometry
    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs

    ext = geometry.EXT[order]
    lead = (2,) if pair else ()
    shape = (*lead, *(d + 2 * ext for d in n))
    origin = (3, 5, 2) if with_origin else (0, 0, 0)
    glob = tuple(d + 7 for d in n) if with_origin else n
    psi = torch.randn(shape, generator=gen, device=dev)
    store = None
    if n_store:
        store = torch.randn((n_store, *shape), generator=gen, device=dev)
        store = store / torch.sqrt((store * store).sum(dim=tuple(range(1, store.dim())),
                                                       keepdim=True))
        store = store.to(stream or store.dtype)
    analytic = b = None
    if kind == "streamed":
        d = 1.0 + 0.002 * torch.rand(n, generator=gen, device=dev)
        b = torch.stack([1.0 / d, -0.0004 / d]) if pair else 1.0 / d
    elif pair:
        analytic = (kind, 0.2, 0.004, 1.0, *glob, 1.0, 0.0, 0.2)
    else:
        analytic = analytic_for(kind, glob)
    n_red = 1 + (2 if pair else 1) * n_store
    coef = torch.tensor([0.9] + [0.05 * (q + 1) * (-1) ** q for q in range(n_red - 1)],
                        device=dev)
    kernel, plain, rows = ((hsp.sweep_step_sc, hsp.sweep_step_sc_plain, hsp.num_partials) if pair
                           else (hs.sweep_step, hs.sweep_step_plain, hs.num_partials))
    scale = 0.004 / (geometry.stencil_coefficients(order)[3] * 0.2 * 0.2)
    kw = dict(order=order, scale=scale, analytic=analytic, store=store, apply_coef=apply,
              origin=origin, **{"b2" if pair else "b_int": b})
    out_k, out_p = torch.empty_like(psi), torch.empty_like(psi)
    part_k = part_p = None
    if apply:
        part_k = torch.empty(rows(psi, order), n_red, dtype=torch.float64, device=dev)
        part_p = torch.empty(1, n_red, dtype=torch.float64, device=dev)
    kernel(psi, out_k, coef, part_k, **kw)
    plain(psi, out_p, coef, part_p, **kw)
    psi_rel = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
    red_rel = 0.0
    if apply:
        red_k, red_p = part_k.sum(dim=0).tolist(), part_p[0].tolist()
        n2 = red_p[0]
        scale_s = [n2] + [n2 ** 0.5] * (n_red - 1)
        red_rel = largest_error(abs(x - y) / z for x, y, z in zip(red_k, red_p, scale_s))
    return psi_rel, red_rel


def ragged_cases(pair, kinds, with_origin, gen, dev, stream=None):
    """Every order × kind × RAGGED_MODES × RAGGED grid (with ``stream``, K1's
    bf16 stored states, the modes that have some); returns (cases, worst
    ψ' rel err, worst reduction rel err), failing on the first that misses
    1e-6 of max|ψ'| or 1e-5 on the reductions."""
    worst, n_cases = [0.0, 0.0], 0
    for order in ("ThreePoint", "FivePoint", "SevenPoint"):
        for kind in kinds:
            for n_store, apply in RAGGED_MODES:
                if stream is not None and n_store == 0:
                    continue
                for n in RAGGED:
                    errs = ragged_vs_plain(order, kind, n_store, apply, pair, n, with_origin,
                                           gen, dev, stream)
                    check(errs[0] <= 1e-6 and errs[1] <= 1e-5,
                          f"{'K3' if pair else 'K1'} ragged {n} {order} {kind} S={n_store} "
                          f"apply={apply} origin={with_origin} stream={stream}: {errs}")
                    worst = [max(a, b) for a, b in zip(worst, errs)]
                    n_cases += 1
    return n_cases, worst[0], worst[1]


# K1's costly-B cases (Coulomb and SimpleCornell B from one rsqrt and one
# reciprocal, csrc/sweep_common.cuh radial_v): (kind, dn, dt, mass, sig,
# vshift) of the examples that run them (coulomb_states.yaml, cornell.yaml,
# vshift its V's least value), and (name, global extents, block shape,
# block origin): the Coulomb core inside a block of even N (centre on
# half-integers, r2 >= 3/4) and of odd N (centre on integers, r2 = 0 at a
# point), mixed parity, and shard blocks of a 64^3 grid at the origins of a
# (2, 1, 1) and a 2 x (2, 2, 1) mesh, the core at or near their faces.
COSTLY_B_PHYSICS = {"Coulomb": (0.125, 0.005, 1.0, 1.0, 0.0),
                    "SimpleCornell": (0.35, 0.04, 4.65, 0.223, 16.78)}
COSTLY_B_BLOCKS = (("even", (64, 64, 64), (64, 64, 64), (0, 0, 0)),
                   ("odd", (37, 45, 29), (37, 45, 29), (0, 0, 0)),
                   ("mixed", (33, 48, 65), (33, 48, 65), (0, 0, 0)),
                   ("(2, 1, 1) origin", (64, 64, 64), (32, 64, 64), (32, 0, 0)),
                   ("2 x (2, 2, 1) origin", (64, 64, 64), (16, 32, 64), (16, 32, 0)),
                   ("2 x (2, 2, 1) core face", (64, 64, 64), (16, 32, 64), (32, 0, 0)))
COSTLY_B_MODES = ((0, False, None), (0, True, None), (1, True, None), (2, True, None),
                  (1, True, "bf16"), (2, True, "bf16"))
# The same at the shapes the main paths launch them with, ThreePoint: (name,
# kind, (dn, dt, mass, sig, vshift), global extents, block shape, block
# origin, reduction window, modes). coulomb_states.yaml's and cornell.yaml's
# whole grids; a shard of sharded_512.yaml's (8, 1, 1) mesh; and deep blocks
# of multislice_512.yaml's 2 x (2, 2, 1) shards (128 x 256 x 512 with x pads
# four planes deep, the window of slice_update = 4 steps, their planes
# summed (4, 132)): the one around the core, and the first, which reaches
# four planes past the grid's low x face.
COSTLY_B_512 = (0.03, 2.8e-4, 1.0, 1.0, 0.0)
COSTLY_B_WIDE = ((0, False, None), (0, True, None), (1, True, None), (1, True, "bf16"))
COSTLY_B_MAIN = (
    ("coulomb_states.yaml", "Coulomb", COSTLY_B_PHYSICS["Coulomb"], (128,) * 3, (128,) * 3,
     (0, 0, 0), None, COSTLY_B_MODES),
    ("cornell.yaml", "SimpleCornell", COSTLY_B_PHYSICS["SimpleCornell"], (64, 64, 128),
     (64, 64, 128), (0, 0, 0), None, COSTLY_B_MODES),
    ("sharded_512.yaml shard", "Coulomb", COSTLY_B_512, (512,) * 3, (64, 512, 512),
     (256, 0, 0), None, COSTLY_B_WIDE[:2]),
    ("multislice_512.yaml deep block at the core", "Coulomb", COSTLY_B_512, (512,) * 3,
     (136, 256, 512), (124, 256, 0), (4, 132), COSTLY_B_WIDE),
    ("multislice_512.yaml deep block at the low face", "Coulomb", COSTLY_B_512, (512,) * 3,
     (136, 256, 512), (-4, 0, 0), (4, 132), COSTLY_B_WIDE),
)


def costly_b_vs_plain(order, kind, n_store, apply, glob, shape, origin, gen, dev, stream=None,
                      physics=None, red=None):
    """K1 with Coulomb or SimpleCornell B (``physics``, by default the
    examples' of COSTLY_B_PHYSICS) on a block of interior ``shape`` at
    ``origin`` of a grid ``glob``, noise in its halo, against the plain
    version (the reference's IEEE expressions); ``stream`` ("bf16") casts
    the stored states both read; ``red`` is the block's reduction window.
    Returns (ψ' rel err, reduction rel err)."""
    import torch

    from wafer_torch import geometry
    from wafer_torch.ops import hopper_stencil as hs

    ext = geometry.EXT[order]
    padded = tuple(d + 2 * ext for d in shape)
    dn, dt, mass, sig, vshift = physics or COSTLY_B_PHYSICS[kind]
    psi = torch.randn(padded, generator=gen, device=dev)
    store = None
    if n_store:
        store = torch.randn((n_store, *padded), generator=gen, device=dev)
        store = store / torch.sqrt((store * store).sum(dim=(1, 2, 3), keepdim=True))
        store = store.to(torch.bfloat16 if stream == "bf16" else torch.float32)
    coef = torch.tensor([0.9] + [0.05 * (q + 1) * (-1) ** q for q in range(n_store)], device=dev)
    scale = dt / (geometry.stencil_coefficients(order)[3] * dn * dn * mass)
    kw = dict(order=order, scale=scale, analytic=(kind, dn, dt, mass, *glob, sig, vshift),
              store=store, apply_coef=apply, origin=origin, red=red)
    out_k, out_p = torch.empty_like(psi), torch.empty_like(psi)
    part_k = part_p = None
    if apply:
        part_k = torch.empty(hs.num_partials(psi, order), 1 + n_store, dtype=torch.float64,
                             device=dev)
        part_p = torch.empty(1, 1 + n_store, dtype=torch.float64, device=dev)
    hs.sweep_step(psi, out_k, coef, part_k, **kw)
    hs.sweep_step_plain(psi, out_p, coef, part_p, **kw)
    psi_rel = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
    red_rel = 0.0
    if apply:
        red_k, red_p = part_k.sum(dim=0).tolist(), part_p[0].tolist()
        scale_s = [red_p[0]] + [red_p[0] ** 0.5] * n_store
        red_rel = largest_error(abs(x - y) / z for x, y, z in zip(red_k, red_p, scale_s))
    return psi_rel, red_rel


def costly_b_case_list(kinds, orders):
    """Every kind × order × COSTLY_B_BLOCKS × COSTLY_B_MODES, then
    COSTLY_B_MAIN's cases at ThreePoint, as (label, costly_b_vs_plain's
    arguments but ``gen`` and ``dev``, its keywords)."""
    out = []
    for kind in kinds:
        for order in orders:
            for name, glob, shape, origin in COSTLY_B_BLOCKS:
                for n_store, apply, stream in COSTLY_B_MODES:
                    out.append((f"K1 {kind} {order} {name} S={n_store} apply={apply} "
                                f"stream={stream}",
                                (order, kind, n_store, apply, glob, shape, origin),
                                {"stream": stream}))
    for name, kind, physics, glob, shape, origin, red, modes in COSTLY_B_MAIN:
        for n_store, apply, stream in modes:
            out.append((f"K1 {kind} ThreePoint {name} S={n_store} apply={apply} stream={stream}",
                        ("ThreePoint", kind, n_store, apply, glob, shape, origin),
                        {"stream": stream, "physics": physics, "red": red}))
    return out


def costly_b_cases(kinds, orders, gen, dev):
    """costly_b_case_list's cases; returns (cases, worst ψ' rel err, worst
    reduction rel err), failing on the first that misses 1e-6 of max|ψ'|
    or 1e-5 on the reductions."""
    worst, n_cases = [0.0, 0.0], 0
    for label, args, kw in costly_b_case_list(kinds, orders):
        errs = costly_b_vs_plain(*args, gen, dev, **kw)
        check(errs[0] <= 1e-6 and errs[1] <= 1e-5, f"{label}: {errs}")
        worst = [max(a, b) for a, b in zip(worst, errs)]
        n_cases += 1
    return n_cases, worst[0], worst[1]


def repeat_is_identical(pair, n_store, n, gen, dev, stream=None):
    """Two launches of K1 (``pair``: K3) on the same input, Coulomb B, with
    S stored states (``stream``: cast, K1's bf16) and the coefficients: ψ'
    and the partial rows bit for bit."""
    import torch
    import torch.nn.functional as F

    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs

    lead = (2,) if pair else ()
    psi = F.pad(torch.randn((*lead, *n), generator=gen, device=dev), (1,) * 6)
    store = F.pad(torch.randn((n_store, *lead, *n), generator=gen, device=dev), (1,) * 6)
    store = (store / torch.sqrt((store * store).sum())).to(stream or store.dtype)
    n_red = 1 + (2 if pair else 1) * n_store
    coef = torch.tensor([0.9] + [0.05] * (n_red - 1), device=dev)
    kernel, rows = ((hsp.sweep_step_sc, hsp.num_partials) if pair
                    else (hs.sweep_step, hs.num_partials))
    analytic = ("Coulomb", 0.2, 0.004, 1.0, *n, 1.0, 0.0) + ((0.2,) if pair else ())
    outs = []
    for _ in range(2):
        out = torch.empty_like(psi)
        part = torch.empty(rows(psi, "ThreePoint"), n_red, dtype=torch.float64, device=dev)
        kernel(psi, out, coef, part, order="ThreePoint", scale=0.05, analytic=analytic,
               store=store, apply_coef=True)
        outs.append((out, part))
    torch.cuda.synchronize()
    return torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def bf16_is_f32_on_its_values(order, n_store, n, gen, dev, origin=(0, 0, 0), red=None,
                              kind="Coulomb"):
    """2i: K1 with a bf16 store against K1 with an f32 store that holds the
    same values (the bf16 ones, upcast), B of ``kind`` with the
    coefficients: ψ' and the partial rows bit for bit, since both kernels do
    the same f32 arithmetic on the same values. ``origin`` places the block
    in a grid 7 larger on each axis; ``red`` is a reduction window."""
    import torch
    import torch.nn.functional as F

    from wafer_torch import geometry
    from wafer_torch.ops import hopper_stencil as hs

    ext = geometry.EXT[order]
    glob = tuple(d + 7 for d in n) if any(origin) else n
    psi = F.pad(torch.randn(n, generator=gen, device=dev), (ext,) * 6)
    store = F.pad(torch.randn((n_store, *n), generator=gen, device=dev), (ext,) * 6)
    store = (store / torch.sqrt((store * store).sum())).to(torch.bfloat16)
    coef = torch.tensor([0.9] + [0.05 * (q + 1) * (-1) ** q for q in range(n_store)], device=dev)
    kw = dict(order=order, scale=0.004 / (geometry.stencil_coefficients(order)[3] * 0.04),
              analytic=analytic_for(kind, glob), apply_coef=True, origin=origin, red=red)
    outs = []
    for st in (store, store.float()):
        out = torch.empty_like(psi)
        part = torch.empty(hs.num_partials(psi, order), 1 + n_store, dtype=torch.float64,
                           device=dev)
        hs.sweep_step(psi, out, coef, part, store=st, **kw)
        outs.append((out, part))
    torch.cuda.synchronize()
    return torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


# A block of each width of the costly kinds' bf16 psi row copies
# (hopper_stencil.ROW_COPIES): odd padded rows take 4-byte copies, and a
# slab of 256^3 (258-point rows, as every main path's) 8-byte ones.
ROW_COPY_SHAPES = {"4": (37, 45, 29), "8": (24, 256, 256)}


def row_copy_case(order, n_store, width, gen, dev, kind):
    """2i: bf16_is_f32_on_its_values on ROW_COPY_SHAPES[width] with B of
    ``kind`` (Coulomb or SimpleCornell); returns (bit for bit, whether the
    bf16 launch counted in ROW_COPIES[width] alone)."""
    from wafer_torch.ops import hopper_stencil as hs

    before = dict(hs.ROW_COPIES)
    equal = bf16_is_f32_on_its_values(order, n_store, ROW_COPY_SHAPES[width], gen, dev, kind=kind)
    counted = {k: hs.ROW_COPIES[k] - before[k] for k in before}
    return equal, counted == {w: int(w == width) for w in counted}


def many_state_cases(gen, dev, stream=None):
    """2 (f32 stores) and 2i (``stream``: bf16): K1 with S in MANY_S (its
    many-state kernels and its wide route) against its plain version with
    the coefficients: orders × Harmonic/Coulomb/streamed B on 64×64×128,
    each also on RAGGED deep blocks with a reduction window at the x origins
    of WINDOW_ORIGINS (planes outside the grid zero, two launches bit for
    bit); Harmonic and Coulomb at the main path's 256³ with S = 3, 4 and 5; two
    launches on the same input bit for bit (37×45×29 and 256³); and the
    done flag (RAGGED and 64×64×128, Coulomb and streamed B). Returns (cases,
    [worst ψ' abs err, of max|ψ'|, reductions], {"many", "wide": worst ψ'
    abs err of each route}), failing on the first case that misses 1e-6 of
    max|ψ'| or 1e-5 on the reductions."""
    from wafer_torch.ops import hopper_stencil as hs

    tag = "2i" if stream is not None else "2"
    worst, n_cases = [0.0, 0.0, 0.0], 0
    by_route = {"many": 0.0, "wide": 0.0}
    for order in ("ThreePoint", "FivePoint", "SevenPoint"):
        for kind in ("Harmonic", "Coulomb", "streamed"):
            for n_store in MANY_S:
                errs = kernel_vs_plain(order, kind, n_store, False, (64, 64, 128), gen, dev,
                                       stream=stream)
                check(errs[1] <= 1e-6 and errs[2] <= 1e-5,
                      f"{tag} {order} {kind} S={n_store} stream={stream}: {errs}")
                worst = [max(a, b) for a, b in zip(worst, errs[:3])]
                route = hs.route(False, n_store, False).removeprefix("sweep_step_")
                by_route[route] = max(by_route[route], errs[0])
                n_cases += 1
                for n in RAGGED:
                    for where, ox in WINDOW_ORIGINS.items():
                        red = (n[0] // 4, n[0] - n[0] // 4)
                        errs = window_vs_plain(order, kind, n_store, True, False, n, ox(n[0]),
                                               n[0] + 2, red, gen, dev, repeat=True,
                                               stream=stream)
                        check(errs[0] <= 1e-6 and errs[1] <= 1e-5 and errs[2] and errs[3],
                              f"{tag} window {n} {order} {kind} S={n_store} origin {where} "
                              f"stream={stream}: {errs}")
                        worst = [worst[0], max(worst[1], errs[0]), max(worst[2], errs[1])]
                        n_cases += 1
    for kind in ("Harmonic", "Coulomb"):
        for n_store in (3, 4, 5):
            errs = kernel_vs_plain("ThreePoint", kind, n_store, False, (256, 256, 256), gen, dev,
                                   stream=stream)
            check(errs[1] <= 1e-6 and errs[2] <= 1e-5,
                  f"{tag} 256^3 {kind} S={n_store} stream={stream}: {errs}")
            worst = [max(a, b) for a, b in zip(worst, errs[:3])]
            route = hs.route(False, n_store, False).removeprefix("sweep_step_")
            by_route[route] = max(by_route[route], errs[0])
            n_cases += 1
    for n_store in MANY_S:
        for n in ((37, 45, 29), (256, 256, 256)):
            check(repeat_is_identical(False, n_store, n, gen, dev, stream=stream),
                  f"{tag}: two K1 launches on the same input differ (S={n_store}, {n}, "
                  f"stream={stream})")
            n_cases += 1
        for n in RAGGED + ((64, 64, 128),):
            for kind in ("Coulomb", "streamed"):
                equal, untouched = done_flag_cases(False, n_store, n, gen, dev, kind,
                                                   stream=stream)
                check(equal and untouched, f"{tag} done flag {n} {kind} S={n_store} "
                      f"stream={stream}: clear is the default launch {equal}, set writes "
                      f"nothing {untouched}")
                n_cases += 1
    return n_cases, worst, by_route


def many_state_times(gen, dev):
    """{(stream, S): (ms, plain ms, (bound ms, bound by))} of K1 at the main
    path's 256³ ThreePoint Harmonic with S in MANY_TIMED_S stored states (its
    many-state kernels and its wide route), f32 and bf16 stores, the
    coefficients applied and the reductions written."""
    import torch

    from wafer_torch.ops import hopper_stencil as hs

    n3 = (256, 256, 256)
    psi = harmonic_state(256, 0.0375, gen, dev)
    out = torch.empty_like(psi)
    kw = dict(order="ThreePoint", scale=4e-4 / (2.0 * 0.0375 ** 2),
              analytic=("Harmonic", 0.0375, 4e-4, 1.0, *n3, 1.0, 0.0), apply_coef=True)
    lows = [harmonic_state(256, 0.0375, gen, dev, odd=True, axis=k % 3)
            for k in range(max(MANY_TIMED_S))]
    times = {}
    for n_store in MANY_TIMED_S:
        store = torch.stack(lows[:n_store])
        store = store / torch.sqrt((store * store).sum(dim=(1, 2, 3), keepdim=True))
        coef = torch.tensor([1.0] + [0.01] * n_store, device=dev)
        part = torch.empty(hs.num_partials(psi, "ThreePoint"), 1 + n_store, dtype=torch.float64,
                           device=dev)
        part1 = torch.empty(1, 1 + n_store, dtype=torch.float64, device=dev)
        for stream in (torch.float32, torch.bfloat16):
            st = store.to(stream)
            ms = cuda_ms(lambda: hs.sweep_step(psi, out, coef, part, store=st, **kw), 200)
            plain = cuda_ms(lambda: hs.sweep_step_plain(psi, out, coef, part1, store=st, **kw), 10)
            work = sweep_work(n3, 1, n_store, reduce=True,
                              stream_bytes=2 if stream == torch.bfloat16 else 4)
            times[stream, n_store] = (ms, plain, bound(work))
    return times


def pair_wide_cases(gen, dev):
    """2b: K3 with S in PAIR_WIDE_S stored pairs (its wide route) against its
    plain version with the coefficients: orders × ComplexHarmonic/
    ComplexCoulomb/streamed B on 64×64×128, each also on RAGGED deep blocks
    with a reduction window at the x origins of WINDOW_ORIGINS (planes
    outside the grid zero, two launches bit for bit); ComplexHarmonic and
    ComplexCoulomb at 256³; two launches on the same input bit for bit
    (37×45×29 and 256³); and the done flag (RAGGED and 64×64×128, Coulomb
    and streamed B). Returns (cases, [worst ψ' abs err, of max|ψ'|,
    reductions]), failing on the first case that misses 1e-6 of max|ψ'| or
    1e-5 on the reductions."""
    worst, n_cases = [0.0, 0.0, 0.0], 0
    for order in ("ThreePoint", "FivePoint", "SevenPoint"):
        for kind in ("Harmonic", "Coulomb", "streamed"):
            for n_store in PAIR_WIDE_S:
                errs = pair_kernel_vs_plain(order, kind, n_store, False, (64, 64, 128), gen, dev)
                check(errs[1] <= 1e-6 and errs[2] <= 1e-5,
                      f"2b K3 {order} {kind} S={n_store}: {errs}")
                worst = [max(a, b) for a, b in zip(worst, errs[:3])]
                n_cases += 1
                for n in RAGGED:
                    for where, ox in WINDOW_ORIGINS.items():
                        red = (n[0] // 4, n[0] - n[0] // 4)
                        errs = window_vs_plain(order, kind, n_store, True, True, n, ox(n[0]),
                                               n[0] + 2, red, gen, dev, repeat=True)
                        check(errs[0] <= 1e-6 and errs[1] <= 1e-5 and errs[2] and errs[3],
                              f"2b K3 window {n} {order} {kind} S={n_store} origin {where}: "
                              f"{errs}")
                        worst = [worst[0], max(worst[1], errs[0]), max(worst[2], errs[1])]
                        n_cases += 1
    for kind in ("Harmonic", "Coulomb"):
        for n_store in PAIR_WIDE_S:
            errs = pair_kernel_vs_plain("ThreePoint", kind, n_store, False, (256, 256, 256), gen,
                                        dev)
            check(errs[1] <= 1e-6 and errs[2] <= 1e-5, f"2b K3 256^3 {kind} S={n_store}: {errs}")
            worst = [max(a, b) for a, b in zip(worst, errs[:3])]
            n_cases += 1
    for n_store in PAIR_WIDE_S:
        for n in ((37, 45, 29), (256, 256, 256)):
            check(repeat_is_identical(True, n_store, n, gen, dev),
                  f"2b: two K3 launches on the same input differ (S={n_store}, {n})")
            n_cases += 1
        for n in RAGGED + ((64, 64, 128),):
            for kind in ("Coulomb", "streamed"):
                equal, untouched = done_flag_cases(True, n_store, n, gen, dev, kind)
                check(equal and untouched, f"2b K3 done flag {n} {kind} S={n_store}: clear is "
                      f"the default launch {equal}, set writes nothing {untouched}")
                n_cases += 1
    return n_cases, worst


def pair_wide_times(gen, dev):
    """{S: (ms, plain ms, (bound ms, bound by))} of K3 at the complex main
    path's 256³ ThreePoint ComplexHarmonic (dn 0.0625, dt 1.2e-3, absorb
    0.2) with S in PAIR_WIDE_S stored pairs, the coefficients applied and
    the reductions written."""
    import torch

    from wafer_torch.ops import hopper_split as hsp

    n3 = (256, 256, 256)
    dn_c, dt_c = 0.0625, 1.2e-3
    pair = torch.stack([harmonic_state(256, dn_c, gen, dev),
                        0.1 * harmonic_state(256, dn_c, gen, dev)])
    out = torch.empty_like(pair)
    kw = dict(order="ThreePoint", scale=dt_c / (2.0 * dn_c ** 2),
              analytic=("Harmonic", dn_c, dt_c, 1.0, *n3, 1.0, 0.0, 0.2), apply_coef=True)
    times = {}
    for n_store in PAIR_WIDE_S:
        store = torch.stack([torch.stack([harmonic_state(256, dn_c, gen, dev, odd=True,
                                                         axis=k % 3)] * 2)
                             for k in range(n_store)])
        store = store / torch.sqrt((store * store).sum(dim=(1, 2, 3, 4), keepdim=True))
        coef = torch.tensor([1.0] + [0.01] * (2 * n_store), device=dev)
        part = torch.empty(hsp.num_partials(pair, "ThreePoint"), 1 + 2 * n_store,
                           dtype=torch.float64, device=dev)
        part1 = torch.empty(1, 1 + 2 * n_store, dtype=torch.float64, device=dev)
        ms = cuda_ms(lambda: hsp.sweep_step_sc(pair, out, coef, part, store=store, **kw), 100)
        plain = cuda_ms(lambda: hsp.sweep_step_sc_plain(pair, out, coef, part1, store=store, **kw),
                        5)
        times[n_store] = (ms, plain, bound(sweep_work(n3, 1, n_store, reduce=True, pair=True)))
        del store
    return times


# The wide route's kernels and their stored-state streams, for its cases at
# the most states its rings hold (route: pair, bf16)
WIDE_ROUTES = {"K1 f32": (False, False), "K1 bf16": (False, True), "K3": (True, False)}
# stored states past the rings that cross two of the kernel's block sums of
# the states past them (kChunk = 8, csrc/stencil_sweep_wide.cu)
WIDE_FAR = 10


def wide_cap_cases(gen, dev):
    """2w: the wide route (K1 f32 and bf16, K3) at each order with as many
    stored states as its rings hold (``wide_cap``, B from coordinates and
    streamed) and one more, the last read where it is used, against its
    plain version on 64×64×128 with the coefficients; at ThreePoint also
    WIDE_FAR past the cap; at one past the cap, a ragged deep block with a
    reduction window at the x origins of WINDOW_ORIGINS (planes outside the
    grid zero, two launches bit for bit), two launches on the same input
    bit for bit, the done flag, and (bf16) the f32 launch on its values bit
    for bit. Returns (cases, {route: [worst ψ' abs err, of max|ψ'|,
    reductions]}, {route: [cap at EXT 1, 2, 3]}), failing on the first case
    that misses 1e-6 of max|ψ'| or 1e-5 on the reductions."""
    import torch

    from wafer_torch import geometry

    n_cases, worst, caps = 0, {}, {}
    for route, (pair, bf16) in WIDE_ROUTES.items():
        stream = torch.bfloat16 if bf16 else None
        worst[route], caps[route] = [0.0, 0.0, 0.0], []

        def vs_plain(order, kind, n_store, n=(64, 64, 128), pair=pair, stream=stream):
            if pair:
                return pair_kernel_vs_plain(order, kind, n_store, False, n, gen, dev)
            return kernel_vs_plain(order, kind, n_store, False, n, gen, dev, stream=stream)

        for order in ("ThreePoint", "FivePoint", "SevenPoint"):
            ext = geometry.EXT[order]
            for kind in ("Harmonic", "streamed"):
                cap = wide_cap(pair, bf16, ext, kind == "streamed")
                if kind == "Harmonic":
                    caps[route].append(cap)
                past = (0, 1, WIDE_FAR) if order == "ThreePoint" else (0, 1)
                for n_store in (cap + k for k in past):
                    ring = wide_occupancy(pair, bf16, ext, n_store, kind == "streamed")[2]
                    check(ring == n_store if n_store == cap else ring < n_store,
                          f"2w {route} {order} {kind} S={n_store}: {ring} states in the rings "
                          f"(cap {cap})")
                    errs = vs_plain(order, kind, n_store)
                    check(errs[1] <= 1e-6 and errs[2] <= 1e-5,
                          f"2w {route} {order} {kind} S={n_store} (cap {cap}): {errs}")
                    worst[route] = [max(a, b) for a, b in zip(worst[route], errs[:3])]
                    n_cases += 1
            s1 = caps[route][-1] + 1
            n = RAGGED[0]
            for where, ox in WINDOW_ORIGINS.items():
                errs = window_vs_plain(order, "Coulomb", s1, True, pair, n, ox(n[0]), n[0] + 2,
                                       (n[0] // 4, n[0] - n[0] // 4), gen, dev, repeat=True,
                                       stream=stream)
                check(errs[0] <= 1e-6 and errs[1] <= 1e-5 and errs[2] and errs[3],
                      f"2w {route} window {n} {order} S={s1} origin {where}: {errs}")
                w = worst[route]
                worst[route] = [w[0], max(w[1], errs[0]), max(w[2], errs[1])]
                n_cases += 1
            if bf16:
                check(bf16_is_f32_on_its_values(order, s1, n, gen, dev, origin=(3, 2, 1),
                                                red=(4, n[0] - 4)),
                      f"2w {order} S={s1}: a bf16 launch is not the f32 launch on its values")
                n_cases += 1
        s1 = caps[route][0] + 1
        check(repeat_is_identical(pair, s1, RAGGED[0], gen, dev, stream=stream),
              f"2w {route}: two launches on the same input differ (S={s1})")
        n_cases += 1
        for kind in ("Coulomb", "streamed"):
            equal, untouched = done_flag_cases(pair, s1, RAGGED[0], gen, dev, kind, stream=stream)
            check(equal and untouched, f"2w {route} done flag {kind} S={s1}: clear is the "
                  f"default launch {equal}, set writes nothing {untouched}")
            n_cases += 1
    return n_cases, worst, caps


@contextlib.contextmanager
def exc_stream(value):
    """``WAFER_EXC_STREAM`` set to ``value`` while the block runs."""
    old = os.environ.get("WAFER_EXC_STREAM")
    os.environ["WAFER_EXC_STREAM"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("WAFER_EXC_STREAM")
        else:
            os.environ["WAFER_EXC_STREAM"] = old


def kernel_launches(launched, pair=False):
    """The sweep's launches in a run's counts: K3's for pairs (its wide
    route's included), else K1's with f32 and with bf16 stored-state
    streams, on the kernels of each count, the many-state kernels and the
    wide route."""
    if pair:
        return launched["sweep_step_sc"] + launched["sweep_step_sc_wide"]
    return sum(launched[k] for k in ("sweep_step", "sweep_step_bf16", "sweep_step_many",
                                     "sweep_step_bf16_many", "sweep_step_wide",
                                     "sweep_step_bf16_wide"))


# K2's checks: partial row counts (1, 7, 256³'s, 512³'s, twice that, and an
# odd count above a thousand groups' worth) × columns (K1 S = 0..2, K3 S = 2,
# K3 S = 3: the run-time count)
FINISH_ROWS = (1, 7, 2048, 16384, 32768, 100003)
FINISH_NRED = (1, 2, 3, 5, 7)


def finish_inputs(rows, n_red, gen, dev):
    """Partial rows as a sweep writes them: column 0 (‖ψ'‖² pieces)
    positive, the overlap columns of either sign."""
    import torch

    part = torch.randn(rows, n_red, generator=gen, device=dev, dtype=torch.float64)
    part[:, 0] = part[:, 0].abs()
    return part


def finish_vs_plain(rows, n_red, gen, dev):
    """K2 against its plain version on one set of partials. Returns (worst
    |Δred_q| / Σ|x_q|, worst |Δcoef_q| / (Σ|x_q|·inv), two launches on the
    same partials bit-identical)."""
    import torch

    from wafer_torch.ops import hopper_stencil as hs

    part = finish_inputs(rows, n_red, gen, dev)
    red = torch.full((n_red,), math.nan, dtype=torch.float64, device=dev)
    coef = torch.full((n_red,), math.nan, device=dev)
    launch = hs.finish_launcher(part, red, coef)
    outs = []
    for _ in range(2):
        red.fill_(math.nan)
        coef.fill_(math.nan)
        launch()
        outs.append((red.clone(), coef.clone()))
    red_p = torch.empty(n_red, dtype=torch.float64, device=dev)
    coef_p = torch.empty(n_red, device=dev)
    hs.finish_coef_plain(part, red_p, coef_p)
    mag = part.abs().sum(dim=0)
    inv = float(coef_p[0])
    red_err = largest_error(((outs[0][0] - red_p).abs() / mag).tolist())
    coef_scale = torch.cat([coef_p[:1].double(), mag[1:] * inv])
    coef_err = largest_error(((outs[0][1].double() - coef_p.double()).abs() / coef_scale).tolist())
    same = torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    return red_err, coef_err, same


def finish_ticket_resets(rows, n_red, launches, gen, dev):
    """``launches`` K2 launches in a row, alternating between two launchers
    (each with its own scratch) on two sets of partials, then the result
    against a fresh launcher on the last set: bit for bit, and both tickets
    zero, so every launch found its last block and left the ticket zero."""
    import torch

    from wafer_torch.ops import hopper_stencil as hs

    a, b = finish_inputs(rows, n_red, gen, dev), finish_inputs(rows, n_red, gen, dev)
    red, coef = torch.empty(n_red, dtype=torch.float64, device=dev), torch.empty(n_red, device=dev)
    runs = [hs.finish_launcher(p, red, coef) for p in (a, b)]
    for i in range(launches):
        runs[i % 2]()
    last = b if launches % 2 == 0 else a
    red1, coef1 = torch.empty_like(red), torch.empty_like(coef)
    hs.finish_coef(last, red1, coef1)
    tickets = [run.scratch[:1].view(torch.int32)[0].item() for run in runs]
    return torch.equal(red, red1) and torch.equal(coef, coef1) and tickets == [0, 0]


def finish_times(rows, n_red, gen, dev, n=100):
    """Device µs a launch (``held_times``) of K2 as the chunk launches it,
    of K2 as one block (G = 1) and of ``partials.sum(dim=0)`` on the same
    partials; the host µs a call of the chunk's bound launcher and of
    ``finish_coef`` (the checks every call); the plain version's device µs;
    and G."""
    import torch

    from wafer_torch.ops import _build, hopper_stencil as hs

    lib = _build.library()
    part = finish_inputs(rows, n_red, gen, dev)
    red = torch.empty(n_red, dtype=torch.float64, device=dev)
    coef = torch.empty(n_red, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (part.data_ptr(), rows, n_red, red.data_ptr(), coef.data_ptr())
    launch = hs.finish_launcher(part, red, coef)
    k2 = held_times(launch, n)
    one = held_times(lambda: lib.wafer_finish_coef(*ptrs, launch.scratch.data_ptr(), 1, None,
                                                   dev.index, stream), n)
    library = held_times(lambda: part.sum(dim=0), n)
    wrapper = held_times(lambda: hs.finish_coef(part, red, coef), n)
    plain = held_times(lambda: hs.finish_coef_plain(part, red, coef), 40)
    return {"rows": rows, "n_red": n_red, "groups": hs.finish_groups(rows, n_red),
            "k2_us": k2[0], "one_block_us": one[0],
            "sum_us": library[0], "plain_us": plain[0], "host_launcher_us": k2[1],
            "host_finish_coef_us": wrapper[1],
            "bound_us": bound(finish_work(rows, n_red))[0] * 1e3}


def harmonic_state(n, dn, gen, dev, odd=False, axis=0):
    """Smooth padded test state: the oscillator ground (or its partner odd
    along ``axis``) plus 1% noise, ThreePoint shell."""
    import torch
    import torch.nn.functional as F

    x = (torch.arange(n, device=dev, dtype=torch.float32) - (n - 1) / 2.0) * dn
    r2 = x[:, None, None] ** 2 + x[None, :, None] ** 2 + x[None, None, :] ** 2
    w = torch.exp(-r2 / 2.0) * (x.reshape([-1 if a == axis else 1 for a in range(3)]) if odd else 1.0)
    w = w + 0.01 * torch.randn(w.shape, generator=gen, device=dev)
    w = F.pad(w, (1,) * 6)
    return (w / torch.sqrt((w * w).sum())).contiguous()


@contextlib.contextmanager
def recorded_solves():
    """While the block runs, record each solve, every multigrid level's
    included, as (SolveResult, wall seconds, grid points, launches,
    sharded) in ``rec.states`` (each SolveResult with ``peak_bytes``, the
    device memory its solve allocated at most, on a CUDA device), and count
    the plain sweeps' calls in ``rec.plain``."""
    import torch

    from wafer_torch import solver
    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs, split_complex, stencil
    from wafer_torch.parallel import solver_sharded

    rec = types.SimpleNamespace(states=[], plain=0)

    def counted(fn):
        def wrapper(*args, **kwargs):
            rec.plain += 1
            return fn(*args, **kwargs)
        return wrapper

    orig_solve, orig_sharded = solver.solve, solver_sharded._solve_state
    cuda = torch.cuda.is_available()

    def timed(fn, sharded):
        def run(config, *args, **kwargs):
            before = dict(hs.LAUNCHES)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            res = fn(config, *args, **kwargs)  # ends on a host read of its scalars
            secs = time.perf_counter() - t
            res.peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
            launched = {k: hs.LAUNCHES[k] - before[k] for k in before}
            rec.states.append((res, secs, math.prod(config.grid.size.as_tuple()), launched,
                               sharded))
            return res
        return run

    patched = [(m, n, getattr(m, n)) for m, n in
               ((stencil, "evolve_step"), (hs, "sweep_step_plain"), (hs, "finish_coef_plain"),
                (split_complex, "evolve_step_sc"), (hsp, "sweep_step_sc_plain"))]
    try:
        for mod, name, fn in patched:
            setattr(mod, name, counted(fn))
        solver.solve = timed(orig_solve, False)
        solver_sharded._solve_state = timed(orig_sharded, True)
        yield rec
    finally:
        solver.solve, solver_sharded._solve_state = orig_solve, orig_sharded
        for mod, name, fn in patched:
            setattr(mod, name, fn)


def main_path(config_text, mesh_shape=None, slices=1):
    """Run ``wafer_torch.cli.main`` on ``config_text`` in a temporary
    directory, or with ``mesh_shape`` ``solver.run(config, mesh=...)`` with
    every shard on the card (the CLI puts one shard on each card); with
    ``slices > 1`` the mesh is the multi-slice ``slices × mesh_shape``. Returns
    (energies E/‖ψ‖² of the final level, complex for a complex potential,
    [(SolveResult, wall seconds, grid points, launches, sharded)] for each
    solve, every multigrid level's included, kernel launches, plain-sweep
    calls, wall seconds); launches and plain calls are counted from just
    before the run. Each state's observables file must hold Re E. Each
    SolveResult carries ``peak_bytes``, the device memory its solve
    allocated at most."""
    import logging

    import torch
    import yaml

    from wafer_torch import cli, solver
    from wafer_torch.config import Config
    from wafer_torch.ops import hopper_stencil as hs
    from wafer_torch.parallel import make_mesh
    from wafer_torch.parallel.multislice import make_multislice_mesh

    n_states = yaml.safe_load(config_text)["wavemax"] + 1
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="wafer_torch_smoke_") as tmp:
        os.chdir(tmp)
        try:
            with open("smoke.yaml", "w") as fh:
                fh.write(config_text)
            mesh = None
            if mesh_shape is not None:
                devices = [torch.device("cuda", 0)] * (slices * math.prod(mesh_shape))
                mesh = (make_multislice_mesh(mesh_shape, slices, devices) if slices > 1
                        else make_mesh(mesh_shape, devices))
            with recorded_solves() as rec:
                hs.reset_launches()
                t = time.perf_counter()
                if mesh is None:
                    rc = cli.main(["-c", "smoke.yaml"])
                else:
                    solver.run(Config.load("smoke.yaml"), logging.getLogger("wafer"), mesh=mesh)
                    rc = 0
                wall = time.perf_counter() - t
                launches = dict(hs.LAUNCHES)
        finally:
            os.chdir(cwd)
        states = rec.states
        check(rc == 0, f"cli.main returned {rc}")
        (run_dir,) = os.listdir(os.path.join(tmp, "output"))
        energies = [res.observables.energy / res.observables.norm2
                    for res, *_rest in states[-n_states:]]
        check(len(states) % n_states == 0 and [r.wnum for r, *_ in states[-n_states:]]
              == list(range(n_states)), f"{len(states)} solves for {n_states} states")
        for wnum, e in enumerate(energies):
            path = os.path.join(tmp, "output", run_dir, f"observables_{wnum}.json")
            check(os.path.exists(path), f"observables_{wnum}.json was not written")
            with open(path) as fh:
                written = float(json.load(fh)["energy"])
            check(abs(written - e.real) <= 1e-9 * abs(e.real), f"state {wnum}: file E {written}")
    return energies, states, launches, rec.plain, wall


# --------------------------------------------------------------------------- #
# multi-process runs: ranks started as fresh interpreters
# --------------------------------------------------------------------------- #

RANK_CHILD = "import sys, chip_smoke; sys.exit(chip_smoke.rank_child(sys.argv[1]))"


def free_port():
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_ranks(spec, world, root, timeout, env=None):
    """Run ``world`` ranks of :func:`rank_child` on ``spec`` as fresh
    interpreters (never ``fork``: this process may hold a CUDA context),
    each in its own directory ``root/rank<r>`` with ``WAFER_COORDINATOR``
    (a free port on 127.0.0.1), ``WAFER_NUM_PROCESSES``,
    ``WAFER_PROCESS_ID`` and ``env``, its output in ``root/rank<r>.log``.
    Fails when a rank fails (its peers get 10 s to stop, then are
    stopped) or when the ranks outlive ``timeout`` seconds; returns each
    rank's result and the ranks' wall seconds."""
    repo = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    spec = dict(spec, out=os.path.join(root, "result%d.pt"))
    path = os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p)
    procs, logs = [], []
    t = time.perf_counter()
    try:
        for r in range(world):
            cwd = os.path.join(root, f"rank{r}")
            os.makedirs(cwd, exist_ok=True)
            logs.append(open(os.path.join(root, f"rank{r}.log"), "w"))
            child_env = dict(os.environ, **(env or {}), PYTHONPATH=path,
                             WAFER_COORDINATOR=f"127.0.0.1:{port}",
                             WAFER_NUM_PROCESSES=str(world), WAFER_PROCESS_ID=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_CHILD, json.dumps(spec)], cwd=cwd, env=child_env,
                stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                # a rank failed: its peers get a few seconds to stop by themselves
                deadline = min(deadline, time.monotonic() + 10)
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    wall = time.perf_counter() - t
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        tails = []
        for r in range(world):
            with open(os.path.join(root, f"rank{r}.log")) as fh:
                tails.append(f"--- rank {r} (exit {rcs[r]}):\n" + fh.read()[-3000:])
        check(False, f"ranks exited {rcs} within {timeout} s:\n" + "\n".join(tails))
    import torch

    return [torch.load(spec["out"] % r, weights_only=False) for r in range(world)], wall


def rank_child(spec_json):
    """One rank of a multi-process run (started by :func:`start_ranks`):
    ``spec["mode"]`` ``cli`` runs ``wafer_torch.cli.main`` on
    ``spec["config"]`` (text) and records its solves; ``chunk`` runs
    :func:`chunk_case` on this rank's device for each of ``spec["cases"]``. ``shards_per_rank`` k makes
    the rank's device list its device k times (a mesh of k shards a rank on
    one card). Saves its result to ``spec["out"] % rank``; returns the exit
    code."""
    import torch

    from wafer_torch.parallel import distributed, mesh as mesh_mod

    spec = json.loads(spec_json)
    if spec.get("threads"):
        torch.set_num_threads(spec["threads"])
    k = spec.get("shards_per_rank")
    if k:
        own = mesh_mod.local_devices
        mesh_mod.local_devices = lambda: own() * k
    if spec["mode"] == "cli":
        result = _rank_cli(spec)
    else:
        distributed.maybe_initialize_distributed()
        try:
            rt = distributed.runtime()
            result = {"cases": [chunk_case(case, rt.device) for case in spec["cases"]],
                      "backend": rt.backend, "staged": rt.staged}
            if spec.get("probe_gloo_cuda"):
                result["gloo_cuda"] = probe_gloo_cuda(rt)
        finally:
            distributed.shutdown()
    torch.save(result, spec["out"] % int(os.environ["WAFER_PROCESS_ID"]))
    return result.get("rc", 0)


def probe_gloo_cuda(rt):
    """Which of gloo's ``all_gather`` and ``broadcast`` take CUDA tensors as
    they are (the transport stages every CUDA tensor through the host
    whatever this finds): "ok" when the call ran and gave the staged
    result, else the error it raised. Every rank tries the same calls in
    the same order. Sends and receives are not tried: gloo writes a CUDA
    tensor's device pointer to its socket, and the process aborts."""
    import torch
    import torch.distributed as dist

    dev = rt.device
    mine = torch.full((4,), float(rt.rank + 1), device=dev)
    want = [torch.full((4,), float(r + 1)) for r in range(rt.world)]

    def gather():
        out = [torch.empty(4, device=dev) for _ in range(rt.world)]
        dist.all_gather(out, mine)
        return all(torch.equal(o.cpu(), w) for o, w in zip(out, want))

    def broadcast():
        x = mine.clone()
        dist.broadcast(x, src=0)
        return torch.equal(x.cpu(), want[0])

    out = {}
    for name, fn in (("all_gather", gather), ("broadcast", broadcast)):
        try:
            out[name] = "ok" if fn() else "wrong result"
        except (RuntimeError, ValueError) as exc:  # the answer this probe records
            out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:120]}"
    return out


def _rank_cli(spec):
    from wafer_torch import cli
    from wafer_torch.ops import hopper_stencil as hs

    with open("smoke.yaml", "w") as fh:
        fh.write(spec["config"])
    with recorded_solves() as rec:
        hs.reset_launches()
        t = time.perf_counter()
        rc = cli.main(["-c", "smoke.yaml"])
        wall = time.perf_counter() - t
        launches = dict(hs.LAUNCHES)
    states = [{"wnum": res.wnum, "steps": res.steps, "energy": complex(res.observables.energy),
               "norm2": res.observables.norm2, "chunk_seconds": res.chunk_seconds,
               "wall": secs, "points": n, "launches": launched, "sharded": sharded,
               "batch": res.batch, "phi": res.phi.cpu() if spec.get("keep_phi") else None}
              for res, secs, n, launched, sharded in rec.states]
    return {"rc": rc, "states": states, "plain": rec.plain, "wall": wall, "launches": launches}


def chunk_case(spec, dev):
    """One chunk of ``spec`` on its mesh (``mesh``, ``slices``), every shard
    of this process on ``dev``: the port config ``raw``, ψ and
    ``n_store`` stored states drawn from ``seed``, ``psn`` for the
    per-step-norm chunk. Returns the global ψ after the chunk (on the host),
    the measure's sums on it, the host ms a step around ``reps`` chunks that
    end in a synchronise, the host ms of the exchange alone (the flat mesh's
    per-step halo plan, the multi-slice mesh's x plan of one window) and
    the launches. With ``exchange_only`` it returns this process's blocks
    after one halo exchange instead. Runs in one process or as a rank."""
    import torch

    from wafer_torch import geometry
    from wafer_torch.config import Config
    from wafer_torch.models import potentials
    from wafer_torch.ops import hopper_stencil as hs
    from wafer_torch.parallel import make_mesh
    from wafer_torch.parallel.halo import exchange_halos, halo_copies
    from wafer_torch.parallel.multislice import make_multislice_mesh, ops_class

    cfg = Config.from_dict(spec["raw"])
    shape, slices = tuple(spec["mesh"]), spec.get("slices", 1)
    devices = [dev] * (slices * math.prod(shape))
    mesh = (make_multislice_mesh(shape, slices, devices) if slices > 1
            else make_mesh(shape, devices))
    n_store = spec.get("n_store", 0)
    split = cfg.potential.is_complex
    ops = ops_class(mesh, split)(cfg, mesh, n_store)
    ext = cfg.central_difference.ext
    dims = tuple(cfg.work_size())
    gen = torch.Generator().manual_seed(spec["seed"])
    lead = (2,) if split else ()
    psi = torch.randn(lead + dims, generator=gen) / math.sqrt(math.prod(dims))
    blocks = ops.put(psi.to(dev))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if spec.get("exchange_only"):
        exchange_halos(blocks, ext, mesh)
        sync()
        return {"blocks": [b.cpu() for b in blocks], "ranks": list(mesh.local)}
    store = stored = None
    if n_store:
        st = torch.randn((n_store,) + lead + dims, generator=gen)
        st = st / st.flatten(1).norm(dim=1).reshape((-1,) + (1,) * (st.dim() - 1))
        store, stored = ops.put_store(st.to(dev)), ops.put(st.to(dev))
    chunk = ops.evolve_chunk_psn if spec.get("psn") else ops.evolve_chunk
    hs.reset_launches()
    out = chunk(blocks, None, None, store)
    sync()
    launches = dict(hs.LAUNCHES)
    reps = spec.get("reps", 1)
    t = time.perf_counter()
    for _ in range(reps):
        chunk(blocks, None, None, store)
        sync()
    ms_step = (time.perf_counter() - t) * 1e3 / (reps * cfg.output.screen_update)
    if slices > 1:
        plan = ops._x_copies(ops._deepen(blocks, ext))
    else:
        plan = halo_copies(blocks, ext, mesh, zero_edges=False)
    plan.run()
    sync()
    t = time.perf_counter()
    for _ in range(20):
        plan.run()
    sync()
    exchange_ms = (time.perf_counter() - t) * 1e3 / 20
    vr = potentials.generate_split(cfg, device=dev) if split else potentials.generate(cfg, device=dev)
    v = ops.put(geometry.work_area(torch.stack(vr) if split else vr, ext), halo=False)
    r2 = ops.put(geometry.r2_index_grid(dims, cfg.grid.size.as_tuple(), dtype=cfg.real_dtype,
                                        device=dev), halo=False)
    sums, _phi = ops.measure(out, v, r2, None, stored)
    psi_out = ops.get(out).cpu()
    return {"psi": psi_out if spec.get("keep_phi", True) else None,
            "psi_sha256": hashlib.sha256(psi_out.numpy().tobytes()).hexdigest(),
            "sums": [complex(x) for x in sums],
            "ms_per_step": ms_step, "exchange_ms": exchange_ms, "crosses": plan.crosses,
            "launches": launches}


def smoke_raw(n, potential, dn, dt, su, **extra):
    """The raw config of the chunk phases: f32 ThreePoint on an n grid."""
    return {
        "project_name": "smoke chunk", "grid": {"size": dict(zip("xyz", n)), "dn": dn, "dt": dt},
        "tolerance": 1e-5, "central_difference": "ThreePoint", "max_steps": 1000,
        "wavenum": 0, "wavemax": 0,
        "output": {"screen_update": su, "snap_update": None, "file_type": "Json",
                   "save_wavefns": False, "save_potential": False},
        "potential": potential, "mass": 1.0, "init_condition": "Constant", "sig": 1.0,
        "init_symmetry": "NotConstrained", "precision": "f32", **extra,
    }


def smoke_config(n, potential, dn, dt, su, **extra):
    """A port ``Config`` for the chunk phases (:func:`smoke_raw`)."""
    from wafer_torch.config import Config

    return Config.from_dict(smoke_raw(n, potential, dn, dt, su, **extra))


def shard_blocks(glob, mesh, ext):
    """Each shard's block of the global interior ``glob`` (leading axes
    kept), padded, its halo filled by the port's exchange."""
    import torch.nn.functional as F

    from wafer_torch.parallel import exchange_halos

    blocks = [F.pad(glob[(...,) + tuple(slice(o, o + n) for o, n in zip(origin, shape))],
                    (ext,) * 6).contiguous()
              for shape, origin in mesh.blocks(tuple(glob.shape[-3:]))]
    exchange_halos(blocks, ext, mesh)
    return blocks


def exchange_bytes(mesh, dims, ext, comps=1, n_fields=1):
    """Bytes one halo exchange moves: each face copied into a neighbour's
    halo is read once and written once, over the padded extents of the
    other two axes (f32)."""
    bshape = [n // m for n, m in zip(dims, mesh.shape)]
    total = 0
    for axis, m in enumerate(mesh.shape):
        others = math.prod(b + 2 * ext for a, b in enumerate(bshape) if a != axis)
        total += 2 * (m - 1) * (mesh.size // m) * 2 * 4 * ext * others
    return total * comps * n_fields


def shard_kernel_vs_plain(order, kind, n_store, apply, pair, gen, dev,
                          mesh_shape=(4, 2, 1), n=(64, 64, 128)):
    """K1 (``pair``: K3) on each shard block of a mesh with the block's
    origin, against the plain version on the same block. Returns (ψ' abs
    err, ψ' rel err, reduction rel err), the worst over the blocks."""
    import torch

    from wafer_torch import geometry
    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs
    from wafer_torch.parallel import make_mesh

    ext = geometry.EXT[order]
    mesh = make_mesh(mesh_shape, [dev] * math.prod(mesh_shape))
    lead = (2,) if pair else ()
    psi = torch.randn((*lead, *n), generator=gen, device=dev)
    stores = [None] * mesh.size
    if n_store:
        st = torch.randn((n_store, *lead, *n), generator=gen, device=dev)
        st = st / torch.sqrt((st * st).sum(dim=tuple(range(1, st.dim())), keepdim=True))
        stores = shard_blocks(st, mesh, ext)
    analytic = b = None
    if kind == "streamed":
        d = 1.0 + 0.002 * torch.rand(n, generator=gen, device=dev)
        if pair:
            di = 0.0004 * torch.rand(n, generator=gen, device=dev)
            b = torch.stack([d / (d * d + di * di), -di / (d * d + di * di)])
        else:
            b = 1.0 / d
    elif pair:
        analytic = (kind, 0.2, 0.004, 1.0, *n, 1.0, 0.0, 0.2)
    else:
        analytic = analytic_for(kind, n)
    n_red = 1 + (2 if pair else 1) * n_store
    coef = torch.zeros(n_red, device=dev)
    coef[0] = 1.0
    if apply:
        coef = torch.tensor([0.9] + [0.05 * (s + 1) for s in range(n_red - 1)], device=dev)
    kernel, plain = ((hsp.sweep_step_sc, hsp.sweep_step_sc_plain) if pair
                     else (hs.sweep_step, hs.sweep_step_plain))
    scale = 0.004 / (geometry.stencil_coefficients(order)[3] * 0.2 * 0.2)
    worst = [0.0, 0.0, 0.0]
    for blk, st, (shape, origin) in zip(shard_blocks(psi, mesh, ext), stores, mesh.blocks(n)):
        b_blk = None
        if b is not None:
            b_blk = b[(...,) + tuple(slice(o, o + m) for o, m in zip(origin, shape))].contiguous()
        kw = dict(order=order, scale=scale, analytic=analytic, store=st, apply_coef=apply,
                  origin=origin, **{"b2" if pair else "b_int": b_blk})
        out_k, out_p = torch.empty_like(blk), torch.empty_like(blk)
        part_k = part_p = None
        if apply:
            part_k = torch.empty(hs.num_partials(blk[0] if pair else blk, order), n_red,
                                 dtype=torch.float64, device=dev)
            part_p = torch.empty(1, n_red, dtype=torch.float64, device=dev)
        kernel(blk, out_k, coef, part_k, **kw)
        plain(blk, out_p, coef, part_p, **kw)
        psi_abs = (out_k - out_p).abs().max().item()
        errs = [psi_abs, psi_abs / out_p.abs().max().item(), 0.0]
        if apply:
            red_k, red_p = (torch.empty(n_red, dtype=torch.float64, device=dev) for _ in range(2))
            c_k, c_p = torch.empty_like(coef), torch.empty_like(coef)
            hs.finish_coef(part_k, red_k, c_k)
            hs.finish_coef_plain(part_p, red_p, c_p)
            n2 = red_p[0].item()
            scale_s = [n2] + [n2 ** 0.5] * (n_red - 1)
            errs[2] = largest_error(abs(x - y) / z
                                    for x, y, z in zip(red_k.tolist(), red_p.tolist(), scale_s))
        worst = [max(x, y) for x, y in zip(worst, errs)]
    return worst


def mesh_step_vs_single(mesh_shape, gen, dev, n=(256, 256, 256)):
    """One sharded step — halo exchange, K1 with S = 1 and non-identity
    coefficients on each shard block into its rows of one partials buffer,
    one K2 over all rows — against the single-device step on the whole
    grid, Coulomb B. Returns (max |ψ'_mesh − ψ'_single|, reduction rel err,
    mesh ms, single ms)."""
    import torch
    import torch.nn.functional as F

    from wafer_torch import geometry
    from wafer_torch.ops import hopper_stencil as hs
    from wafer_torch.parallel import make_mesh

    mesh = make_mesh(mesh_shape, [dev] * math.prod(mesh_shape))
    an = ("Coulomb", 0.2, 0.004, 1.0, *n, 1.0, 0.0)
    psi = torch.randn(n, generator=gen, device=dev)
    low = torch.randn((1, *n), generator=gen, device=dev)
    low = low / torch.sqrt((low * low).sum())
    coef = torch.tensor([0.9, 0.05], device=dev)
    kw = dict(order="ThreePoint", scale=0.004 / (2.0 * 0.2 * 0.2), analytic=an, apply_coef=True)
    psi_pad, low_pad = F.pad(psi, (1,) * 6), F.pad(low, (1,) * 6)
    out_s = torch.empty_like(psi_pad)
    part_s = torch.empty(hs.num_partials(psi_pad, "ThreePoint"), 2, dtype=torch.float64, device=dev)
    red_s = torch.empty(2, dtype=torch.float64, device=dev)
    c_s = torch.empty_like(coef)
    finish_s = hs.finish_launcher(part_s, red_s, c_s)

    def single():
        hs.sweep_step(psi_pad, out_s, coef, part_s, store=low_pad, **kw)
        finish_s()

    blocks, stores = shard_blocks(psi, mesh, 1), shard_blocks(low, mesh, 1)
    outs = [torch.empty_like(b) for b in blocks]
    counts = [hs.num_partials(b, "ThreePoint") for b in blocks]
    part_m = torch.empty(sum(counts), 2, dtype=torch.float64, device=dev)
    rows = [part_m[sum(counts[:r]):sum(counts[:r + 1])] for r in range(mesh.size)]
    red_m = torch.empty(2, dtype=torch.float64, device=dev)
    c_m = torch.empty_like(coef)
    finish_m = hs.finish_launcher(part_m, red_m, c_m)
    from wafer_torch.parallel.halo import halo_copies

    plan = halo_copies(blocks, 1, mesh, zero_edges=False)  # made once, as a chunk does

    def sharded():
        plan.run()
        for blk, out, st, row, (_shape, origin) in zip(blocks, outs, stores, rows, mesh.blocks(n)):
            hs.sweep_step(blk, out, coef, row, store=st, origin=origin, **kw)
        finish_m()

    single()
    sharded()
    torch.cuda.synchronize()
    diff = 0.0
    for out, (shape, origin) in zip(outs, mesh.blocks(n)):
        want = out_s[tuple(slice(o + 1, o + 1 + m) for o, m in zip(origin, shape))]
        diff = max(diff, (geometry.work_area(out, 1) - want).abs().max().item())
    n2 = red_s[0].item()
    red_rel = largest_error(abs(a - b) / s
                            for a, b, s in zip(red_m.tolist(), red_s.tolist(), (n2, n2 ** 0.5)))
    return diff, red_rel, cuda_ms(sharded, 20), cuda_ms(single, 20)


def window_vs_plain(order, kind, n_store, apply, pair, n, ox, glob_x, red, gen, dev,
                    repeat=False, stream=None):
    """K1 (``pair``: K3) on a deep block of interior extents ``n`` whose
    plane 0 is global x-plane ``ox`` of a grid ``glob_x`` planes long (y and
    z at (5, 2) of a grid 7 larger), summing its partials over the interior
    x-planes ``red``, against its plain version; noise in the halo;
    ``stream`` casts the stored states (K1's bf16). Returns
    (ψ' rel err, reduction rel err, planes outside the grid all zero, and
    with ``repeat`` whether a second launch is bit-identical (else True))."""
    import torch

    from wafer_torch import geometry
    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs

    ext = geometry.EXT[order]
    lead = (2,) if pair else ()
    shape = (*lead, *(d + 2 * ext for d in n))
    origin = (ox, 5, 2)
    glob = (glob_x, n[1] + 7, n[2] + 7)
    psi = torch.randn(shape, generator=gen, device=dev)
    store = None
    if n_store:
        store = torch.randn((n_store, *shape), generator=gen, device=dev)
        store = store / torch.sqrt((store * store).sum(dim=tuple(range(1, store.dim())),
                                                       keepdim=True))
        store = store.to(stream or store.dtype)
    analytic = b = None
    if kind == "streamed":
        d = 1.0 + 0.002 * torch.rand(n, generator=gen, device=dev)
        b = torch.stack([1.0 / d, -0.0004 / d]) if pair else 1.0 / d
    elif pair:
        analytic = (kind, 0.2, 0.004, 1.0, *glob, 1.0, 0.0, 0.2)
    else:
        analytic = analytic_for(kind, glob)
    n_red = 1 + (2 if pair else 1) * n_store
    coef = torch.tensor([0.9] + [0.05 * (q + 1) * (-1) ** q for q in range(n_red - 1)],
                        device=dev)
    kernel, plain, rows = ((hsp.sweep_step_sc, hsp.sweep_step_sc_plain, hsp.num_partials) if pair
                           else (hs.sweep_step, hs.sweep_step_plain, hs.num_partials))
    scale = 0.004 / (geometry.stencil_coefficients(order)[3] * 0.2 * 0.2)
    kw = dict(order=order, scale=scale, analytic=analytic, store=store, apply_coef=apply,
              origin=origin, grid=glob, red=red, **{"b2" if pair else "b_int": b})
    out_k, out_p = torch.empty_like(psi), torch.empty_like(psi)
    part_k = part_p = None
    if apply:
        part_k = torch.empty(rows(psi, order), n_red, dtype=torch.float64, device=dev)
        part_p = torch.empty(1, n_red, dtype=torch.float64, device=dev)
    kernel(psi, out_k, coef, part_k, **kw)
    plain(psi, out_p, coef, part_p, **kw)
    same = True
    if repeat:
        out_2 = torch.empty_like(psi)
        part_2 = None if part_k is None else torch.empty_like(part_k)
        kernel(psi, out_2, coef, part_2, **kw)
        same = torch.equal(out_k, out_2) and (part_k is None or torch.equal(part_k, part_2))
    psi_rel = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
    x = out_k.narrow(-3, ext, n[0])  # the interior x-planes, full y/z
    outside = torch.cat([x.narrow(-3, 0, max(0, -ox)),
                         x.narrow(-3, min(n[0], glob_x - ox), n[0] - min(n[0], glob_x - ox))],
                        dim=-3)
    zero = bool((outside == 0).all())
    red_rel = 0.0
    if apply:
        red_k, red_p = part_k.sum(dim=0).tolist(), part_p[0].tolist()
        n2 = red_p[0]
        scale_s = [n2] + [n2 ** 0.5] * (n_red - 1)
        red_rel = largest_error(abs(x - y) / z for x, y, z in zip(red_k, red_p, scale_s))
    return psi_rel, red_rel, zero, same


# 2f's x origins of a deep block of nx planes in a grid of nx + 2: planes
# below the grid, none outside, and planes past its end
WINDOW_ORIGINS = {"below": lambda nx: -(nx // 3) - 1, "inside": lambda nx: 1,
                  "past": lambda nx: nx // 3 + 3}


def window_cases(gen, dev):
    """2f: K1 and K3 with a reduction window (the middle half of the block's
    planes) and out-of-grid planes against their plain versions over the
    orders × Coulomb and streamed B × S = 0..2 with and without the
    coefficients × RAGGED × WINDOW_ORIGINS. Returns (cases, worst ψ' rel
    err, worst reduction rel err), failing on the first that misses the
    tolerances of 2 or leaves a plane outside the grid non-zero."""
    worst, n_cases = [0.0, 0.0], 0
    for pair in (False, True):
        for order in ("ThreePoint", "FivePoint", "SevenPoint"):
            for kind in ("Coulomb", "streamed"):
                for n_store, apply in ((0, False), (0, True), (1, True), (2, True)):
                    for n in RAGGED:
                        for where, ox in WINDOW_ORIGINS.items():
                            red = (n[0] // 4, n[0] - n[0] // 4)
                            errs = window_vs_plain(order, kind, n_store, apply, pair, n,
                                                   ox(n[0]), n[0] + 2, red, gen, dev)
                            check(errs[0] <= 1e-6 and errs[1] <= 1e-5 and errs[2],
                                  f"2f {'K3' if pair else 'K1'} {n} {order} {kind} "
                                  f"S={n_store} apply={apply} origin {where}: {errs}")
                            worst = [max(a, b) for a, b in zip(worst, errs[:2])]
                            n_cases += 1
    return n_cases, worst[0], worst[1]


def full_window_is_default(pair, n_store, n, gen, dev):
    """A launch with the window (0, nx) and the grid given is bit-identical
    to the launch without them (the launch every earlier phase makes)."""
    import torch
    import torch.nn.functional as F

    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs

    lead = (2,) if pair else ()
    psi = F.pad(torch.randn((*lead, *n), generator=gen, device=dev), (1,) * 6)
    store = F.pad(torch.randn((n_store, *lead, *n), generator=gen, device=dev), (1,) * 6)
    store = store / torch.sqrt((store * store).sum())
    n_red = 1 + (2 if pair else 1) * n_store
    coef = torch.tensor([0.9] + [0.05] * (n_red - 1), device=dev)
    kernel, rows = ((hsp.sweep_step_sc, hsp.num_partials) if pair
                    else (hs.sweep_step, hs.num_partials))
    analytic = ("Coulomb", 0.2, 0.004, 1.0, *n, 1.0, 0.0) + ((0.2,) if pair else ())
    outs = []
    for extra in ({}, {"grid": n, "red": (0, n[0])}):
        out = torch.empty_like(psi)
        part = torch.empty(rows(psi, "ThreePoint"), n_red, dtype=torch.float64, device=dev)
        kernel(psi, out, coef, part, order="ThreePoint", scale=0.05, analytic=analytic,
               store=store, apply_coef=True, **extra)
        outs.append((out, part))
    torch.cuda.synchronize()
    return torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


SENTINEL = 1234.5  # 2g: what a flagged launch must leave in its outputs


def done_flag_cases(pair, n_store, n, gen, dev, kind="Coulomb", stream=None):
    """2g for K1 (``pair``: K3) on interior extents ``n`` with S stored
    states and the coefficients: a launch given a batch's flag that is
    clear equals the launch without the flag bit for bit (ψ' and partial
    rows), and with the flag set writes nothing (ψ' and the rows keep a
    sentinel). ``kind`` "streamed" streams B; ``stream`` (K1's bf16) casts
    the stored states. Returns (equal, untouched)."""
    import torch
    import torch.nn.functional as F

    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs

    lead = (2,) if pair else ()
    psi = F.pad(torch.randn((*lead, *n), generator=gen, device=dev), (1,) * 6)
    store = None
    if n_store:
        store = F.pad(torch.randn((n_store, *lead, *n), generator=gen, device=dev), (1,) * 6)
        store = (store / torch.sqrt((store * store).sum())).to(stream or store.dtype)
    n_red = 1 + (2 if pair else 1) * n_store
    coef = torch.tensor([0.9] + [0.05] * (n_red - 1), device=dev)
    kernel, rows = ((hsp.sweep_step_sc, hsp.num_partials) if pair
                    else (hs.sweep_step, hs.num_partials))
    analytic = b = None
    if kind == "streamed":
        d = 1.0 + 0.002 * torch.rand(n, generator=gen, device=dev)
        b = torch.stack([1.0 / d, -0.0004 / d]) if pair else 1.0 / d
    else:
        analytic = (kind, 0.2, 0.004, 1.0, *n, 1.0, 0.0) + ((0.2,) if pair else ())
    kw = dict(order="ThreePoint", scale=0.05, analytic=analytic, store=store, apply_coef=True,
              **{"b2" if pair else "b_int": b})
    done = torch.zeros((), dtype=torch.int32, device=dev)
    outs = []
    for flag in (None, done):
        out = torch.empty_like(psi)
        part = torch.empty(rows(psi, "ThreePoint"), n_red, dtype=torch.float64, device=dev)
        kernel(psi, out, coef, part, done=flag, **kw)
        outs.append((out, part))
    done.fill_(1)
    out = torch.full_like(psi, SENTINEL)
    part = torch.full((rows(psi, "ThreePoint"), n_red), SENTINEL, dtype=torch.float64,
                      device=dev)
    kernel(psi, out, coef, part, done=done, **kw)
    torch.cuda.synchronize()
    equal = torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    untouched = bool((out == SENTINEL).all()) and bool((part == SENTINEL).all())
    return equal, untouched


def finish_done_flag(rows, n_red, gen, dev):
    """2g for K2 on ``rows`` partial rows of ``n_red`` columns: with the
    flag clear the default launch's sums bit for bit; with it set ``red``,
    ``coef`` and the ticket stay as they were; then a live launch on the
    same launcher is within 1e-5 of the plain version, with the ticket
    zero again (a flagged launch took none). Returns (equal, untouched,
    live rel err, ticket after)."""
    import torch

    from wafer_torch.ops import hopper_stencil as hs

    part = finish_inputs(rows, n_red, gen, dev)
    red_p = torch.empty(n_red, dtype=torch.float64, device=dev)
    coef_p = torch.empty(n_red, device=dev)
    hs.finish_coef_plain(part, red_p, coef_p)
    red0, coef0 = torch.empty_like(red_p), torch.empty_like(coef_p)
    hs.finish_coef(part, red0, coef0)
    done = torch.zeros((), dtype=torch.int32, device=dev)
    red, coef = torch.empty_like(red_p), torch.empty_like(coef_p)
    launch = hs.finish_launcher(part, red, coef, done=done)
    launch()
    equal = torch.equal(red, red0) and torch.equal(coef, coef0)
    done.fill_(1)
    red.fill_(SENTINEL)
    coef.fill_(SENTINEL)
    for _ in range(3):
        launch()
    ticket = launch.scratch[:1].view(torch.int32)[0]
    untouched = (bool((red == SENTINEL).all()) and bool((coef == SENTINEL).all())
                 and int(ticket) == 0)
    done.zero_()
    launch()
    err = ((red - red_p).abs() / part.abs().sum(dim=0)).max().item()
    return equal, untouched, err, int(launch.scratch[:1].view(torch.int32)[0])


def idle_chunk_ms(n, su, n_store, dev, gen, pair=False, reps=5):
    """2g: device ms of one ``su``-step chunk (K1, or K3 for ``pair``, on
    an n³ Harmonic grid; K2 after each sweep when S > 0) captured as a
    CUDA graph, replayed with a batch's flag clear and set: (working ms,
    idle ms). An idle chunk costs its launches only."""
    import torch
    import torch.nn.functional as F

    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs

    lead = (2,) if pair else ()
    phi = F.pad(torch.randn((*lead, n, n, n), generator=gen, device=dev), (1,) * 6)
    phi = phi / torch.sqrt((phi * phi).sum())
    store = None
    if n_store:
        store = F.pad(torch.randn((n_store, *lead, n, n, n), generator=gen, device=dev),
                      (1,) * 6)
        store = store / torch.sqrt((store * store).sum())
    analytic = ("Harmonic", 0.0375, 4e-4, 1.0, n, n, n, 1.0, 0.0) + ((0.2,) if pair else ())
    chunk = hsp.evolve_chunk_sc if pair else hs.evolve_chunk
    done = torch.zeros((), dtype=torch.int32, device=dev)

    def run():
        return chunk(phi, "ThreePoint", 4e-4, 0.0375, 1.0, su, analytic, store=store,
                     done=done)

    run()  # warm-up: the launches' one-time set-up runs outside the capture
    torch.cuda.synchronize()
    before = dict(hs.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    hs.LAUNCHES.update(before)
    times = []
    for flag in (0, 1):
        done.fill_(flag)
        times.append(cuda_ms(graph.replay, reps))
    graph.reset()
    return tuple(times)


def multislice_step_bound_ms(ops, n_store, streamed, reduce, pair):
    """Bound of one step of a multi-slice chunk: every shard's deep sweep
    (its 2·R·ext recomputed planes included), K2 over their rows where the
    step reduces, the y/z face copies over the deep blocks every step and
    the x pads' copies once a window of R steps (each face read once and
    written once), f32 ThreePoint."""
    from wafer_torch.ops import hopper_stencil as hs

    comps, mesh = (2 if pair else 1), ops.mesh
    h, bx, e = ops.depth, ops.bx, ops.ext
    by, bz = ops.blocks[0][0][1:]
    deep = (bx + 2 * h, by, bz)
    padded = [d + 2 * e for d in deep]
    w = sweep_work(deep, e, n_store, streamed, reduce, pair)
    nbytes, flops = mesh.size * w[0], mesh.size * w[1]
    for axis in (1, 2):  # faces copied every step: 2·(m − 1)·(size/m) of them an axis
        m = mesh.shape[axis]
        faces = 2 * (m - 1) * (mesh.size // m)
        nbytes += faces * 2 * 4 * comps * e * math.prod(padded) // padded[axis]
    n_ring = mesh.shape[0]
    x_faces = 2 * (n_ring - 1) * (mesh.size // n_ring)
    nbytes += x_faces * 2 * 4 * comps * h * padded[1] * padded[2] / ops.slice_steps
    if reduce:
        rows = mesh.size * hs._num_blocks(*deep, e)
        k2 = finish_work(rows, ops._n_red(n_store))
        nbytes, flops = nbytes + k2[0], flops + k2[1]
    return bound((nbytes, flops))[0]


def trace_split(path):
    """How the solve loop's wall splits, from a ``trace_dir`` Chrome trace:
    the loop's span (from the first ``wafer.state_setup`` span, which starts
    the first state's solve after the job's set-up spans, to the end of the
    last ``wafer.*`` span), the device time of
    the chunks' kernels (K1/K2/K3) and of every other kernel (the measure's
    reductions and ψ's updates), the host read (the part of each
    memcpy/synchronise call after the device's last kernel ended: the
    device idles while the scalars come back) and the rest of the idle
    device time, the host's Python between launches; ms."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if str(e.get("name", "")).startswith("wafer.")
             and e.get("cat") != "gpu_user_annotation"]
    t0 = min(e["ts"] for e in spans if e["name"] == "wafer.state_setup")
    t1 = max(e["ts"] + e["dur"] for e in spans)
    kernels = sorted((e for e in events if e.get("cat") == "kernel" and t0 <= e["ts"] <= t1),
                     key=lambda e: e["ts"])
    chunk = [k for k in kernels if "sweep_step" in k["name"] or "finish_coef" in k["name"]]
    other = [k for k in kernels if not ("sweep_step" in k["name"] or "finish_coef" in k["name"])]
    ends = sorted(k["ts"] + k["dur"] for k in kernels)
    read = 0.0
    for e in events:
        if (e.get("cat") in ("cuda_runtime", "cuda_driver") and t0 <= e["ts"] <= t1
                and ("Memcpy" in e["name"] or "Synchronize" in e["name"])):
            end = e["ts"] + e["dur"]
            before = [t for t in ends if t <= end]
            read += end - max(e["ts"], before[-1] if before else e["ts"])
    wall = t1 - t0
    chunk_ms = sum(k["dur"] for k in chunk) / 1e3
    other_ms = sum(k["dur"] for k in other) / 1e3
    return {
        "wall_ms": wall / 1e3, "chunk_kernels_ms": chunk_ms, "measure_kernels_ms": other_ms,
        "host_read_ms": read / 1e3,
        "python_between_launches_ms": max(0.0, wall / 1e3 - chunk_ms - other_ms - read / 1e3),
        "kernel_events": len(kernels), "chunk_kernel_events": len(chunk),
        "spans": sorted({e["name"] for e in spans}),
        "kernel_names": sorted({k["name"] for k in chunk}),
    }


GRAPH_EXAMPLES = ("harmonic_ground.yaml", "harmonic_excited.yaml", "cornell.yaml",
                  "complex_harmonic.yaml", "coulomb_states.yaml")


def example_text(name):
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", name)) as fh:
        return fh.read()


def graph_rows(tag, states, su=500):
    """4j: each state's route, wall, chunk seconds, captures, capture ms and
    replays (``SolveResult.graphs``); fails unless every state took the
    graph route and, if it ran enough ``su``-step chunks that one of its
    two keys at most ran more than ``chunk_graph.EAGER_CHUNKS`` of them,
    captured or replayed a segment (every 500-step chunk holds one).
    Returns the rows as dicts."""
    from wafer_torch import chunk_graph

    rows = []
    for res, secs, n_points, _launched, sharded in states:
        g = res.graphs or {}
        rows.append({"run": tag, "wnum": res.wnum, "n": round(n_points ** (1 / 3)),
                     "mesh": bool(sharded), "steps": res.steps, "wall_s": secs,
                     "chunk_s": res.chunk_seconds, **g})
        check(g.get("route") == "graph", f"4j {tag} state {res.wnum}: route {g}")
        check(g.get("replays", 0) + g.get("captures", 0) > 0
              or res.steps // su < 2 * chunk_graph.EAGER_CHUNKS + 2,
              f"4j {tag} state {res.wnum}: no segment replayed: {g}")
        print(f"[4j] {tag} ({n_points} points) state {res.wnum}: route "
              f"{g.get('route')}, {res.steps} steps, wall {secs:.4f} s, chunks "
              f"{res.chunk_seconds:.4f} s, {g.get('captures', 0)} captures in "
              f"{g.get('capture_ms', 0.0):.2f} ms, {g.get('replays', 0)} replays")
    return rows


def trace_128_text():
    """4f's 128³ harmonic run: phase 4's box (dn 0.075, dt 1.6e-3), E₀."""
    return (MAIN_PATH_CONFIG.replace("smoke harmonic 256", "smoke trace 128")
            .replace("{x: 256, y: 256, z: 256}", "{x: 128, y: 128, z: 128}")
            .replace("dn: 0.0375", "dn: 0.075").replace("dt: 0.0004", "dt: 0.0016")
            .replace("wavemax: 1", "wavemax: 0"))


def traced_cli(name, config_text):
    """``cli.main`` on ``config_text`` with ``trace_dir: name`` in the
    current directory: (:func:`trace_split` of its trace, its bytes)."""
    import glob

    from wafer_torch import cli

    with open(f"{name}.yaml", "w") as fh:
        fh.write(config_text + f"trace_dir: {name}\n")
    rc = cli.main(["-c", f"{name}.yaml"])
    check(rc == 0, f"cli.main with trace_dir returned {rc} ({name})")
    (path,) = glob.glob(os.path.join(name, "*.pt.trace.json"))
    return trace_split(path), os.path.getsize(path)


def diagnostics(dev):
    """4f: a 128³ harmonic run through ``cli.main`` with ``trace_dir``; its
    trace must hold K1's kernel events and the loop's spans, and its wall
    is split by :func:`trace_split`. A traced 64³ complex harmonic run of
    two states must show K3 and K2 by name. Then ``solver.run`` with
    ``debug_nans`` and ψ set to NaN by the second chunk must raise
    NonFiniteError naming that chunk and its step. Returns (the 128³ run's
    split, its trace's bytes, its launches, the complex run's kernel names,
    the error, the 128³ run's states as :func:`recorded_solves` keeps
    them)."""
    import logging

    from wafer_torch import errors, solver
    from wafer_torch.config import Config
    from wafer_torch.ops import hopper_stencil as hs

    text = trace_128_text()
    # the 16-wide box of 4b at 64³: dn 0.25, dt 0.0192 (92 % of the bound)
    complex_text = (COMPLEX_HARMONIC_CONFIG.replace("complex harmonic 256", "trace complex 64")
                    .replace("{x: 256, y: 256, z: 256}", "{x: 64, y: 64, z: 64}")
                    .replace("dn: 0.0625", "dn: 0.25").replace("dt: 0.0012", "dt: 0.0192"))

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="wafer_torch_smoke_") as tmp:
        os.chdir(tmp)
        try:
            hs.reset_launches()
            with recorded_solves() as rec:
                split, size = traced_cli("trace", text)
            launches = dict(hs.LAUNCHES)
            split_c, _size_c = traced_cli("trace_complex", complex_text)
            with open("nan.yaml", "w") as fh:
                fh.write(text.replace("smoke trace 128", "smoke nan 128") + "debug_nans: true\n")
            calls = [0]
            orig = hs.evolve_chunk

            def poisoned(*args, **kwargs):
                calls[0] += 1
                out = orig(*args, **kwargs)
                return out.fill_(float("nan")) if calls[0] == 2 else out

            hs.evolve_chunk = poisoned
            try:
                solver.run(Config.load("nan.yaml"), logging.getLogger("wafer"), device=dev)
                raised = None
            except errors.NonFiniteError as err:
                raised = str(err)
            finally:
                hs.evolve_chunk = orig
        finally:
            os.chdir(cwd)
    check(split["chunk_kernel_events"] > 0 and any("sweep_step_kernel" in n
                                                   for n in split["kernel_names"]),
          f"the trace holds no K1 kernel events: {split}")
    check({"wafer.measure", "wafer.evolve_chunk"} <= set(split["spans"]),
          f"the trace lacks the loop's spans: {split['spans']}")
    for kernel in ("sweep_step_sc_kernel", "finish_coef_kernel"):
        check(any(kernel in n for n in split_c["kernel_names"]),
              f"the complex run's trace holds no {kernel}: {split_c['kernel_names']}")
    check(raised is not None and "ψ after the evolve chunk at step 1000" in raised,
          f"debug_nans did not raise at the poisoned chunk: {raised}")
    return split, size, launches, split_c["kernel_names"], raised, rec.states


def batched_vs_per_chunk(tag, text, mesh_shape=None, k=8):
    """4g: ``text`` with ``delayed_gram: false`` per chunk and with
    ``sync_update: k`` through :func:`main_path`, the batch's iterations
    under ``torch.cuda.set_sync_debug_mode("error")`` (the one capture a
    key waits for the device on purpose). Every state must reach the same
    steps with E/N within 1e-12 relative, or within 1e-5 when the drift
    guard released its per-step norm during the per-chunk run (a batch
    runs its chunks with the flag it started with and takes the release up
    at the next batch, as the reference's does: its f32 drift-guard test
    holds the two to 1e-5), and the batched run must launch the
    kernels (K1 or K3) and never the plain sweeps, and capture its graphs
    (every shard is on the one card). Prints each state's walls, chunk
    times and device ms a chunk (batched: measures included, idle chunks
    counted), batches, idle chunks, captures and peak memory. Returns
    (per-chunk result, batched result, bit for bit: observables and ψ)."""
    import logging

    import torch
    import yaml

    from wafer_torch import batch

    base = text + "delayed_gram: false\n"
    su = yaml.safe_load(text)["output"]["screen_update"]
    released = []

    class Releases(logging.Handler):
        def emit(self, record):
            if "resuming per-chunk normalisation" in record.getMessage():
                released.append(record.getMessage())

    handler = Releases()  # on the root: the CLI resets the "wafer" logger's handlers
    logging.getLogger().addHandler(handler)
    try:
        per = main_path(base, mesh_shape)
    finally:
        logging.getLogger().removeHandler(handler)
    tol = 1e-5 if released else 1e-12
    orig_iter, orig_capture = batch.BatchRunner._iterations, batch.BatchRunner._capture

    def strict(self, *args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig_iter(self, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def capture(self, *args, **kwargs):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return orig_capture(self, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    batch.BatchRunner._iterations, batch.BatchRunner._capture = strict, capture
    try:
        bat = main_path(base + f"sync_update: {k}\n", mesh_shape)
    finally:
        batch.BatchRunner._iterations, batch.BatchRunner._capture = orig_iter, orig_capture
    states1, states2 = per[1], bat[1]
    check(len(states1) == len(states2), f"4g {tag}: {len(states1)} and {len(states2)} solves")
    check(bat[3] == 0, f"4g {tag}: the plain sweeps ran {bat[3]} times")
    check(kernel_launches(bat[2]) + bat[2]["sweep_step_sc"] > 0, f"4g {tag}: launches {bat[2]}")
    bits = True
    for (r1, s1, n_pts, _l1, sh), (r2, s2, _n, l2, _sh) in zip(states1, states2):
        e1 = r1.observables.energy / r1.observables.norm2
        e2 = r2.observables.energy / r2.observables.norm2
        check(r1.steps == r2.steps and abs(e1 - e2) <= tol * abs(e1),
              f"4g {tag} state {r1.wnum}: batched {r2.steps} steps, E {e2!r} against per-chunk "
              f"{r1.steps}, {e1!r}")
        b = r2.batch
        check(b is not None and b["batches"] > 0 and b["captures"] > 0,
              f"4g {tag} state {r1.wnum}: batches {b}")
        bits = bits and r1.observables == r2.observables and torch.equal(r1.phi, r2.phi)
        c1, c2 = r1.steps // su, r2.steps // su + b["idle_chunks"]
        print(f"[4g] {tag} {'mesh' if sh else 'one device'} {round(n_pts ** (1 / 3))}^3 state "
              f"{r1.wnum}: {r1.steps} steps, E = {e2!r}; per chunk: wall {s1:.3f} s, chunks "
              f"{r1.chunk_seconds:.4f} s = {1e3 * r1.chunk_seconds / c1:.4f} ms a chunk, peak "
              f"{r1.peak_bytes / 2 ** 30:.3f} GiB; batched: wall {s2:.3f} s, chunks "
              f"{r2.chunk_seconds:.4f} s = {1e3 * r2.chunk_seconds / c2:.4f} ms a chunk (measures "
              f"included; {c2} chunks, {b['idle_chunks']} idle), {b['batches']} batches, "
              f"{b['captures']} graph captures in {b['capture_ms']:.1f} ms, peak "
              f"{r2.peak_bytes / 2 ** 30:.3f} GiB; launches {l2}")
    print(f"[4g] {tag}: run wall per chunk {per[4]:.3f} s, batched {bat[4]:.3f} s; batched "
          f"equals per-chunk bit for bit (observables and psi): {bits}; drift guard released "
          f"{len(released)} times per chunk, so E/N held to {tol:g} relative")
    return per, bat, bits


def run_example(argv):
    """``--example PATH [--mesh X,Y,Z] [--slices N] [--no-save]``: one
    example through the sharded main path (every shard on the card), its
    states printed; the mesh is ``N × (X, Y, Z)`` when N > 1, with N read
    from the file's ``mesh.slices`` unless given (``--slices 1`` runs a
    multi-slice example on the flat mesh); ``--no-save`` turns
    ``save_wavefns`` off."""
    import argparse

    import yaml

    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--example", required=True)
    ap.add_argument("--mesh", default="8,1,1")
    ap.add_argument("--slices", type=int, default=None)
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--procs", type=int, default=1)
    args = ap.parse_args(argv)
    with open(args.example) as fh:
        text = fh.read()
    if args.no_save:
        check("save_wavefns: true" in text, f"{args.example} does not save its wavefunction")
        text = text.replace("save_wavefns: true", "save_wavefns: false")
    slices = args.slices
    if slices is None:
        slices = int((yaml.safe_load(text).get("mesh") or {}).get("slices", 1))
    shape = tuple(int(x) for x in args.mesh.split(","))
    if args.procs > 1:
        run_example_ranks(args.example, text, shape, slices, args.procs)
        return
    energies, states, launches, plain, wall = main_path(text, shape, slices)
    check(plain == 0, f"the plain sweep ran {plain} times")
    label = f"mesh {slices} x ({args.mesh})" if slices > 1 else f"mesh {args.mesh}"
    for res, secs, n_points, launched, sharded in states:
        e = res.observables.energy / res.observables.norm2
        print(f"[example] {args.example} {label if sharded else 'one device'} "
              f"{round(n_points ** (1 / 3))}^3 state {res.wnum}: E = {e}, {res.steps} steps, "
              f"wall {secs:.2f} s, chunks {res.chunk_seconds:.2f} s = "
              f"{n_points * res.steps / res.chunk_seconds:.4g} grid-point updates/s; "
              f"launches {launched}")
    print(f"[example] {args.example}: {wall:.2f} s wall; launches {launches}")


def run_example_ranks(name, text, shape, slices, procs):
    """``--example … --procs N``: the example through ``wafer_torch.cli`` as
    N ranks on the card (gloo, staged), its mesh ``slices × shape`` dealt
    to the ranks in equal runs; each state printed with every rank's wall."""
    import yaml

    raw = yaml.safe_load(text)
    n = slices * math.prod(shape)
    check(n % procs == 0, f"{n} shards do not divide over {procs} ranks")
    raw["mesh"] = dict(raw.get("mesh") or {}, x=shape[0], y=shape[1], z=shape[2], slices=slices)
    label = f"mesh {slices} x {shape}" if slices > 1 else f"mesh {shape}"
    with tempfile.TemporaryDirectory(prefix="wafer_torch_ranks_") as root:
        ranks, wall = start_ranks({"mode": "cli", "config": yaml.safe_dump(raw),
                                   "shards_per_rank": n // procs}, procs, root, 3300,
                                  env={"WAFER_DEVICE": "cuda:0"})
    for rk in ranks:
        check(rk["rc"] == 0 and rk["plain"] == 0, f"a rank returned {rk['rc']}, plain {rk['plain']}")
    for states in zip(*(rk["states"] for rk in ranks)):
        st = states[0]
        e = st["energy"] / st["norm2"]
        check(all(s["energy"] / s["norm2"] == e and s["steps"] == st["steps"] for s in states),
              f"the ranks disagree on state {st['wnum']}")
        print(f"[example] {name} {label} over {procs} ranks {round(st['points'] ** (1 / 3))}^3 "
              f"state {st['wnum']}: E = {e.real if e.imag == 0 else e}, {st['steps']} steps, "
              f"walls {', '.join(f'{s['wall']:.2f}' for s in states)} s, chunks "
              f"{', '.join(f'{s['chunk_seconds']:.2f}' for s in states)} s = "
              f"{st['points'] * st['steps'] / st['chunk_seconds']:.4g} grid-point updates/s "
              f"(rank 0); launches {[s['launches'] for s in states]}")
    print(f"[example] {name} over {procs} ranks: {wall:.2f} s wall for all ranks, start-up "
          "included")


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from wafer_torch import geometry
    from wafer_torch.models import potentials
    from wafer_torch.ops import _build, hopper_stencil as hs, stencil

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.library()
    print(f"[1] kernels built in {time.perf_counter() - t0:.2f} s: {_build.build().name}")
    secs = _build.build_seconds(_build.build())
    print("[1] nvcc seconds a source, all started together: " + ", ".join(
        f"{name} {t:.2f}" for name, t in secs.items() if name not in ("link", "total"))
          + f"; link {secs.get('link', math.nan):.2f}; total {secs.get('total', math.nan):.2f}")
    rows, failed = register_check(_build.build().with_suffix(".log").read_text())
    for kernel, ext, s, win, regs, spill, blocks, asked in rows:
        print(f"    {SWEEP_NAMES[kernel]} EXT {ext} S {s}{' windowed' if win else ''}: {regs} "
              f"registers, {spill} spill bytes, {blocks} blocks an SM (must hold {asked})")
    check(not failed, f"main-path sweeps that spill, hold fewer blocks an SM than asked or are "
          f"missing from the build log: {failed}")
    # the wide route's kernels of the states past its rings (no main path
    # reaches them; phase 2w runs them): registers and spills at each EXT
    past = []
    for name, rep in ptxas_report(_build.build().with_suffix(".log").read_text()).items():
        inst = sweep_instance(name)
        if inst is not None and str(inst[2]).endswith("past the rings"):
            past.append((*inst, rep["registers"], rep["spill_stores"] + rep["spill_loads"]))
    past.sort()
    print("    the wide route past its rings: " + ", ".join(
        f"{SWEEP_NAMES[k]} EXT {ext} {regs} registers, {spill} spill bytes"
        for k, ext, _s, _w, regs, spill in past))
    check(len(past) == 9, f"the wide route's kernels past its rings in the build log: {past}")
    # the wide route's shared memory grows with S: its blocks an SM at each
    # count phases 2, 2b and 2i time, two at the main paths' (4k: S = 5 on
    # both stores, 4l: S = 3)
    for route, pair, bf16, counts in (("K1 f32 wide", False, False, MANY_S),
                                      ("K1 bf16 wide", False, True, MANY_S),
                                      ("K3 wide", True, False, PAIR_WIDE_S)):
        occ = [(s, *wide_occupancy(pair, bf16, 1, s)) for s in counts if s >= hs.wide_min(pair)]
        print(f"    {route} EXT 1 by S: " + ", ".join(
            f"S {s}: {b} blocks an SM, {nb / 1024:.1f} KB" for s, b, nb, _g in occ))
        check(occ[0][1] >= 2, f"{route} at S = {occ[0][0]} holds {occ[0][1]} blocks an SM")
        # past the most states its rings hold, a launch reads the rest where
        # they are used: the cap at each order (B from coordinates, streamed)
        print(f"    {route} states its rings hold at EXT 1, 2, 3: " + ", ".join(
            f"{wide_cap(pair, bf16, ext, False)} ({wide_cap(pair, bf16, ext, True)} streamed)"
            for ext in (1, 2, 3)))
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        run_example(argv)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # ---------------------------------------------------------------- 2
    gen = torch.Generator(device=dev).manual_seed(1234)
    kinds = ["NoPotential", "Harmonic", "Coulomb", "SimpleCornell", "Periodic", "streamed"]
    worst = [0.0, 0.0, 0.0, 0.0]
    n_cases = 0
    for order in ("ThreePoint", "FivePoint", "SevenPoint"):
        for kind in kinds:
            for n_store in (0, 1, 2):
                for identity in (True, False):
                    errs = kernel_vs_plain(order, kind, n_store, identity, (64, 64, 128), gen, dev)
                    check(errs[1] <= 1e-6 and errs[2] <= 1e-5,
                          f"{order} {kind} S={n_store} identity={identity}: {errs}")
                    worst = [max(a, b) for a, b in zip(worst, errs)]
                    n_cases += 1
    big = kernel_vs_plain("ThreePoint", "Harmonic", 1, False, (256, 256, 256), gen, dev)
    check(big[1] <= 1e-6 and big[2] <= 1e-5, f"256^3 case: {big}")
    worst = [max(a, b) for a, b in zip(worst, big)]
    print(f"[2] {n_cases + 1} kernel-vs-plain cases: max psi' err {worst[0]:.3e} abs "
          f"({worst[1]:.3e} of max|psi'|, tol 1e-6), max reduction err {worst[2]:.3e} "
          f"(tol 1e-5), K2 vs plain sum on the same partials {worst[3]:.3e} abs")
    n_rag, rag_psi, rag_red = ragged_cases(False, kinds, False, gen, dev)
    worst[1] = max(worst[1], rag_psi)
    for n_store, n in ((0, (256, 256, 256)), (1, (256, 256, 256)), (3, (37, 45, 29))):
        check(repeat_is_identical(False, n_store, n, gen, dev),
              f"two K1 launches on the same input differ (S={n_store}, {n})")
    print(f"[2] {n_rag} ragged K1 cases ({' '.join('x'.join(map(str, n)) for n in RAGGED)}, "
          f"S = 0..3): max psi' err {rag_psi:.3e} of max|psi'|, reductions {rag_red:.3e}; "
          f"two launches on the same input bit-identical (S = 0, 1 at 256^3, S = 3)")
    n_cb, cb_psi, cb_red = costly_b_cases(("Coulomb", "SimpleCornell"),
                                          ("ThreePoint", "SevenPoint"), gen, dev)
    worst[1] = max(worst[1], cb_psi)
    print(f"[2] {n_cb} costly-B K1 cases (Coulomb and SimpleCornell B from one rsqrt, the "
          f"examples' physics; the core in even, odd and mixed grids and at shard origins; "
          f"f32 and bf16 stores, S = 0..2; the main paths' blocks: coulomb_states.yaml, "
          f"cornell.yaml, a sharded_512.yaml shard, multislice_512.yaml's deep blocks): "
          f"max psi' err {cb_psi:.3e} of max|psi'|, "
          f"reductions {cb_red:.3e}")
    n_many, worst_many, route_many = many_state_cases(gen, dev)
    worst[1] = max(worst[1], worst_many[1])
    print(f"[2] {n_many} K1 cases with S = {', '.join(map(str, MANY_S))} stored states (the "
          f"many-state kernels up to S = {max(hs.many_states())}, the wide route past them; "
          f"orders x Harmonic/Coulomb/streamed on 64x64x128 and on ragged deep blocks with a "
          f"window at x origins below/inside/past the grid, 256^3 S = 3, 4, 5, repeats, the done "
          f"flag): max psi' err {worst_many[0]:.3e} abs ({worst_many[1]:.3e} of max|psi'|, tol "
          f"1e-6), reductions {worst_many[2]:.3e} (tol 1e-5); repeats bit-identical, planes "
          f"outside the grid zero, a set flag writes nothing")
    many_times = many_state_times(gen, dev)
    for (stream, n_store), (ms, plain, (b_ms, b_by)) in many_times.items():
        print(f"    256^3 per launch, S={n_store} {str(stream).replace('torch.', '')} store: "
              f"{ms:.4f} ms (plain {plain:.4f}, bound {b_ms:.4f} by {b_by}, "
              f"{100.0 * b_ms / ms:.1f} % of it)")

    # per-launch times at the main path's shape (256³ ThreePoint Harmonic)
    n3 = (256, 256, 256)
    psi = harmonic_state(256, 0.0375, gen, dev)
    out = torch.empty_like(psi)
    an = ("Harmonic", 0.0375, 4e-4, 1.0, *n3, 1.0, 0.0)
    scale = 4e-4 / (2.0 * 0.0375 ** 2)
    coef = torch.tensor([1.0, 0.0], device=dev)
    store = psi[None].clone()
    part = torch.empty(hs.num_partials(psi, "ThreePoint"), 2, dtype=torch.float64, device=dev)
    part1 = torch.empty(1, 2, dtype=torch.float64, device=dev)
    kw = dict(order="ThreePoint", scale=scale, analytic=an)
    sweep_ms = cuda_ms(lambda: hs.sweep_step(psi, out, coef[:1], None, **kw), 200)
    sweep_plain_ms = cuda_ms(lambda: hs.sweep_step_plain(psi, out, coef[:1], None, **kw), 20)
    sweep_exc_ms = cuda_ms(lambda: hs.sweep_step(psi, out, coef, part, store=store,
                                                 apply_coef=True, **kw), 200)
    sweep_exc_plain_ms = cuda_ms(lambda: hs.sweep_step_plain(psi, out, coef, part1, store=store,
                                                             apply_coef=True, **kw), 20)
    print(f"    256^3 per launch: sweep_step ground {sweep_ms:.4f} ms (plain {sweep_plain_ms:.4f},"
          f" bound {bound(sweep_work(n3, 1))[0]:.4f}),"
          f" S=1 {sweep_exc_ms:.4f} ms (plain {sweep_exc_plain_ms:.4f},"
          f" bound {bound(sweep_work(n3, 1, 1, reduce=True))[0]:.4f})")

    # ---------------------------------------------------------------- 2e
    n_k2, worst_k2 = 0, [0.0, 0.0]
    for rows in FINISH_ROWS:
        for n_red in FINISH_NRED:
            red_err, coef_err, same = finish_vs_plain(rows, n_red, gen, dev)
            check(red_err <= 1e-5 and coef_err <= 1e-5 and same,
                  f"K2 {rows} rows x {n_red}: reductions {red_err:.3e}, coef {coef_err:.3e}, "
                  f"repeat bit-identical {same}")
            worst_k2 = [max(worst_k2[0], red_err), max(worst_k2[1], coef_err)]
            n_k2 += 1
    for rows, n_red in ((16384, 2), (100003, 3)):
        check(finish_ticket_resets(rows, n_red, 1000, gen, dev),
              f"K2 after 1000 launches in a row ({rows} x {n_red}) is not a fresh launch")
    print(f"[2e] {n_k2} K2-vs-plain cases (rows {FINISH_ROWS} x n_red {FINISH_NRED}): max "
          f"reduction err {worst_k2[0]:.3e} of sum|x|, coef {worst_k2[1]:.3e} (tol 1e-5); two "
          f"launches bit-identical; 1000 launches in a row equal a fresh launch "
          f"(16384 x 2, 100003 x 3)")
    k2_times = [finish_times(rows, n_red, gen, dev)
                for rows, n_red in ((16384, 1), (16384, 2), (16384, 3), (2048, 1), (2048, 2),
                                    (100003, 3))]
    print("[2e] device us per launch, device held while the host enqueues 100 (torch.cuda._sleep)")
    for t in k2_times:
        print(f"     {t['rows']} rows x {t['n_red']}: finish_coef {t['k2_us']:.3f} us "
              f"({t['groups']} blocks), one block {t['one_block_us']:.3f}, partials.sum(dim=0) "
              f"{t['sum_us']:.3f}, plain {t['plain_us']:.3f}, bound {t['bound_us']:.4f}; host us "
              f"a call: chunk launcher {t['host_launcher_us']:.3f}, finish_coef "
              f"{t['host_finish_coef_us']:.3f}")
    print(json.dumps({"finish_coef_times": k2_times}))

    # ---------------------------------------------------------------- 2b
    from wafer_torch.ops import hopper_split as hsp, split_complex

    worst_sc = [0.0, 0.0, 0.0, 0.0]
    n_cases = 0
    for order in ("ThreePoint", "FivePoint", "SevenPoint"):
        for kind in ("Harmonic", "Coulomb", "streamed"):
            for n_store in (0, 1, 2):
                for identity in (True, False):
                    errs = pair_kernel_vs_plain(order, kind, n_store, identity, (64, 64, 128),
                                                gen, dev)
                    check(errs[1] <= 1e-6 and errs[2] <= 1e-5,
                          f"K3 {order} {kind} S={n_store} identity={identity}: {errs}")
                    worst_sc = [max(a, b) for a, b in zip(worst_sc, errs)]
                    n_cases += 1
    big = pair_kernel_vs_plain("ThreePoint", "Harmonic", 1, False, (256, 256, 256), gen, dev)
    check(big[1] <= 1e-6 and big[2] <= 1e-5, f"K3 256^3 case: {big}")
    worst_sc = [max(a, b) for a, b in zip(worst_sc, big)]
    print(f"[2b] {n_cases + 1} pair-kernel-vs-plain cases: max psi' err {worst_sc[0]:.3e} abs "
          f"({worst_sc[1]:.3e} of max|psi'|, tol 1e-6), max reduction err {worst_sc[2]:.3e} "
          f"(tol 1e-5), K2 (n_red = 1+2S) vs plain sum on the same partials "
          f"{worst_sc[3]:.3e} abs")
    n_rag, rag_psi, rag_red = ragged_cases(True, ("Harmonic", "Coulomb", "streamed"), False,
                                           gen, dev)
    worst_sc[1] = max(worst_sc[1], rag_psi)
    for n_store, n in ((0, (256, 256, 256)), (1, (256, 256, 256)), (3, (37, 45, 29))):
        check(repeat_is_identical(True, n_store, n, gen, dev),
              f"two K3 launches on the same input differ (S={n_store}, {n})")
    print(f"[2b] {n_rag} ragged K3 cases: max psi' err {rag_psi:.3e} of max|psi'|, reductions "
          f"{rag_red:.3e}; two launches on the same input bit-identical")
    n_pw, worst_pw = pair_wide_cases(gen, dev)
    print(f"[2b] {n_pw} K3 cases with S = {', '.join(map(str, PAIR_WIDE_S))} stored pairs (the "
          f"wide route from S = {hs.wide_min(pair=True)}; orders x ComplexHarmonic/"
          f"ComplexCoulomb/streamed on 64x64x128 and on ragged deep blocks with a window at x "
          f"origins below/inside/past the grid, 256^3, repeats, the done flag): max psi' err "
          f"{worst_pw[0]:.3e} abs ({worst_pw[1]:.3e} of max|psi'|, tol 1e-6), reductions "
          f"{worst_pw[2]:.3e} (tol 1e-5); repeats bit-identical, planes outside the grid zero, a "
          f"set flag writes nothing")
    n_cap, worst_cap, caps = wide_cap_cases(gen, dev)
    print(f"[2w] {n_cap} cases of the wide route at each order with as many stored states as "
          f"its rings hold and past them (the states past them read where they are used; K1 "
          f"f32/bf16 and K3 with Harmonic/streamed B on 64x64x128 at the cap, one more and, at "
          f"ThreePoint, {WIDE_FAR} more; ragged deep blocks with a window at x origins below/"
          f"inside/past the grid, repeats, the done flag, bf16 = f32 on its values): caps at "
          f"EXT 1, 2, 3 " + "; ".join(f"{r} {c}" for r, c in caps.items()) + "; max psi' err "
          + "; ".join(f"{r} {w[0]:.3e} abs ({w[1]:.3e} of max|psi'|)" for r, w in
                      worst_cap.items())
          + f" (tol 1e-6), reductions {max(w[2] for w in worst_cap.values()):.3e} (tol 1e-5); "
          f"repeats bit-identical, planes outside the grid zero, a set flag writes nothing")
    worst_pw[0] = max(worst_pw[0], worst_cap["K3"][0])
    pair_times = pair_wide_times(gen, dev)
    for n_store, (ms, plain, (b_ms, b_by)) in pair_times.items():
        print(f"    256^3 per launch, K3 S={n_store}: {ms:.4f} ms (plain {plain:.4f}, bound "
              f"{b_ms:.4f} by {b_by}, {100.0 * b_ms / ms:.1f} % of it)")

    # per-launch times at the complex main path's shape (256³ ThreePoint,
    # ComplexHarmonic dn 0.0625, dt 1.2e-3, absorb 0.2)
    dn_c, dt_c, absorb = 0.0625, 1.2e-3, 0.2
    an_c = ("Harmonic", dn_c, dt_c, 1.0, *n3, 1.0, 0.0, absorb)
    vr = 0.5 * (dn_c * dn_c) * geometry.r2_index_grid((258,) * 3, n3, torch.float32, dev)
    ar, ai, br, bi = potentials.build_ab_split(vr, absorb * vr, dt_c)
    b2 = geometry.work_area(torch.stack([br, bi]), 1).contiguous()
    del vr
    pair = torch.stack([harmonic_state(256, dn_c, gen, dev),
                        0.1 * harmonic_state(256, dn_c, gen, dev)])
    out_c = torch.empty_like(pair)
    store_c = pair[None].clone()
    coef_c = torch.tensor([1.0, 0.0, 0.0], device=dev)
    part_c = torch.empty(hsp.num_partials(pair, "ThreePoint"), 3, dtype=torch.float64, device=dev)
    part1_c = torch.empty(1, 3, dtype=torch.float64, device=dev)
    kwc = dict(order="ThreePoint", scale=dt_c / (2.0 * dn_c ** 2))
    sc_times = {}
    for name, kw_case in (
        ("ground analytic", dict(analytic=an_c)),
        ("ground streamed", dict(b2=b2)),
        ("S=1 analytic", dict(analytic=an_c, store=store_c, apply_coef=True)),
    ):
        k_part, p_part, cf = (part_c, part1_c, coef_c) if "store" in kw_case else (None, None,
                                                                                   coef_c[:1])
        sc_times[name] = (
            cuda_ms(lambda: hsp.sweep_step_sc(pair, out_c, cf, k_part, **kw_case, **kwc), 200),
            cuda_ms(lambda: hsp.sweep_step_sc_plain(pair, out_c, cf, p_part, **kw_case, **kwc), 20),
        )
    sc_bounds = {"ground analytic": bound(sweep_work(n3, 1, pair=True))[0],
                 "ground streamed": bound(sweep_work(n3, 1, streamed=True, pair=True))[0],
                 "S=1 analytic": bound(sweep_work(n3, 1, 1, reduce=True, pair=True))[0]}
    print("     256^3 per launch: " + ", ".join(
        f"sweep_step_sc {k} {t[0]:.4f} ms (plain {t[1]:.4f}, bound {sc_bounds[k]:.4f})"
        for k, t in sc_times.items()))

    # ---------------------------------------------------------------- 3
    dn, dt, su = 0.0375, 4e-4, 500
    v = 0.5 * (dn * dn) * geometry.r2_index_grid((258,) * 3, n3, torch.float32, dev)
    a, b = potentials.build_ab(v, dt)
    ground = harmonic_state(256, dn, gen, dev)
    excited = harmonic_state(256, dn, gen, dev, odd=True)
    store = ground[None].contiguous()
    chunk_rows = []
    for name, phi0, psn, st in (("ground", ground, False, None),
                                ("per-step-norm", ground, True, None),
                                ("excited S=1", excited, False, store)):
        def run_kernel():
            return hs.evolve_chunk(phi0, "ThreePoint", dt, dn, 1.0, su, an,
                                   per_step_norm=psn, store=st)

        def run_plain():
            return stencil.evolve_chunk(phi0, a, b, st, "ThreePoint", dt, dn, 1.0, su,
                                        0 if st is None else 1, per_step_norm=psn)

        k_ms = cuda_ms(run_kernel, 1)
        p_ms = cuda_ms(run_plain, 1)
        out_k, out_p = run_kernel(), run_plain()
        torch.cuda.synchronize()
        dpsi = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
        n_k, n_p = (out_k * out_k).double().sum().item(), (out_p * out_p).double().sum().item()
        dn2 = abs(n_k - n_p) / n_p
        check(dpsi <= 1e-4 and dn2 <= 1e-4, f"{name} chunk deviates: psi {dpsi:.3e} norm2 {dn2:.3e}")
        b_ms = step_bound_ms(n3, 0 if st is None else 1, reduce=psn or st is not None,
                             rows=hs.num_partials(phi0, "ThreePoint"))
        chunk_rows.append({"chunk": name, "kernel_ms_per_step": k_ms / su,
                           "plain_ms_per_step": p_ms / su, "bound_ms_per_step": b_ms,
                           "psi_rel_dev": dpsi, "norm2_rel_dev": dn2})
        print(f"[3] {name:13s} 500 steps at 256^3: kernel {k_ms / su:.4f} ms/step (bound "
              f"{b_ms:.4f}), plain "
              f"{p_ms / su:.4f} ms/step; psi dev {dpsi:.3e}, norm2 dev {dn2:.3e} (tol 1e-4)")
    del v, a, b, ground, excited, store

    # ---------------------------------------------------------------- 3b
    g0 = torch.stack([harmonic_state(256, dn_c, gen, dev),
                      0.1 * harmonic_state(256, dn_c, gen, dev)])
    e1 = torch.stack([harmonic_state(256, dn_c, gen, dev, odd=True),
                      0.1 * harmonic_state(256, dn_c, gen, dev, odd=True)])
    store_g = (g0 / torch.sqrt((g0 * g0).sum()))[None].contiguous()
    for name, phi0, psn, st, streamed in (("ground", g0, False, None, False),
                                          ("ground streamed", g0, False, None, True),
                                          ("per-step-norm", g0, True, None, False),
                                          ("excited S=1", e1, False, store_g, False)):
        def run_kernel():
            return hsp.evolve_chunk_sc(phi0, "ThreePoint", dt_c, dn_c, 1.0, su,
                                       None if streamed else an_c, per_step_norm=psn, store=st,
                                       b2=b2 if streamed else None)

        def run_plain():
            lr = li = None
            if st is not None:
                lr, li = st[:, 0], st[:, 1]
            return torch.stack(split_complex.evolve_chunk_sc(
                phi0[0], phi0[1], ar, ai, br, bi, lr, li, "ThreePoint", dt_c, dn_c, 1.0, su,
                0 if st is None else 1, per_step_norm=psn))

        k_ms = cuda_ms(run_kernel, 1)
        p_ms = cuda_ms(run_plain, 1)
        out_k, out_p = run_kernel(), run_plain()
        torch.cuda.synchronize()
        dpsi = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
        n_k, n_p = (out_k * out_k).double().sum().item(), (out_p * out_p).double().sum().item()
        dn2 = abs(n_k - n_p) / n_p
        check(dpsi <= 1e-4 and dn2 <= 1e-4,
              f"complex {name} chunk deviates: psi {dpsi:.3e} norm2 {dn2:.3e}")
        b_ms = step_bound_ms(n3, 0 if st is None else 1, streamed, psn or st is not None, True,
                             rows=hsp.num_partials(phi0, "ThreePoint"))
        chunk_rows.append({"chunk": f"complex {name}", "kernel_ms_per_step": k_ms / su,
                           "plain_ms_per_step": p_ms / su, "bound_ms_per_step": b_ms,
                           "psi_rel_dev": dpsi, "norm2_rel_dev": dn2})
        print(f"[3b] {name:15s} 500 steps at 256^3: kernel {k_ms / su:.4f} ms/step (bound "
              f"{b_ms:.4f}), plain "
              f"{p_ms / su:.4f} ms/step; psi dev {dpsi:.3e}, norm2 dev {dn2:.3e} (tol 1e-4)")
    del ar, ai, br, bi, b2, pair, out_c, store_c, g0, e1, store_g

    # ---------------------------------------------------------------- 4
    energies, states, launches, plain_calls, wall = main_path(MAIN_PATH_CONFIG)
    for (wnum, oracle), e in zip(((0, 1.5), (1, 2.5)), energies):
        check(abs(e - oracle) < 5e-3, f"state {wnum}: E = {e}, oracle {oracle}")
    check(launches["sweep_step"] > 0 and launches["finish_coef"] > 0,
          f"the main path did not launch every kernel: {launches}")
    check(plain_calls == 0, f"the plain sweep ran {plain_calls} times on the main path")
    for (res, secs, n_points, _l, _sh), e in zip(states, energies):
        print(f"[4] state {res.wnum}: E = {e:.6f}, {res.steps} steps, wall {secs:.2f} s, "
              f"chunks {res.chunk_seconds:.2f} s of device time = "
              f"{n_points * res.steps / res.chunk_seconds:.4g} grid-point updates/s")
    print(f"[4] cli.main 256^3 two states: {wall:.2f} s wall; launches {launches}; "
          f"plain sweep calls {plain_calls}")

    # ---------------------------------------------------------------- 4b
    runs = {"real harmonic": launches}
    e_c, states_c, launches_c, plain_c, wall_c = main_path(COMPLEX_HARMONIC_CONFIG)
    for wnum, e in enumerate(e_c):
        oracle = (wnum + 1.5) * cmath.sqrt(1 + 0.2j)
        check(abs(e.real - oracle.real) < 5e-3 and abs(e.imag - oracle.imag) < 5e-3,
              f"complex harmonic state {wnum}: E = {e}, oracle {oracle}")
    check(launches_c["sweep_step_sc"] > 0 and launches_c["finish_coef"] > 0,
          f"the complex harmonic path did not launch every kernel: {launches_c}")
    check(plain_c == 0, f"the plain sweeps ran {plain_c} times on the complex harmonic path")
    runs["complex harmonic"] = launches_c
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "complex_cornell.yaml")) as fh:
        cornell = fh.read()
    e_k, states_k, launches_k, plain_k, wall_k = main_path(cornell)
    (e,) = e_k
    check(states_k[0][0].converged and e.imag > 0.0
          and abs(e.imag - 0.2 * e.real) / abs(e.real) < 0.2,
          f"complex_cornell.yaml: E = {e}")
    check(launches_k["sweep_step_sc"] > 0, f"complex_cornell.yaml launched no K3: {launches_k}")
    check(plain_k == 0, f"the plain sweeps ran {plain_k} times on complex_cornell.yaml")
    runs["complex cornell"] = launches_k
    for tag, sts, es in (("harmonic", states_c, e_c), ("cornell", states_k, e_k)):
        for (res, secs, n_points, _l, _sh), e in zip(sts, es):
            print(f"[4b] complex {tag} state {res.wnum}: E = {e.real:.6f} {e.imag:+.6f}i, "
                  f"{res.steps} steps, wall {secs:.2f} s, chunks {res.chunk_seconds:.2f} s of "
                  f"device time = {n_points * res.steps / res.chunk_seconds:.4g} "
                  f"grid-point updates/s")
    print(f"[4b] cli.main 256^3 complex harmonic two states: {wall_c:.2f} s wall; launches "
          f"{launches_c}; complex_cornell.yaml: {wall_k:.2f} s wall; launches {launches_k}; "
          f"plain sweep calls {plain_c + plain_k}")

    # ---------------------------------------------------------------- 2c
    n5 = (512, 512, 512)
    n_cases = 0
    worst_5 = [0.0, 0.0, 0.0, 0.0]
    for kind in ("Harmonic", "streamed"):
        for n_store, identity in ((0, True), (0, False), (1, False), (2, False)):
            errs = kernel_vs_plain("ThreePoint", kind, n_store, identity, n5, gen, dev)
            check(errs[1] <= 1e-6 and errs[2] <= 1e-5,
                  f"512^3 {kind} S={n_store} identity={identity}: {errs}")
            worst_5 = [max(a, b) for a, b in zip(worst_5, errs)]
            n_cases += 1
    worst = [max(a, b) for a, b in zip(worst, worst_5)]
    print(f"[2c] {n_cases} kernel-vs-plain cases at 512^3: max psi' err {worst_5[0]:.3e} abs "
          f"({worst_5[1]:.3e} of max|psi'|, tol 1e-6), max reduction err {worst_5[2]:.3e} "
          f"(tol 1e-5), K2 vs plain sum on the same partials {worst_5[3]:.3e} abs")

    # per-launch times at the multigrid fine level (512³ ThreePoint Harmonic,
    # dn 0.03, dt 2.8e-4), each beside its bound
    dn5, dt5 = 0.03, 2.8e-4
    an5 = ("Harmonic", dn5, dt5, 1.0, *n5, 1.0, 0.0)
    v5 = 0.5 * (dn5 * dn5) * geometry.r2_index_grid((514,) * 3, n5, torch.float32, dev)
    a5, b5 = potentials.build_ab(v5, dt5)
    del v5
    b5_int = geometry.work_area(b5, 1).contiguous()
    g5 = harmonic_state(512, dn5, gen, dev)
    x5 = harmonic_state(512, dn5, gen, dev, odd=True, axis=0)
    y5 = harmonic_state(512, dn5, gen, dev, odd=True, axis=1)
    out5 = torch.empty_like(g5)
    store5 = torch.stack([g5, x5])
    n_blocks5 = hs.num_partials(g5, "ThreePoint")
    scale5 = dt5 / (2.0 * dn5 ** 2)
    launch_5 = {}
    for name, s, streamed, reps in (("ground analytic", 0, False, 50),
                                    ("ground streamed", 0, True, 50),
                                    ("S=0 reductions", 0, False, 50),
                                    ("S=1", 1, False, 20), ("S=2", 2, False, 20)):
        reduce = name.startswith("S=")
        cf = torch.tensor([0.9] + [0.05] * s, device=dev)
        part_k = torch.empty(n_blocks5, 1 + s, dtype=torch.float64, device=dev) if reduce else None
        part_p = torch.empty(1, 1 + s, dtype=torch.float64, device=dev) if reduce else None
        kw5 = dict(order="ThreePoint", scale=scale5, analytic=None if streamed else an5,
                   b_int=b5_int if streamed else None, store=store5[:s] if s else None,
                   apply_coef=reduce)
        launch_5[name] = (
            cuda_ms(lambda: hs.sweep_step(g5, out5, cf, part_k, **kw5), reps),
            cuda_ms(lambda: hs.sweep_step_plain(g5, out5, cf, part_p, **kw5), 3),
            bound(sweep_work(n5, 1, s, streamed, reduce)),
        )
    print("[2c] 512^3 per launch: " + ", ".join(
        f"sweep_step {k} {t[0]:.4f} ms (plain {t[1]:.4f}, bound {t[2][0]:.4f} by {t[2][1]}, "
        f"{100 * t[2][0] / t[0]:.1f} %)" for k, t in launch_5.items()))

    # ---------------------------------------------------------------- 3c
    su5 = 100
    for name, phi0, psn, st, streamed in (
        ("ground analytic (B6)", g5, False, None, False),
        ("ground streamed (B5)", g5, False, None, True),
        ("per-step-norm (B4 S=0)", g5, True, None, False),
        ("excited S=1 (B4)", x5, False, store5[:1], False),
        ("excited S=2 (B4)", y5, False, store5, False),
    ):
        def run_kernel():
            return hs.evolve_chunk(phi0, "ThreePoint", dt5, dn5, 1.0, su5,
                                   None if streamed else an5, per_step_norm=psn, store=st,
                                   b_int=b5_int if streamed else None)

        def run_plain():
            return stencil.evolve_chunk(phi0, a5, b5, st, "ThreePoint", dt5, dn5, 1.0, su5,
                                        0 if st is None else st.shape[0], per_step_norm=psn)

        k_ms = cuda_ms(run_kernel, 1)
        p_ms = cuda_ms(run_plain, 1)
        out_k, out_p = run_kernel(), run_plain()
        torch.cuda.synchronize()
        dpsi = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
        n_k, n_p = (out_k * out_k).double().sum().item(), (out_p * out_p).double().sum().item()
        dn2 = abs(n_k - n_p) / n_p
        check(dpsi <= 1e-4 and dn2 <= 1e-4,
              f"512^3 {name} chunk deviates: psi {dpsi:.3e} norm2 {dn2:.3e}")
        b_ms = step_bound_ms(n5, 0 if st is None else st.shape[0], streamed, psn or st is not None,
                             rows=n_blocks5)
        chunk_rows.append({"chunk": f"512^3 {name}", "kernel_ms_per_step": k_ms / su5,
                           "plain_ms_per_step": p_ms / su5, "bound_ms_per_step": b_ms,
                           "psi_rel_dev": dpsi, "norm2_rel_dev": dn2})
        print(f"[3c] {name:22s} 100 steps at 512^3: kernel {k_ms / su5:.4f} ms/step (bound "
              f"{b_ms:.4f}), plain "
              f"{p_ms / su5:.4f} ms/step; psi dev {dpsi:.3e}, norm2 dev {dn2:.3e} (tol 1e-4)")
        del out_k, out_p

    # ---------------------------------------------------------------- 2d
    from wafer_torch.parallel import make_mesh
    from wafer_torch.parallel.halo import halo_copies
    from wafer_torch.parallel.sharded import ShardedOps
    from wafer_torch.parallel.sharded_split import ShardedSplitOps

    worst_d, worst_dsc, n_cases = [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 0
    for order in ("ThreePoint", "FivePoint", "SevenPoint"):
        for pair, kinds_d in ((False, kinds), (True, ("Harmonic", "Coulomb", "streamed"))):
            for kind in kinds_d:
                for n_store, apply in ((0, False), (0, True), (1, True), (2, True)):
                    errs = shard_kernel_vs_plain(order, kind, n_store, apply, pair, gen, dev)
                    check(errs[1] <= 1e-6 and errs[2] <= 1e-5,
                          f"2d {'K3' if pair else 'K1'} {order} {kind} S={n_store}: {errs}")
                    if pair:
                        worst_dsc = [max(x, y) for x, y in zip(worst_dsc, errs)]
                    else:
                        worst_d = [max(x, y) for x, y in zip(worst_d, errs)]
                    n_cases += 1
    worst = [max(x, y) for x, y in zip(worst, worst_d + [0.0])]
    worst_sc = [max(x, y) for x, y in zip(worst_sc, worst_dsc + [0.0])]
    print(f"[2d] {n_cases} cases x 8 shard blocks of a (4, 2, 1) mesh of 64x64x128, each with its "
          f"origin: K1 max psi' err {worst_d[0]:.3e} abs ({worst_d[1]:.3e} of max|psi'|), "
          f"reductions {worst_d[2]:.3e}; K3 {worst_dsc[0]:.3e} abs ({worst_dsc[1]:.3e}), "
          f"reductions {worst_dsc[2]:.3e} (tol 1e-6, 1e-5)")
    for pair, kinds_d in ((False, kinds), (True, ("Harmonic", "Coulomb", "streamed"))):
        n_rag, rag_psi, rag_red = ragged_cases(pair, kinds_d, True, gen, dev)
        print(f"[2d] {n_rag} ragged {'K3' if pair else 'K1'} cases at origin (3, 5, 2) of a "
              f"larger grid: max psi' err {rag_psi:.3e} of max|psi'|, reductions {rag_red:.3e}")
    for mesh_shape in ((4, 2, 1), (8, 1, 1)):
        diff, red_rel, m_ms, s_ms = mesh_step_vs_single(mesh_shape, gen, dev)
        check(diff == 0.0 and red_rel <= 1e-12,
              f"2d sharded step {mesh_shape}: psi' differs by {diff}, reductions {red_rel:.3e}")
        print(f"[2d] one S=1 step at 256^3 on a {mesh_shape} mesh (Coulomb, exchange + K1 per "
              f"shard + K2) vs one device: max|psi'_mesh - psi'_single| = {diff}, reductions "
              f"{red_rel:.3e} (tol 1e-12); {m_ms:.4f} ms vs {s_ms:.4f} ms")

    # ---------------------------------------------------------------- 2f
    n_win, win_psi, win_red = window_cases(gen, dev)
    print(f"[2f] {n_win} K1/K3 cases with a reduction window and planes outside the grid "
          f"(RAGGED x orders x Coulomb/streamed x S = 0..2 x origins below/inside/past): max "
          f"psi' err {win_psi:.3e} of max|psi'|, reductions {win_red:.3e} (tol 1e-6, 1e-5); "
          f"planes outside the grid zero")
    deep = (136, 256, 512)  # a 2 x (2, 2, 1) shard of 512^3 with R = 4: 128 + 2*4 planes
    for pair, n_store, ox in ((False, 0, -4), (False, 1, 124), (False, 2, 380), (True, 1, -4),
                              (True, 0, 380)):
        errs = window_vs_plain("ThreePoint", "Harmonic", n_store, True, pair, deep, ox, 512,
                               (4, 132), gen, dev, repeat=True)
        check(errs[0] <= 1e-6 and errs[1] <= 1e-5 and errs[2] and errs[3],
              f"2f deep {'K3' if pair else 'K1'} S={n_store} x origin {ox}: {errs}")
        win_psi, win_red = max(win_psi, errs[0]), max(win_red, errs[1])
    for pair in (False, True):
        for n_store in (0, 1, 2, 3):
            for n in RAGGED + (deep,):
                check(full_window_is_default(pair, n_store, n, gen, dev),
                      f"2f {'K3' if pair else 'K1'} S={n_store} {n}: the full window differs "
                      f"from the default launch")
    for pair in (False, True):
        errs = window_vs_plain("SevenPoint", "Coulomb", 3, True, pair, (37, 45, 29), -5, 35,
                               (3, 34), gen, dev, repeat=True)
        check(errs[3], f"2f {'K3' if pair else 'K1'} S=3: two launches differ")
    print(f"[2f] deep {deep} blocks at x origins -4, 124, 380 of 512 (K1 S = 0..2, K3 S = 0, 1, "
          f"window (4, 132)): within tolerance, repeats bit-identical; the full window (0, nx) "
          f"is the default launch bit for bit (RAGGED and deep, S = 0..3)")
    worst[1] = max(worst[1], win_psi)
    worst_sc[1] = max(worst_sc[1], win_psi)

    # ---------------------------------------------------------------- 2g
    n_g = 0
    for pair in (False, True):
        for kind, n_store, n in ([("Coulomb", s_, n_) for s_ in range(4) for n_ in RAGGED]
                                 + [("streamed", s_, n_) for s_ in range(4) for n_ in RAGGED]
                                 + [("Harmonic", 0, n3), ("Harmonic", 1, n3)]):
            equal, untouched = done_flag_cases(pair, n_store, n, gen, dev, kind)
            check(equal and untouched, f"2g {'K3' if pair else 'K1'} {kind} S={n_store} {n}: "
                  f"flag clear is the default launch {equal}, flag set wrote nothing {untouched}")
            n_g += 1
    for rows, n_red in ((7, 2), (2048, 1), (16384, 2), (32768, 2), (100003, 3)):
        equal, untouched, err, ticket = finish_done_flag(rows, n_red, gen, dev)
        check(equal and untouched and err <= 1e-5 and ticket == 0,
              f"2g K2 {rows} x {n_red}: equal {equal}, untouched {untouched}, live error "
              f"{err:.3e}, ticket {ticket}")
        n_g += 1
    idle_ms = {}
    for tag, n_store, pair in (("K1 ground", 0, False), ("K1 + K2 S = 1", 1, False),
                               ("K3 ground", 0, True)):
        idle_ms[tag] = idle_chunk_ms(256, 500, n_store, dev, gen, pair)
    print(f"[2g] {n_g} cases with a batch's done flag (K1/K3: RAGGED x Coulomb/streamed x "
          f"S = 0..3 and 256^3 S = 0, 1; K2: 7 to 100,003 rows): flag clear is the default "
          f"launch bit for bit, flag set writes nothing, K2's ticket stays zero")
    for tag, (work, idle) in idle_ms.items():
        print(f"[2g] 500-step 256^3 {tag} chunk as a CUDA graph: working {work:.4f} ms, idle "
              f"(flag set) {idle:.4f} ms = {100.0 * idle / work:.2f} % of working")

    # ---------------------------------------------------------------- 3d
    cfg_r = smoke_config(n5, "Harmonic", dn5, dt5, su5)
    cfg_c = smoke_config(n5, "ComplexHarmonic", dn5, dt5, su5, absorb=0.2)
    c5 = torch.stack([g5, 0.1 * x5])
    an5c = ("Harmonic", dn5, dt5, 1.0, *n5, 1.0, 0.0, 0.2)
    for mesh_shape in ((8, 1, 1), (4, 2, 1)):
        mesh = make_mesh(mesh_shape, [dev] * math.prod(mesh_shape))
        for name, pair, phi0, psn, st, streamed in (
            ("ground analytic", False, g5, False, None, False),
            ("ground streamed", False, g5, False, None, True),
            ("per-step-norm", False, g5, True, None, False),
            ("excited S=1", False, x5, False, store5[:1], False),
            ("complex ground analytic", True, c5, False, None, False),
        ):
            ops = (ShardedSplitOps(cfg_c, mesh, 0) if pair
                   else ShardedOps(cfg_r, mesh, 0 if st is None else 1))
            if streamed:
                ops.analytic = None
            blocks = ops.put(geometry.work_area(phi0, 1))
            b_blk = ops.put(b5_int, halo=False) if streamed else None
            st_blk = None if st is None else ops.put_store(geometry.work_area(st, 1))
            chunk = ops.evolve_chunk_psn if psn else ops.evolve_chunk

            def run_mesh():
                return chunk(blocks, None, b_blk, st_blk)

            def run_single():
                if pair:
                    return hsp.evolve_chunk_sc(phi0, "ThreePoint", dt5, dn5, 1.0, su5, an5c)
                return hs.evolve_chunk(phi0, "ThreePoint", dt5, dn5, 1.0, su5,
                                       None if streamed else an5, per_step_norm=psn,
                                       store=None if st is None else st.to(ops.stream_dtype),
                                       b_int=b5_int if streamed else None)

            m_ms, s_ms = cuda_ms(run_mesh, 1), cuda_ms(run_single, 1)
            out_m, out_s = ops.get(run_mesh()), geometry.work_area(run_single(), 1)
            torch.cuda.synchronize()
            ground = not psn and st is None
            if ground:
                dpsi = (out_m - out_s).abs().max().item()
                check(dpsi == 0.0, f"3d {mesh_shape} {name}: mesh chunk differs by {dpsi}")
                dn2 = 0.0
            else:
                dpsi = ((out_m - out_s).abs().max() / out_s.abs().max()).item()
                n_m, n_s = ((x.double() ** 2).sum().item() for x in (out_m, out_s))
                dn2 = abs(n_m - n_s) / n_s
                check(dpsi <= 1e-4 and dn2 <= 1e-4,
                      f"3d {mesh_shape} {name}: psi {dpsi:.3e} norm2 {dn2:.3e}")
            # the exchange as the chunk runs it: a plan made once, replayed
            plan = halo_copies(blocks, 1, mesh, zero_edges=False)
            ex_ms = cuda_ms(plan.run, 50)
            n_store = 0 if st is None else 1
            reduce = psn or n_store > 0
            # one launch on shard 0's block, with its origin, as the chunk launches it
            (shape0, origin0), out0 = mesh.blocks(n5)[0], torch.empty_like(blocks[0])
            n_red = ops._n_red(n_store)
            coef0 = torch.tensor([0.9] + [0.05] * (n_red - 1), device=dev)
            part0 = (torch.empty(ops._rows(blocks[0]), n_red, dtype=torch.float64, device=dev)
                     if reduce else None)
            launch0 = ops._bind(blocks[0], coef0, part0, None if b_blk is None else b_blk[0],
                                None if st_blk is None else st_blk[0], origin0, reduce)
            blk_ms = cuda_ms(lambda: launch0(blocks[0], out0), 50)
            blk_bound = bound(sweep_work(shape0, 1, n_store, streamed, reduce, pair))[0]
            nbytes = exchange_bytes(mesh, n5, 1, 2 if pair else 1)
            flops = 0
            for shape, _origin in mesh.blocks(n5):
                w = sweep_work(shape, 1, n_store, streamed, reduce, pair)
                nbytes, flops = nbytes + w[0], flops + w[1]
            if reduce:
                rows = sum(ops._rows(b) for b in blocks)
                k2 = finish_work(rows, n_red)
                nbytes, flops = nbytes + k2[0], flops + k2[1]
            b_ms = bound((nbytes, flops))[0]
            chunk_rows.append({"chunk": f"512^3 mesh {mesh_shape} {name}",
                               "kernel_ms_per_step": m_ms / su5,
                               "single_device_ms_per_step": s_ms / su5,
                               "bound_ms_per_step": b_ms, "exchange_ms_per_step": ex_ms,
                               "shard_launch_ms": blk_ms, "shard_launch_bound_ms": blk_bound,
                               "psi_rel_dev": dpsi, "norm2_rel_dev": dn2})
            print(f"[3d] {str(mesh_shape):9s} {name:23s} 100 steps at 512^3: mesh "
                  f"{m_ms / su5:.4f} ms/step (one device {s_ms / su5:.4f}, bound {b_ms:.4f}, "
                  f"exchange alone {ex_ms:.4f}; one shard launch {blk_ms:.4f}, bound "
                  f"{blk_bound:.4f}); "
                  + ("bit-identical" if ground else f"psi dev {dpsi:.3e}, norm2 dev {dn2:.3e}"))
            del blocks, b_blk, st_blk, out_m, out_s, ops, out0, part0, plan
    # ---------------------------------------------------------------- 3e
    from wafer_torch.parallel.multislice import (
        MultiSliceOps, MultiSliceSplitOps, make_multislice_mesh)

    cfg_ms = smoke_config(n5, "Coulomb", dn5, dt5, su5, mesh={"x": 2, "y": 2, "z": 1,
                                                              "slices": 2})
    cfg_msc = smoke_config(n5, "ComplexHarmonic", dn5, dt5, su5, absorb=0.2,
                           mesh={"x": 2, "y": 1, "z": 1, "slices": 2})
    an5k = ("Coulomb", dn5, dt5, 1.0, *n5, 1.0, 0.0)
    for name, pair, phi0, psn, st, shape in (
        ("Coulomb ground analytic", False, g5, False, None, (2, 2, 1)),
        ("Coulomb per-step-norm", False, g5, True, None, (2, 2, 1)),
        ("Coulomb excited S=1", False, x5, False, store5[:1], (2, 2, 1)),
        ("complex ground analytic", True, c5, False, None, (2, 1, 1)),
    ):
        devices = [dev] * (2 * math.prod(shape))
        ms_mesh = make_multislice_mesh(shape, 2, devices)
        flat_mesh = make_mesh(ms_mesh.shape, devices)
        n_store = 0 if st is None else 1
        if pair:
            ops, flat = MultiSliceSplitOps(cfg_msc, ms_mesh, 0), ShardedSplitOps(cfg_msc, flat_mesh, 0)
        else:
            ops, flat = MultiSliceOps(cfg_ms, ms_mesh, n_store), ShardedOps(cfg_ms, flat_mesh, n_store)
        blocks = ops.put(geometry.work_area(phi0, 1))
        st_blk = None if st is None else ops.put_store(geometry.work_area(st, 1))

        def run_ms():
            return (ops.evolve_chunk_psn if psn else ops.evolve_chunk)(blocks, None, None, st_blk)

        def run_flat():
            return (flat.evolve_chunk_psn if psn else flat.evolve_chunk)(blocks, None, None, st_blk)

        def run_one():
            if pair:
                return hsp.evolve_chunk_sc(phi0, "ThreePoint", dt5, dn5, 1.0, su5, an5c)
            return hs.evolve_chunk(phi0, "ThreePoint", dt5, dn5, 1.0, su5, an5k,
                                   per_step_norm=psn, store=st)

        ms_ms, flat_ms, one_ms = cuda_ms(run_ms, 1), cuda_ms(run_flat, 1), cuda_ms(run_one, 1)
        out_m, out_s = ops.get(run_ms()), geometry.work_area(run_one(), 1)
        torch.cuda.synchronize()
        ground = not psn and st is None
        if ground:
            dpsi, dn2 = (out_m - out_s).abs().max().item(), 0.0
            check(dpsi == 0.0, f"3e {name}: the multi-slice chunk differs by {dpsi}")
        else:
            dpsi = ((out_m - out_s).abs().max() / out_s.abs().max()).item()
            n_m, n_s = ((x.double() ** 2).sum().item() for x in (out_m, out_s))
            dn2 = abs(n_m - n_s) / n_s
            check(dpsi <= 1e-4 and dn2 <= 1e-4, f"3e {name}: psi {dpsi:.3e} norm2 {dn2:.3e}")
        # the window's x exchange alone, as the chunk replays it on its deep blocks
        deep_blocks = ops._deepen(blocks, 1)
        x_plan = ops._x_copies(deep_blocks)
        x_ms = cuda_ms(x_plan.run, 50)
        yz_plan = ops._exchange_yz(deep_blocks, False)
        yz_ms = cuda_ms(yz_plan.run, 50) if yz_plan else 0.0
        b_ms = multislice_step_bound_ms(ops, n_store, False, psn or n_store > 0, pair)
        chunk_rows.append({"chunk": f"512^3 multi-slice 2 x {shape} {name}",
                           "kernel_ms_per_step": ms_ms / su5,
                           "flat_mesh_ms_per_step": flat_ms / su5,
                           "single_device_ms_per_step": one_ms / su5,
                           "bound_ms_per_step": b_ms, "x_exchange_ms_per_window": x_ms,
                           "yz_exchange_ms_per_step": yz_ms, "window_steps": ops.slice_steps,
                           "psi_rel_dev": dpsi, "norm2_rel_dev": dn2})
        print(f"[3e] 2 x {shape} {name:24s} 100 steps at 512^3: multi-slice {ms_ms / su5:.4f} "
              f"ms/step (flat {flat_mesh.shape} {flat_ms / su5:.4f}, one device {one_ms / su5:.4f},"
              f" bound {b_ms:.4f}; x exchange {x_ms:.4f} ms a window of {ops.slice_steps} steps,"
              f" y/z exchange {yz_ms:.4f} ms a step); "
              + ("bit-identical to one device" if ground
                 else f"psi dev {dpsi:.3e}, norm2 dev {dn2:.3e}"))
        del blocks, st_blk, out_m, out_s, ops, flat, deep_blocks, x_plan, yz_plan

    del a5, b5, b5_int, g5, x5, y5, out5, store5, c5

    # ---------------------------------------------------------------- 3h
    h_cases = []
    # 2 x (2, 1, 1) S = 1: the one-axis multi-slice mesh streams bf16, and
    # its deep stored-state pads cross the ranks as bf16 bytes
    for label, shape, slices, stores in (("flat (2, 1, 1)", [2, 1, 1], 1, (0, 1)),
                                         ("2 x (2, 2, 1)", [2, 2, 1], 2, (0, 1)),
                                         ("2 x (2, 1, 1)", [2, 1, 1], 2, (1,))):
        raw_h = smoke_raw(n3, "Harmonic", 0.0375, 4e-4, 100,
                          mesh={"x": shape[0], "y": shape[1], "z": shape[2], "slices": slices})
        for n_store in stores:
            h_cases.append({"raw": raw_h, "mesh": shape, "slices": slices, "seed": 11 + n_store,
                            "n_store": n_store, "reps": 3, "keep_phi": False,
                            "label": f"{label} {'S=1' if n_store else 'ground'}"})
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="wafer_torch_ranks_") as root:
        ranks_h, wall_h = start_ranks({"mode": "chunk", "cases": h_cases, "probe_gloo_cuda": True},
                                      2, root, 600, env={"WAFER_DEVICE": "cuda:0"})
    check(all(r["backend"] == "gloo" and r["staged"] for r in ranks_h),
          "3h: two ranks on one card did not take gloo with staging")
    print(f"[3h] two ranks on one card: gloo, CUDA tensors staged through pinned host buffers; "
          f"{wall_h:.2f} s for both ranks, start-up and {len(h_cases)} cases included; gloo "
          f"with CUDA tensors as they are: rank 0 {ranks_h[0]['gloo_cuda']}, rank 1 "
          f"{ranks_h[1]['gloo_cuda']}")
    for i, case in enumerate(h_cases):
        one = chunk_case(case, dev)
        worst_rel = 0.0
        for r, res in enumerate(rk["cases"][i] for rk in ranks_h):
            check(res["crosses"], f"3h {case['label']}: rank {r}'s exchange crosses no process")
            check(res["psi_sha256"] == one["psi_sha256"],
                  f"3h {case['label']}: rank {r}'s psi differs from one process's")
            for a, b in zip(res["sums"], one["sums"]):
                rel = abs(a - b) / abs(b) if b else abs(a)
                worst_rel = max(worst_rel, rel)
            check(worst_rel <= 1e-12, f"3h {case['label']}: sums {res['sums']} vs {one['sums']}")
            check(kernel_launches(res["launches"]) > 0
                  and (case["n_store"] == 0 or res["launches"]["finish_coef"] > 0),
                  f"3h {case['label']}: rank {r} launched {res['launches']}")
        r0, r1 = (rk["cases"][i] for rk in ranks_h)
        chunk_rows.append({"chunk": f"256^3 two ranks {case['label']}",
                           "ms_per_step_rank0": r0["ms_per_step"],
                           "ms_per_step_rank1": r1["ms_per_step"],
                           "one_process_ms_per_step": one["ms_per_step"],
                           "exchange_ms_rank0": r0["exchange_ms"],
                           "exchange_ms_rank1": r1["exchange_ms"],
                           "one_process_exchange_ms": one["exchange_ms"],
                           "sums_rel_dev": worst_rel})
        print(f"[3h] {case['label']:20s} 100 steps at 256^3 over two ranks: "
              f"{r0['ms_per_step']:.4f} / {r1['ms_per_step']:.4f} ms/step (one process "
              f"{one['ms_per_step']:.4f}); exchange alone {r0['exchange_ms']:.4f} / "
              f"{r1['exchange_ms']:.4f} ms (one process {one['exchange_ms']:.4f}"
              f"{', a window' if case['slices'] > 1 else ', a step'}); psi bit for bit on "
              f"both ranks, sums within {worst_rel:.1e}")

    # ---------------------------------------------------------------- 4c
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "multigrid_512.yaml")) as fh:
        mg_text = fh.read()
    check("wavemax: 0\n" in mg_text, "examples/multigrid_512.yaml no longer says wavemax: 0")
    mg_runs = {}
    for tag, text, oracles in (
        ("multigrid_512.yaml", mg_text, ((1.5, 5e-3),)),
        ("multigrid_512.yaml wavemax 1", mg_text.replace("wavemax: 0\n", "wavemax: 1\n"),
         ((1.5, 5e-3), (2.5, 1e-2))),
    ):
        e_m, states_m, launches_m, plain_m, wall_m = main_path(text)
        for (oracle, tol), e in zip(oracles, e_m):
            check(abs(e - oracle) < tol, f"{tag}: E = {e}, oracle {oracle} within {tol}")
        levels = [n for _r, _s, n, _l, _sh in states_m]
        expect = [n ** 3 for n in (128, 256, 512) for _ in oracles]
        check(levels == expect, f"{tag}: solved levels {levels}, expected {expect}")
        for res, _s, n_points, launched, _sh in states_m:
            check(kernel_launches(launched) > 0,
                  f"{tag}: K1 did not launch at {n_points} points, state {res.wnum}")
        check(plain_m == 0, f"the plain sweep ran {plain_m} times on {tag}")
        for (res, secs, n_points, launched, _sh) in states_m:
            side = round(n_points ** (1 / 3))
            print(f"[4c] {tag} level {side}^3 state {res.wnum}: "
                  f"E = {res.observables.energy / res.observables.norm2:.6f}, "
                  f"{res.steps} steps, wall {secs:.2f} s, chunks {res.chunk_seconds:.2f} s of "
                  f"device time = {n_points * res.steps / res.chunk_seconds:.4g} grid-point "
                  f"updates/s; launches {launched}")
        print(f"[4c] cli.main {tag}: {wall_m:.2f} s wall; launches {launches_m}; "
              f"plain sweep calls {plain_m}")
        runs[tag] = launches_m
        mg_runs[tag] = e_m

    # ---------------------------------------------------------------- 4d
    def mesh_text(text, shape):
        return text + "mesh: {x: %d, y: %d, z: %d}\n" % shape

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "multigrid_sharded_512.yaml")) as fh:
        mgs_text = fh.read()
    check("x: 8\n  y: 1\n  z: 1" in mgs_text, "multigrid_sharded_512.yaml is no longer 8x1x1")
    sharded_runs = (
        ("multigrid_sharded_512.yaml", mgs_text, (8, 1, 1), ((1.5, 5e-3),), None),
        ("real harmonic 256^3 (4, 2, 1)", mesh_text(MAIN_PATH_CONFIG, (4, 2, 1)), (4, 2, 1),
         ((1.5, 5e-3), (2.5, 5e-3)), (states, energies)),
        ("complex harmonic 256^3 (2, 2, 1)", mesh_text(COMPLEX_HARMONIC_CONFIG, (2, 2, 1)),
         (2, 2, 1), [((w + 1.5) * cmath.sqrt(1 + 0.2j), 5e-3) for w in (0, 1)],
         (states_c, e_c)),
    )
    per_chunk_4d = {}
    for tag, text, shape, oracles, single in sharded_runs:
        e_d, states_d, launches_d, plain_d, wall_d = main_path(text, shape)
        for (oracle, tol), e in zip(oracles, e_d):
            check(abs(e.real - oracle.real) < tol and abs(e.imag - oracle.imag) < tol,
                  f"{tag}: E = {e}, oracle {oracle} within {tol}")
        sharded = [st for st in states_d if st[4]]
        check(len(sharded) == len(oracles), f"{tag}: {len(sharded)} sharded states")
        if single is None:
            levels = [(n, sh) for _r, _s, n, _l, sh in states_d]
            check(levels == [(128 ** 3, False), (256 ** 3, False), (512 ** 3, True)],
                  f"{tag}: solved levels {levels}")
        else:
            for (res, *_r), (res1, *_r1), e, e1 in zip(sharded, single[0], e_d, single[1]):
                check(abs(res.steps - res1.steps) <= 500 and abs(e - e1) < 1e-5,
                      f"{tag} state {res.wnum}: {res.steps} steps, E {e} against one device's "
                      f"{res1.steps}, {e1}")
        sweep = "sweep_step_sc" if "complex" in tag else "sweep_step"
        for res, _s, n_points, launched, _sh in sharded:
            check(kernel_launches(launched, "complex" in tag) > 0,
                  f"{tag}: {sweep} did not launch in state {res.wnum}")
            check(res.wnum == 0 or launched["finish_coef"] > 0,
                  f"{tag}: finish_coef did not launch in excited state {res.wnum}")
        check(plain_d == 0, f"the plain sweeps ran {plain_d} times on {tag}")
        for res, secs, n_points, launched, sh in states_d:
            e = res.observables.energy / res.observables.norm2
            print(f"[4d] {tag} {'mesh' if sh else 'one device'} {round(n_points ** (1 / 3))}^3 "
                  f"state {res.wnum}: E = {e:.6f}, {res.steps} steps, wall {secs:.2f} s, chunks "
                  f"{res.chunk_seconds:.2f} s of device time = "
                  f"{n_points * res.steps / res.chunk_seconds:.4g} grid-point updates/s; "
                  f"launches {launched}")
        print(f"[4d] solver.run {tag}: {wall_d:.2f} s wall; launches {launches_d}; "
              f"plain sweep calls {plain_d}")
        runs[tag] = launches_d
        per_chunk_4d[tag] = states_d
    # ---------------------------------------------------------------- 4e
    def slices_text(text, shape):
        return text + "mesh: {x: %d, y: %d, z: %d, slices: 2}\n" % shape

    runs_4e = {}

    for tag, text, shape, oracles, single in (
        ("real harmonic 256^3 2 x (2, 2, 1)", slices_text(MAIN_PATH_CONFIG, (2, 2, 1)), (2, 2, 1),
         ((1.5, 5e-3), (2.5, 5e-3)), (states, energies)),
        ("complex harmonic 256^3 2 x (2, 1, 1)", slices_text(COMPLEX_HARMONIC_CONFIG, (2, 1, 1)),
         (2, 1, 1), [((w + 1.5) * cmath.sqrt(1 + 0.2j), 5e-3) for w in (0, 1)],
         (states_c, e_c)),
    ):
        e_d, states_d, launches_d, plain_d, wall_d = main_path(text, shape, slices=2)
        sweep = "sweep_step_sc" if "complex" in tag else "sweep_step"
        check(len(states_d) == len(oracles) and all(st[4] for st in states_d),
              f"4e {tag}: {len(states_d)} states")
        for (oracle, tol), e, (res, _s, _n, launched, _sh), (res1, *_r1), e1 in zip(
                oracles, e_d, states_d, single[0], single[1]):
            check(abs(e.real - oracle.real) < tol and abs(e.imag - oracle.imag) < tol,
                  f"4e {tag}: E = {e}, oracle {oracle} within {tol}")
            check(abs(res.steps - res1.steps) <= 500 and abs(e - e1) < 1e-5,
                  f"4e {tag} state {res.wnum}: {res.steps} steps, E {e} against one device's "
                  f"{res1.steps}, {e1}")
            check(kernel_launches(launched, "complex" in tag) > 0,
                  f"4e {tag}: {sweep} did not launch in state {res.wnum}")
            check(res.wnum == 0 or launched["finish_coef"] > 0,
                  f"4e {tag}: finish_coef did not launch in excited state {res.wnum}")
        check(plain_d == 0, f"the plain sweeps ran {plain_d} times on {tag}")
        for res, secs, n_points, launched, _sh in states_d:
            e = res.observables.energy / res.observables.norm2
            print(f"[4e] {tag} state {res.wnum}: E = {e:.6f}, {res.steps} steps, wall {secs:.2f} s,"
                  f" chunks {res.chunk_seconds:.2f} s of device time = "
                  f"{n_points * res.steps / res.chunk_seconds:.4g} grid-point updates/s; "
                  f"launches {launched}")
        print(f"[4e] solver.run {tag}: {wall_d:.2f} s wall; launches {launches_d}; plain sweep "
              f"calls {plain_d}")
        runs[tag] = launches_d
        runs_4e[tag] = states_d

    # ---------------------------------------------------------------- 4f
    split, trace_bytes, launches_f, names_c, raised, states_4f = diagnostics(dev)
    runs["trace_dir 128^3"] = launches_f
    print(f"[4f] cli.main 128^3 harmonic with trace_dir: trace {trace_bytes} bytes, "
          f"{split['kernel_events']} kernel events ({split['chunk_kernel_events']} of "
          f"{', '.join(split['kernel_names'])}), spans {', '.join(split['spans'])}; launches "
          f"{launches_f}; the traced 64^3 complex run's chunk kernels: {'; '.join(names_c)}")
    print(f"[4f] the traced loop's wall {split['wall_ms']:.3f} ms = chunk kernels "
          f"{split['chunk_kernels_ms']:.3f} + measure kernels {split['measure_kernels_ms']:.3f} + "
          f"host read {split['host_read_ms']:.3f} + Python between launches "
          f"{split['python_between_launches_ms']:.3f} ms")
    print(f"[4f] debug_nans with psi set to NaN by the second chunk: {raised}")
    print(json.dumps({"trace_split": split}))

    # ---------------------------------------------------------------- 4g
    batched_runs = (
        ("real harmonic 256^3", MAIN_PATH_CONFIG, None),
        ("complex harmonic 256^3", COMPLEX_HARMONIC_CONFIG, None),
        # its Gaussian IC draws without a seed: both runs take seed 7
        ("multigrid_512.yaml", mg_text + "seed: 7\n", None),
        ("real harmonic 256^3 (4, 2, 1)", mesh_text(MAIN_PATH_CONFIG, (4, 2, 1)), (4, 2, 1)),
        ("harmonic 128^3", trace_128_text(), None),
    )
    all_bits = True
    for tag, text, shape in batched_runs:
        _per, bat, bits = batched_vs_per_chunk(tag, text, shape)
        runs[f"4g {tag}"] = bat[2]
        all_bits = all_bits and bits
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="wafer_torch_smoke_") as tmp:
        os.chdir(tmp)
        try:
            split_b, _size_b = traced_cli("trace_batched", trace_128_text() + "sync_update: 8\n")
        finally:
            os.chdir(cwd)
    print(f"[4g] the traced 128^3 run with sync_update 8: the loop's wall "
          f"{split_b['wall_ms']:.3f} ms = chunk kernels {split_b['chunk_kernels_ms']:.3f} + "
          f"measure kernels {split_b['measure_kernels_ms']:.3f} + host read "
          f"{split_b['host_read_ms']:.3f} + Python between launches "
          f"{split_b['python_between_launches_ms']:.3f} ms (4f per chunk: {split['wall_ms']:.3f} "
          f"ms); spans {', '.join(split_b['spans'])}")
    print(f"[4g] every batched run equals its per-chunk run bit for bit: {all_bits}")
    print(json.dumps({"trace_split_batched": split_b}))

    # ---------------------------------------------------------------- 4h
    def ground_only(text):
        return text.replace("wavemax: 1\n", "wavemax: 0\n")

    tag_ms, tag_msc = ("real harmonic 256^3 2 x (2, 2, 1)", "complex harmonic 256^3 2 x (2, 1, 1)")
    flat_text = mesh_text(MAIN_PATH_CONFIG, (2, 1, 1))  # E₁ streams bf16 on the ranks
    _e_f, states_f, _l_f, _p_f, _w_f = main_path(flat_text, (2, 1, 1))
    h4_runs = [
        (tag_ms, slices_text(MAIN_PATH_CONFIG, (2, 2, 1)), 4,
         [(1.5, 5e-3), (2.5, 5e-3)], runs_4e[tag_ms]),
        (tag_msc + " E0", slices_text(ground_only(COMPLEX_HARMONIC_CONFIG), (2, 1, 1)), 2,
         [(1.5 * cmath.sqrt(1 + 0.2j), 5e-3)], runs_4e[tag_msc][:1]),
        ("real harmonic 256^3 (2, 1, 1)", flat_text, 1, [(1.5, 5e-3), (2.5, 5e-3)], states_f),
    ]
    legs = [("gloo, one card", {"WAFER_DEVICE": "cuda:0"}, h4_runs)]
    if torch.cuda.device_count() >= 2:
        legs.append(("NCCL, a card a rank", {}, h4_runs[:1]))
    else:
        print("[4h] the NCCL leg (4h.1 with a card a rank) was not run: this machine has "
              f"{torch.cuda.device_count()} card")
    for leg, env_h, leg_runs in legs:
        for tag, text, per_rank, oracles, single in leg_runs:
            torch.cuda.empty_cache()
            with tempfile.TemporaryDirectory(prefix="wafer_torch_ranks_") as root:
                ranks, wall_r = start_ranks({"mode": "cli", "config": text,
                                             "shards_per_rank": per_rank}, 2, root, 900, env=env_h)
                outputs = [os.path.isdir(os.path.join(root, f"rank{r}", "output"))
                           for r in range(2)]
            check(outputs == [True, False], f"4h {tag}: output directories {outputs}")
            sweep = "sweep_step_sc" if "complex" in tag else "sweep_step"
            for r, rk in enumerate(ranks):
                sts = rk["states"]
                check(rk["rc"] == 0 and rk["plain"] == 0 and len(sts) == len(oracles),
                      f"4h {tag}: rank {r} rc {rk['rc']}, plain {rk['plain']}, {len(sts)} states")
                for st, (oracle, tol), (res1, *_r1) in zip(sts, oracles, single):
                    e = st["energy"] / st["norm2"]
                    e1 = res1.observables.energy / res1.observables.norm2
                    check(abs(e.real - oracle.real) < tol and abs(e.imag - oracle.imag) < tol,
                          f"4h {tag}: E = {e}, oracle {oracle}")
                    check(st["steps"] == res1.steps and abs(e - e1) <= 1e-12 * abs(e1),
                          f"4h {tag} rank {r} state {st['wnum']}: {st['steps']} steps, E {e} "
                          f"against one process's {res1.steps}, {e1}")
                    check(kernel_launches(st["launches"], "complex" in tag) > 0,
                          f"4h {tag}: rank {r} did not launch {sweep} in state {st['wnum']}")
            runs[f"4h {leg} {tag}"] = {k: sum(rk["launches"][k] for rk in ranks)
                                       for k in ranks[0]["launches"]}
            for st0, st1, (res1, secs1, *_x) in zip(ranks[0]["states"], ranks[1]["states"], single):
                e = st0["energy"] / st0["norm2"]
                same = e == res1.observables.energy / res1.observables.norm2
                print(f"[4h] {leg}: {tag} state {st0['wnum']}: E = {e}, {st0['steps']} steps "
                      f"(one process {res1.steps}, E bit for bit: {same}); "
                      f"wall {st0['wall']:.2f} / {st1['wall']:.2f} s (one process {secs1:.2f}), "
                      f"chunks {st0['chunk_seconds']:.2f} / {st1['chunk_seconds']:.2f} s "
                      f"(one process {res1.chunk_seconds:.2f}); launches {st0['launches']} / "
                      f"{st1['launches']}")
            print(f"[4h] {leg}: {tag}: {wall_r:.2f} s for both ranks, start-up included; only "
                  f"rank 0's output directory exists")

    # ---------------------------------------------------------------- 2i
    from wafer_torch import solver

    bf16, f32 = torch.bfloat16, torch.float32
    orders = ("ThreePoint", "FivePoint", "SevenPoint")
    worst_i, n_i = [0.0, 0.0, 0.0, 0.0], 0
    for order in orders:
        for kind in ("Harmonic", "Coulomb", "streamed"):
            for n_store in (1, 2):
                for identity in (True, False):
                    errs = kernel_vs_plain(order, kind, n_store, identity, (64, 64, 128), gen,
                                           dev, stream=bf16)
                    check(errs[1] <= 1e-6 and errs[2] <= 1e-5,
                          f"2i {order} {kind} S={n_store} identity={identity}: {errs}")
                    worst_i = [max(a, b) for a, b in zip(worst_i, errs)]
                    n_i += 1
    big = kernel_vs_plain("ThreePoint", "Harmonic", 1, False, n3, gen, dev, stream=bf16)
    check(big[1] <= 1e-6 and big[2] <= 1e-5, f"2i 256^3 case: {big}")
    worst_i = [max(a, b) for a, b in zip(worst_i, big)]
    rag_i = [0, 0.0, 0.0]
    for with_origin in (False, True):
        n_r, r_psi, r_red = ragged_cases(False, ("Harmonic", "Coulomb", "streamed"), with_origin,
                                         gen, dev, stream=bf16)
        rag_i = [rag_i[0] + n_r, max(rag_i[1], r_psi), max(rag_i[2], r_red)]
    n_w, w_psi, w_red = 0, 0.0, 0.0
    for order in orders:
        for kind in ("Coulomb", "streamed"):
            for n_store in (1, 2):
                for n in RAGGED:
                    for where, ox in WINDOW_ORIGINS.items():
                        red = (n[0] // 4, n[0] - n[0] // 4)
                        errs = window_vs_plain(order, kind, n_store, True, False, n, ox(n[0]),
                                               n[0] + 2, red, gen, dev, stream=bf16)
                        check(errs[0] <= 1e-6 and errs[1] <= 1e-5 and errs[2],
                              f"2i window {n} {order} {kind} S={n_store} origin {where}: {errs}")
                        n_w, w_psi, w_red = n_w + 1, max(w_psi, errs[0]), max(w_red, errs[1])
    for n_store, n in ((1, n3), (2, n3)):
        check(repeat_is_identical(False, n_store, n, gen, dev, stream=bf16),
              f"2i: two bf16 K1 launches on the same input differ (S={n_store}, {n})")
    n_many_i, worst_many_i, route_many_i = many_state_cases(gen, dev, stream=bf16)
    worst_i = [max(worst_i[0], worst_many_i[0]), max(worst_i[1], worst_many_i[1]),
               max(worst_i[2], worst_many_i[2]), worst_i[3]]
    n_d = 0
    for n_store in (1, 2):
        for n in RAGGED + ((64, 64, 128),):
            for kind in ("Coulomb", "streamed"):
                equal, untouched = done_flag_cases(False, n_store, n, gen, dev, kind, stream=bf16)
                check(equal and untouched, f"2i done flag {n} {kind} S={n_store}: clear is the "
                      f"default launch {equal}, set writes nothing {untouched}")
                n_d += 1
    n_x = 0
    for order in orders:
        for n_store in (1, 2, *MANY_S):
            for n in RAGGED + ((64, 64, 128),):
                # an origin with odd oz alone, and one with a reduction window
                for origin, red in (((0, 0, 0), None), ((3, 5, 3), None),
                                    ((3, 5, 2), (n[0] // 4, n[0] - n[0] // 4))):
                    check(bf16_is_f32_on_its_values(order, n_store, n, gen, dev, origin, red),
                          f"2i {order} S={n_store} {n} origin {origin}: the bf16 launch is not "
                          f"the f32 launch on the same values")
                    n_x += 1
    check(bf16_is_f32_on_its_values("ThreePoint", 1, n3, gen, dev),
          "2i 256^3 S=1: the bf16 launch is not the f32 launch on the same values")
    for kind in ("Coulomb", "SimpleCornell"):
        for order in orders:
            for n_store in (1, 2):
                for width in ROW_COPY_SHAPES:
                    equal, counted = row_copy_case(order, n_store, width, gen, dev, kind)
                    check(equal and counted, f"2i {kind} {order} S={n_store} {width}-byte rows: "
                          f"bit for bit {equal}, counted {counted}")
                    n_x += 1
    print(f"[2i] {n_i + 1} bf16-stream K1-vs-plain cases (orders x Harmonic/Coulomb/streamed x "
          f"S = 1, 2 x identity, 64x64x128, and 256^3 S = 1) and {n_many_i} with S = "
          f"{', '.join(map(str, MANY_S))} (2's many-state cases on bf16 stores): max psi' err "
          f"{worst_i[0]:.3e} abs ({worst_i[1]:.3e} of max|psi'|, tol 1e-6), reductions "
          f"{worst_i[2]:.3e} (tol 1e-5); "
          f"{rag_i[0]} ragged cases with and without an origin: {rag_i[1]:.3e}, {rag_i[2]:.3e}; "
          f"{n_w} reduction-window cases (S = 1, 2): {w_psi:.3e}, {w_red:.3e}; repeats "
          f"bit-identical; {n_d} done-flag cases with S = 1, 2 (clear: the default launch bit "
          f"for bit; set: nothing written); "
          f"{n_x + 1} cases where the bf16 launch equals the f32 launch on the same values "
          f"bit for bit (psi' and partial rows; S = 1, 2, {', '.join(map(str, MANY_S))})")

    # ---------------------------------------------------------------- 3i
    an3 = ("Harmonic", dn, dt, 1.0, *n3, 1.0, 0.0)
    v3 = 0.5 * (dn * dn) * geometry.r2_index_grid((258,) * 3, n3, torch.float32, dev)
    a3, b3 = potentials.build_ab(v3, dt)
    del v3
    g3, x3 = harmonic_state(256, dn, gen, dev), harmonic_state(256, dn, gen, dev, odd=True)
    st3 = g3[None].contiguous()
    out3 = torch.empty_like(g3)
    coef3 = torch.tensor([0.9, 0.05], device=dev)
    part3 = torch.empty(hs.num_partials(g3, "ThreePoint"), 2, dtype=torch.float64, device=dev)
    part3_1 = torch.empty(1, 2, dtype=torch.float64, device=dev)
    kw3 = dict(order="ThreePoint", scale=dt / (2.0 * dn * dn), analytic=an3, apply_coef=True)
    launch_i = {}
    for stream in (bf16, f32):
        stv = st3.to(stream)
        launch_i[stream] = (
            cuda_ms(lambda: hs.sweep_step(x3, out3, coef3, part3, store=stv, **kw3), 200),
            cuda_ms(lambda: hs.sweep_step_plain(x3, out3, coef3, part3_1, store=stv, **kw3), 20),
            bound(sweep_work(n3, 1, 1, reduce=True, stream_bytes=stv.element_size())),
        )
    print("[3i] 256^3 S=1 per launch: " + ", ".join(
        f"sweep_step {str(k).split('.')[-1]} store {t[0]:.4f} ms (plain {t[1]:.4f}, bound "
        f"{t[2][0]:.4f} by {t[2][1]}, share {100 * t[2][0] / t[0]:.1f} %)"
        for k, t in launch_i.items()))

    def stream_chunks(tag, n, su_, phi0, st, an_, a_, b_, dt_, dn_):
        """The chunk of ``phi0`` with stored states ``st`` streamed in bf16
        and in f32, each against the plain chunk on the same values (the
        tolerances of 3), timed beside its bound; then the two streams
        against each other."""
        outs = {}
        for stream in (bf16, f32):
            stv = st.to(stream)

            def run_kernel():
                return hs.evolve_chunk(phi0, "ThreePoint", dt_, dn_, 1.0, su_, an_, store=stv)

            def run_plain():
                return stencil.evolve_chunk(phi0, a_, b_, stv.float(), "ThreePoint", dt_, dn_,
                                            1.0, su_, st.shape[0])

            k_ms, p_ms = cuda_ms(run_kernel, 1), cuda_ms(run_plain, 1)
            out_k, out_p = run_kernel(), run_plain()
            torch.cuda.synchronize()
            dpsi = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
            n_k, n_p = ((x.double() ** 2).sum().item() for x in (out_k, out_p))
            dn2 = abs(n_k - n_p) / n_p
            name = str(stream).split(".")[-1]
            check(dpsi <= 1e-4 and dn2 <= 1e-4,
                  f"3i {tag} {name} chunk deviates: psi {dpsi:.3e} norm2 {dn2:.3e}")
            b_ms = step_bound_ms(n, st.shape[0], reduce=True, rows=hs.num_partials(phi0, "ThreePoint"),
                                 stream_bytes=stv.element_size())
            chunk_rows.append({"chunk": f"{tag} {name} streams", "kernel_ms_per_step": k_ms / su_,
                               "plain_ms_per_step": p_ms / su_, "bound_ms_per_step": b_ms,
                               "psi_rel_dev": dpsi, "norm2_rel_dev": dn2})
            print(f"[3i] {tag} {name:8s} streams {su_} steps: kernel {k_ms / su_:.4f} ms/step "
                  f"(bound {b_ms:.4f}, share {100 * b_ms * su_ / k_ms:.1f} %), plain "
                  f"{p_ms / su_:.4f} ms/step; psi dev {dpsi:.3e}, norm2 dev {dn2:.3e} (tol 1e-4)")
            outs[stream] = out_k
            del out_p
        rel = ((outs[bf16] - outs[f32]).abs().max() / outs[f32].abs().max()).item()
        print(f"[3i] {tag}: bf16 against f32 streams after {su_} steps: max|dpsi| {rel:.3e} of "
              f"max|psi|")

    stream_chunks("256^3 S=1", n3, 500, x3, st3, an3, a3, b3, dt, dn)
    del a3, b3, g3, x3, st3, out3
    v5 = 0.5 * (dn5 * dn5) * geometry.r2_index_grid((514,) * 3, n5, torch.float32, dev)
    a5, b5 = potentials.build_ab(v5, dt5)
    del v5
    g5 = harmonic_state(512, dn5, gen, dev)
    x5 = harmonic_state(512, dn5, gen, dev, odd=True, axis=0)
    y5 = harmonic_state(512, dn5, gen, dev, odd=True, axis=1)
    store5 = torch.stack([g5, x5])
    stream_chunks("512^3 S=1", n5, su5, x5, store5[:1], an5, a5, b5, dt5, dn5)
    stream_chunks("512^3 S=2", n5, su5, y5, store5, an5, a5, b5, dt5, dn5)
    del a5, b5
    mesh8 = make_mesh((8, 1, 1), [dev] * 8)
    outs = {}
    for env_value in ("bf16", "f32"):
        with exc_stream(env_value):
            ops = ShardedOps(cfg_r, mesh8, 1)
        stream = ops.stream_dtype
        check(stream == (bf16 if env_value == "bf16" else f32),
              f"3i: WAFER_EXC_STREAM={env_value} gave an (8, 1, 1) mesh {stream} streams")
        blocks = ops.put(geometry.work_area(x5, 1))
        st_blk = ops.put_store(geometry.work_area(store5[:1], 1))
        m_ms = cuda_ms(lambda: ops.evolve_chunk(blocks, None, None, st_blk), 1)
        out_m = ops.get(ops.evolve_chunk(blocks, None, None, st_blk))
        out_s = geometry.work_area(hs.evolve_chunk(x5, "ThreePoint", dt5, dn5, 1.0, su5, an5,
                                                   store=store5[:1].to(stream)), 1)
        torch.cuda.synchronize()
        dpsi = ((out_m - out_s).abs().max() / out_s.abs().max()).item()
        check(dpsi <= 1e-4, f"3i (8, 1, 1) {env_value}: the mesh chunk deviates by {dpsi:.3e}")
        nbytes, flops = exchange_bytes(mesh8, n5, 1), 0
        for shape, _origin in mesh8.blocks(n5):
            w = sweep_work(shape, 1, 1, reduce=True, stream_bytes=st_blk[0].element_size())
            nbytes, flops = nbytes + w[0], flops + w[1]
        k2 = finish_work(sum(ops._rows(b) for b in blocks), 2)
        b_ms = bound((nbytes + k2[0], flops + k2[1]))[0]
        chunk_rows.append({"chunk": f"512^3 mesh (8, 1, 1) excited S=1 {env_value} streams",
                           "kernel_ms_per_step": m_ms / su5, "bound_ms_per_step": b_ms,
                           "psi_rel_dev": dpsi})
        print(f"[3i] (8, 1, 1) 512^3 S=1 {env_value:4s} streams 100 steps: mesh "
              f"{m_ms / su5:.4f} ms/step (bound {b_ms:.4f}, share {100 * b_ms * su5 / m_ms:.1f} %); "
              f"against one device on the same streams {dpsi:.3e}")
        outs[env_value] = out_m
        del ops, blocks, st_blk, out_s
    rel = ((outs["bf16"] - outs["f32"]).abs().max() / outs["f32"].abs().max()).item()
    print(f"[3i] (8, 1, 1) 512^3 S=1: bf16 against f32 streams after 100 steps: max|dpsi| "
          f"{rel:.3e} of max|psi|")
    del outs, g5, x5, y5, store5

    # ---------------------------------------------------------------- 4i
    check(launches["sweep_step_bf16"] > 0,
          f"phase 4's excited state did not stream bf16: {launches}")
    with exc_stream("f32"):
        e_32, states_32, launches_32, plain_32, wall_32 = main_path(MAIN_PATH_CONFIG)
    check(launches_32["sweep_step_bf16"] == 0 and launches_32["sweep_step"] > 0
          and plain_32 == 0, f"4i WAFER_EXC_STREAM=f32 launched {launches_32}, plain {plain_32}")
    check(abs(energies[0] - e_32[0]) <= 1e-12 * abs(e_32[0]),
          f"4i: E0 {energies[0]} with bf16 streams, {e_32[0]} with f32")
    check(abs(energies[1] - e_32[1]) < 1e-5,
          f"4i: E1 {energies[1]} with bf16 streams, {e_32[1]} with f32 (tol 1e-5)")
    runs["4i real harmonic f32 streams"] = launches_32
    for (res, secs, n_points, _l, _sh), (res32, secs32, *_r), e, e32 in zip(
            states, states_32, energies, e_32):
        print(f"[4i] 256^3 state {res.wnum}: E = {e:.9f} with bf16 streams ({res.steps} steps, "
              f"chunks {res.chunk_seconds:.3f} s), {e32:.9f} with f32 ({res32.steps} steps, chunks "
              f"{res32.chunk_seconds:.3f} s): |dE| {abs(e - e32):.3e} (tol 1e-5)")
    low = states[0][0].phi[None]  # the converged E0, f32, as the measure holds it
    overlap = {}
    for stream in (bf16, f32):
        out = hs.evolve_chunk(states[1][0].phi, "ThreePoint", dt, dn, 1.0, 500, an3,
                              store=low.to(stream))
        overlap[stream] = solver._max_rel_overlap(out, low).item()
    check(overlap[bf16] <= max(10.0 * overlap[f32], 1e-6),
          f"4i: post-chunk overlap with the f32 store {overlap[bf16]:.3e} (bf16 streams) against "
          f"{overlap[f32]:.3e} (f32)")
    print(f"[4i] one 500-step chunk from the converged E1 with the converged E0 stored: "
          f"max|<l|psi>|/(|l||psi|) against the f32 store {overlap[bf16]:.3e} with bf16 streams, "
          f"{overlap[f32]:.3e} with f32")
    mg1 = "multigrid_512.yaml wavemax 1"
    with exc_stream("f32"):
        e_m32, _st, launches_m32, plain_m32, _w = main_path(
            mg_text.replace("wavemax: 0\n", "wavemax: 1\n"))
    check(runs[mg1]["sweep_step_bf16"] > 0 and launches_m32["sweep_step_bf16"] == 0
          and plain_m32 == 0, f"4i {mg1}: launches {runs[mg1]} and {launches_m32} (f32)")
    for e, tag in ((mg_runs[mg1][1], "bf16"), (e_m32[1], "f32")):
        check(abs(e - 2.5) < 1e-2, f"4i {mg1} {tag} streams: E1 = {e}")
    runs["4i multigrid wavemax 1 f32 streams"] = launches_m32
    print(f"[4i] {mg1}: E1 = {mg_runs[mg1][1]:.9f} with bf16 streams, {e_m32[1]:.9f} with f32 "
          f"(|dE| {abs(mg_runs[mg1][1] - e_m32[1]):.3e}; oracle 2.5 within 1e-2)")

    # ---------------------------------------------------------------- 4j
    graph_table = []
    for tag, sts in (("phase 4 256^3", states), ("4b complex harmonic 256^3", states_c),
                     ("4b complex_cornell.yaml", states_k),
                     *((f"4d {t}", s) for t, s in per_chunk_4d.items()),
                     *((f"4e {t}", s) for t, s in runs_4e.items())):
        graph_table += graph_rows(tag, sts)
    graph_table += graph_rows("4f traced 128^3", states_4f)
    for name in GRAPH_EXAMPLES:
        _e, sts, launches_j, plain_j, wall_j = main_path(example_text(name))
        check(plain_j == 0 and kernel_launches(launches_j) + launches_j["sweep_step_sc"] > 0,
              f"4j {name}: launches {launches_j}, plain {plain_j}")
        runs[f"4j {name}"] = launches_j
        graph_table += graph_rows(name, sts)
    share = split["python_between_launches_ms"] / split["wall_ms"]
    print(f"[4j] 4f's traced 128^3 run: the loop's wall {split['wall_ms']:.3f} ms, Python "
          f"between launches {split['python_between_launches_ms']:.3f} ms = {100 * share:.2f} %"
          f" of it")
    print(json.dumps({"chunk_graphs": graph_table, "trace_python_share": share}))

    # ---------------------------------------------------------------- 4k
    six = {}
    for tag in ("bf16", "f32"):
        with exc_stream(tag):
            six[tag] = main_path(SIX_STATE_CONFIG)
        e_k, sts, launched, plain_k, wall_k = six[tag]
        mine = ("sweep_step_bf16_many", "sweep_step_bf16_wide") if tag == "bf16" else (
            "sweep_step_many", "sweep_step_wide")
        other = ("sweep_step_many", "sweep_step_wide") if tag == "bf16" else (
            "sweep_step_bf16_many", "sweep_step_bf16_wide")
        check(plain_k == 0 and all(launched[k] > 0 for k in mine)
              and all(launched[k] == 0 for k in other) and launched["finish_coef"] > 0,
              f"4k {tag} streams: launches {launched}, plain sweep calls {plain_k}")
        for wnum, (e, oracle) in enumerate(zip(e_k, SIX_STATE_LEVELS)):
            check(abs(e - oracle) < 5e-3, f"4k {tag} streams: state {wnum}: E = {e}, "
                  f"oracle {oracle}")
        runs[f"4k six states {tag} streams"] = launched
        for (res, secs, _n, st_launched, _sh), e in zip(sts, e_k):
            print(f"[4k] {tag} streams, state {res.wnum} (S = {res.wnum}): E = {e:.9f}, "
                  f"{res.steps} steps, wall {secs:.2f} s, chunks {res.chunk_seconds:.3f} s; "
                  f"K1 launches: {st_launched['sweep_step'] + st_launched['sweep_step_bf16']} "
                  f"on the kernels of each count, {st_launched['sweep_step_many']} f32 and "
                  f"{st_launched['sweep_step_bf16_many']} bf16 on the many-state kernels, "
                  f"{st_launched['sweep_step_wide']} f32 and "
                  f"{st_launched['sweep_step_bf16_wide']} bf16 on the wide route; K2 "
                  f"{st_launched['finish_coef']}")
        print(f"[4k] cli.main 256^3 six states, {tag} streams: {wall_k:.2f} s wall; launches "
              f"{launched}; plain sweep calls {plain_k}")
    gaps = [abs(a - b) for a, b in zip(six["bf16"][0], six["f32"][0])]
    check(max(gaps) <= 1e-5, f"4k: bf16 against f32 streams |dE| {gaps} (tol 1e-5)")
    print(f"[4k] |E(bf16 streams) - E(f32)| per state: "
          f"{', '.join(f'{g:.3e}' for g in gaps)} (tol 1e-5); oracles "
          f"{', '.join(map(str, SIX_STATE_LEVELS))} within 5e-3")

    # ---------------------------------------------------------------- 4l
    e_l, sts_l, launches_l, plain_l, wall_l = main_path(
        COMPLEX_HARMONIC_CONFIG.replace("wavemax: 1", "wavemax: 3"))
    for wnum, e in enumerate(e_l):
        oracle = (COMPLEX_LEVELS[wnum] + 1.5) * cmath.sqrt(1 + 0.2j)
        check(abs(e.real - oracle.real) < 5e-3 and abs(e.imag - oracle.imag) < 5e-3,
              f"4l complex harmonic state {wnum}: E = {e}, oracle {oracle}")
    fourth = sts_l[3][3]
    check(len(e_l) == 4 and plain_l == 0 and fourth["sweep_step_sc_wide"] > 0
          and launches_l["sweep_step_sc_wide"] == fourth["sweep_step_sc_wide"]
          and launches_l["finish_coef"] > 0,
          f"4l: launches {launches_l} (fourth state {fourth}), plain sweep calls {plain_l}")
    runs["4l complex harmonic four states"] = launches_l
    for (res, secs, _n, st_launched, _sh), e in zip(sts_l, e_l):
        print(f"[4l] complex harmonic state {res.wnum} (S = {res.wnum}): E = {e.real:.6f} "
              f"{e.imag:+.6f}i, {res.steps} steps, wall {secs:.2f} s, chunks "
              f"{res.chunk_seconds:.3f} s; K3 launches: {st_launched['sweep_step_sc']} on the "
              f"kernels of each count, {st_launched['sweep_step_sc_wide']} on the wide route; K2 "
              f"{st_launched['finish_coef']}")
    print(f"[4l] cli.main 256^3 complex harmonic four states: {wall_l:.2f} s wall; launches "
          f"{launches_l}; plain sweep calls {plain_l}; oracles (n + 3/2)*sqrt(1 + 0.2i), n = "
          f"{', '.join(map(str, COMPLEX_LEVELS))} within 5e-3")

    total = {k: sum(r[k] for r in runs.values()) for k in launches}

    # ---------------------------------------------------------------- 5
    print(json.dumps({"chunks": chunk_rows}))
    source = "wafer_torch/csrc/stencil_sweep.cu"
    large = ("wafer_tpu/ops/pallas_stencil.py:1931 (B5), wafer_tpu/ops/pallas_stencil.py:3431 "
             "(B6), wafer_tpu/ops/pallas_stencil.py:4639 (B4)")
    k1_ms, k1_plain, (k1_bound, k1_by) = launch_5["ground analytic"]
    (k2,) = [t for t in k2_times if (t["rows"], t["n_red"]) == (n_blocks5, 2)]
    k2_bound, k2_by = bound(finish_work(n_blocks5, 2))
    sc_bound, sc_by = bound(sweep_work(n3, 1, pair=True))
    sharded = ("wafer_tpu/ops/pallas_stencil.py:1465, :1522, :1582 (B2 sharded, x_origin), "
               ":1931 (B5 sharded), :2911 (B12), :1334 (B13), :3779, :4152 (B14)")
    print(json.dumps({"kernels": [
        {"name": "sweep_step", "route": "cuda", "source": source,
         "replaces": "wafer_tpu/ops/pallas_stencil.py:167 (B2), "
                     "wafer_tpu/ops/pallas_stencil.py:2911 (B1, B3), " + large + ", " + sharded,
         "launches": total["sweep_step"], "max_abs_err": worst[0],
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None},
        {"name": "finish_coef", "route": "cuda", "source": "wafer_torch/csrc/finish_coef.cu",
         "replaces": "wafer_tpu/ops/pallas_stencil.py:2234 (B1, B3), " + large
                     + ", the psum of the sharded reductions (B12-B15)",
         "launches": total["finish_coef"], "max_abs_err": max(worst[3], worst_sc[3]),
         "ms": k2["k2_us"] / 1e3, "plain_ms": k2["plain_us"] / 1e3, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2["sum_us"] / 1e3},
        {"name": "sweep_step_bf16", "route": "cuda",
         "source": "wafer_torch/csrc/stencil_sweep_bf16.cu",
         "replaces": "wafer_tpu/ops/pallas_stencil.py:2911 (B3 with bf16 store_xpad, "
                     "wafer_tpu/solver.py:577-581), wafer_tpu/ops/pallas_stencil.py:1465 (B2 "
                     "sharded with bf16 stored-state windows, wafer_tpu/parallel/sharded.py:745-750)"
                     ", :2911 (B12 excited, sharded.py:1033-1035, :1073-1075)",
         "launches": total["sweep_step_bf16"], "max_abs_err": worst_i[0],
         "ms": launch_i[bf16][0], "plain_ms": launch_i[bf16][1], "bound_ms": launch_i[bf16][2][0],
         "bound_by": launch_i[bf16][2][1], "library_ms": None},
        *({"name": name, "route": "cuda", "source": "wafer_torch/csrc/stencil_sweep_many.cu",
           "replaces": "wafer_tpu/ops/pallas_stencil.py:2911 (B3 with n_lower 3 and 4, " + store
                       + " store_xpad; the large-grid and sharded dispatches of the same chunk, "
                       "B4 :4639, B12 :2911)",
           "launches": total[name], "max_abs_err": err, "ms": many_times[dtype, 3][0],
           "plain_ms": many_times[dtype, 3][1], "bound_ms": many_times[dtype, 3][2][0],
           "bound_by": many_times[dtype, 3][2][1], "library_ms": None}
          for name, store, dtype, err in (
              ("sweep_step_many", "f32", torch.float32, route_many["many"]),
              ("sweep_step_bf16_many", "bf16", torch.bfloat16, route_many_i["many"]))),
        *({"name": name, "route": "cuda", "source": "wafer_torch/csrc/stencil_sweep_wide.cu",
           "replaces": "wafer_tpu/ops/pallas_stencil.py:2911 (B3 with n_lower 5 or more, " + store
                       + " store_xpad; the large-grid and sharded dispatches of the same chunk, "
                       "B4 :4639, B12 :2911)",
           "launches": total[name], "max_abs_err": err, "ms": many_times[dtype, 5][0],
           "plain_ms": many_times[dtype, 5][1], "bound_ms": many_times[dtype, 5][2][0],
           "bound_by": many_times[dtype, 5][2][1], "library_ms": None}
          for name, store, dtype, err in (
              ("sweep_step_wide", "f32", torch.float32,
               max(route_many["wide"], worst_cap["K1 f32"][0])),
              ("sweep_step_bf16_wide", "bf16", torch.bfloat16,
               max(route_many_i["wide"], worst_cap["K1 bf16"][0])))),
        {"name": "sweep_step_sc_wide", "route": "cuda",
         "source": "wafer_torch/csrc/stencil_sweep_wide.cu",
         "replaces": "wafer_tpu/ops/pallas_split.py:473 (B8 with n_lower 3 or more; sharded, "
                     "x_origin), :1009 (B9, B12 pair), :1467 (B10), :1887 (B7), :2235 (B11), "
                     ":2723 (B15), at that count",
         "launches": total["sweep_step_sc_wide"], "max_abs_err": worst_pw[0],
         "ms": pair_times[3][0], "plain_ms": pair_times[3][1], "bound_ms": pair_times[3][2][0],
         "bound_by": pair_times[3][2][1], "library_ms": None},
        {"name": "sweep_step_sc", "route": "cuda", "source": "wafer_torch/csrc/split_sweep.cu",
         "replaces": "wafer_tpu/ops/pallas_split.py:473 (B8; sharded, x_origin), :1009 (B9, B12 "
                     "pair), :1467 (B10), :1887 (B7), :2235 (B11), :2723 (B15)",
         "launches": total["sweep_step_sc"], "max_abs_err": worst_sc[0],
         "ms": sc_times["ground analytic"][0], "plain_ms": sc_times["ground analytic"][1],
         "bound_ms": sc_bound, "bound_by": sc_by, "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# 256³ f32 Harmonic, the 9.6-wide box of examples/harmonic_excited.yaml
MAIN_PATH_CONFIG = """\
project_name: smoke harmonic 256
grid:
  size: {x: 256, y: 256, z: 256}
  dn: 0.0375
  dt: 0.0004
tolerance: 1.0e-5
central_difference: ThreePoint
max_steps: 200000
wavenum: 0
wavemax: 1
output:
  screen_update: 500
  snap_update: null
  file_type: Json
  save_wavefns: false
  save_potential: false
potential: Harmonic
mass: 1.0
init_condition: Constant
sig: 1.0
init_symmetry: NotConstrained
precision: f32
seed: 7
"""


# 4k: MAIN_PATH_CONFIG's box with six states (wavemax 5: three stored
# states for the fourth, four for the fifth, K1's many-state kernels; five
# for the sixth, its wide route) from a seeded Gaussian, which holds weight
# in every level, as examples/harmonic_excited.yaml starts; the
# oscillator's levels 1.5, the 2P triplet at 2.5 and two states of the 3.5
# shell
SIX_STATE_CONFIG = (MAIN_PATH_CONFIG.replace("smoke harmonic 256", "smoke harmonic 256 six")
                    .replace("wavemax: 1", "wavemax: 5")
                    .replace("init_condition: Constant", "init_condition: Gaussian"))
SIX_STATE_LEVELS = (1.5, 2.5, 2.5, 2.5, 3.5, 3.5)
# 4l: the oscillator's n of each of COMPLEX_HARMONIC_CONFIG's first four
# states (wavemax 3; three stored pairs for the fourth, K3's wide route)
COMPLEX_LEVELS = (0, 1, 1, 1)


# 256³ f32 ComplexHarmonic (absorb 0.2) in a 16-wide box (dn 0.0625); dt
# 1.2e-3 is 92 % of the ThreePoint bound dn²·m/3
COMPLEX_HARMONIC_CONFIG = """\
project_name: smoke complex harmonic 256
grid:
  size: {x: 256, y: 256, z: 256}
  dn: 0.0625
  dt: 0.0012
tolerance: 1.0e-5
central_difference: ThreePoint
max_steps: 200000
wavenum: 0
wavemax: 1
output:
  screen_update: 500
  snap_update: null
  file_type: Json
  save_wavefns: false
  save_potential: false
potential: ComplexHarmonic
absorb: 0.2
mass: 1.0
init_condition: Constant
sig: 1.0
init_symmetry: NotConstrained
precision: f32
seed: 7
"""


if __name__ == "__main__":
    sys.exit(main())

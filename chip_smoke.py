#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure raises and the script exits non-zero):

1. Card, versions, and the build of ``wafer_torch/csrc`` with nvcc.
2. Each CUDA kernel against its plain torch version on the card: orders
   3/5/7 × analytic B for the five potential kinds and streamed B × 0, 1
   or 2 stored states × identity and non-identity coefficients, on a
   64×64×128 grid, plus one 256³ case. Tolerances (f32 reordering):
   ψ' ≤ 1e-6·max|ψ'|; ‖ψ'‖² ≤ 1e-5 relative; ⟨l|ψ'⟩ ≤ 1e-5 of ‖l‖·‖ψ'‖.
   Then the grids that do not fill the sweep's 16 × 32 tiles (RAGGED: odd
   extents, one smaller than a tile, one with fewer x-planes than a
   segment) × the orders × the kinds × S = 0..3 (3: the count read at run
   time), and two launches on the same input, which must agree bit for bit.
3. 500-step ground, per-step-norm and excited (S = 1) chunks at 256³
   through the kernels and through the plain torch ops, timed with CUDA
   events; ψ ≤ 1e-4·max|ψ| and ‖ψ‖² ≤ 1e-4 relative after 500 steps.
2e. K2 (``csrc/finish_coef.cu``) against its plain version on partial rows
    FINISH_ROWS × columns FINISH_NRED (reductions and coefficients within
    1e-5 relative), two launches on the same partials bit for bit, and
    1,000 launches in a row against a fresh launch (the ticket resets). Then device times with the device held (``held_times``: K2 is
    shorter than its host enqueue, so ``cuda_ms`` would time the host): K2,
    K2 as one block, the column-pass design it replaced,
    ``partials.sum(dim=0)`` and an empty ctypes launch, at 512³'s 16,384
    rows (n_red 1-3), 256³'s 2,048 (n_red 1, 2) and 100,003; and the host µs a call of
    the chunk's bound launcher and of ``finish_coef``.
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

    python3 chip_smoke.py --example examples/sharded_512.yaml --mesh 8,1,1

runs one example through the sharded main path alone (after phase 1) and
prints its states.

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
import json
import math
import os
import subprocess
import sys
import tempfile
import time


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


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


# NVIDIA H100 SXM data sheet: HBM bytes/s and f32 FLOP/s outside the
# tensor cores (at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def largest_error(errs):
    """The largest error, or inf if any is NaN (max() can step over one)."""
    errs = list(errs)
    return math.inf if any(math.isnan(e) for e in errs) else max(errs)


def bound(work):
    """(bound_ms, bound_by) of ``work`` = (bytes, flops): the larger of the
    bytes over the HBM rate and the operations over the f32 peak."""
    t_bytes = work[0] / HBM_BYTES_PER_S * 1e3
    t_ops = work[1] / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_work(n, ext, n_store=0, streamed=False, reduce=False, pair=False):
    """(bytes, flops) of the least work one K1 (``pair``: K3) sweep of an n
    interior does, whatever implements it: ψ read and ψ' written once over
    the padded volume, B read once where streamed, each stored state read
    once over the padded volume (its halo feeds the corrected taps); per
    interior point the stencil, B from coordinates where analytic and the
    update, and where the sweep reduces the correction once per padded
    point and the reductions once per interior point. No scratch: the
    partial rows belong to the launch shape, and K2's bound counts them."""
    comps = 2 if pair else 1
    padded = math.prod(d + 2 * ext for d in n)
    interior = math.prod(n)
    nbytes = 4 * comps * padded * (2 + n_store) + 4 * comps * interior * streamed
    flops = (comps * (1 + 9 * ext + 5) + (0 if streamed else 14 * comps)) * interior
    if reduce:
        correction = comps + (8 if pair else 2) * n_store
        sums = (4 + 8 * n_store) if pair else 2 * (1 + n_store)
        flops += correction * padded + sums * interior
    return nbytes, flops


def finish_work(n_rows, n_red):
    """(bytes, flops) of one K2 launch: the partial rows read once, the sums
    and coefficients written."""
    return 8 * n_rows * n_red + 12 * n_red, n_rows * n_red


def step_bound_ms(n, n_store=0, streamed=False, reduce=False, pair=False, rows=0):
    """Bound of one chunk step at ThreePoint: its sweep's least work and,
    where the step reduces, K2 over the ``rows`` partial rows the sweep's
    launch wrote (``num_partials``)."""
    nbytes, flops = sweep_work(n, 1, n_store, streamed, reduce, pair)
    if reduce:
        k2 = finish_work(rows, (1 + 2 * n_store) if pair else (1 + n_store))
        nbytes, flops = nbytes + k2[0], flops + k2[1]
    return bound((nbytes, flops))[0]


def padded_noise(shape, ext, gen, dev):
    import torch
    import torch.nn.functional as F

    return F.pad(torch.randn(shape, generator=gen, device=dev), (ext,) * 6)


def analytic_for(kind, n):
    """(kind, dn, dt, mass, nx, ny, nz, sig, vshift) with sensible physics."""
    if kind == "SimpleCornell":
        return (kind, 0.35, 0.004, 4.65, *n, 0.223, 18.0)
    return (kind, 0.2, 0.004, 1.0, *n, 1.0, 0.0)


def kernel_vs_plain(order, kind, n_store, identity, n, gen, dev):
    """One K1 + K2 case on the card against the plain versions.
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
# registers) and 3 (read at run time)
RAGGED_MODES = ((0, False), (0, True), (1, True), (2, True), (3, True))


def ragged_vs_plain(order, kind, n_store, apply, pair, n, with_origin, gen, dev):
    """K1 (``pair``: K3) on a padded block of interior extents ``n`` against
    its plain version, with noise in the halo too, as a shard block's halo
    holds its neighbours' faces. ``with_origin`` puts the block at (3, 5, 2)
    of a global grid 7 larger on each axis, whose B the sweep reads there.
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


def ragged_cases(pair, kinds, with_origin, gen, dev):
    """Every order × kind × RAGGED_MODES × RAGGED grid; returns (cases, worst
    ψ' rel err, worst reduction rel err), failing on the first that misses
    1e-6 of max|ψ'| or 1e-5 on the reductions."""
    worst, n_cases = [0.0, 0.0], 0
    for order in ("ThreePoint", "FivePoint", "SevenPoint"):
        for kind in kinds:
            for n_store, apply in RAGGED_MODES:
                for n in RAGGED:
                    errs = ragged_vs_plain(order, kind, n_store, apply, pair, n, with_origin,
                                           gen, dev)
                    check(errs[0] <= 1e-6 and errs[1] <= 1e-5,
                          f"{'K3' if pair else 'K1'} ragged {n} {order} {kind} S={n_store} "
                          f"apply={apply} origin={with_origin}: {errs}")
                    worst = [max(a, b) for a, b in zip(worst, errs)]
                    n_cases += 1
    return n_cases, worst[0], worst[1]


def repeat_is_identical(pair, n_store, n, gen, dev):
    """Two launches of K1 (``pair``: K3) on the same input, Coulomb B, with
    S stored states and the coefficients: ψ' and the partial rows bit for
    bit."""
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
    for _ in range(2):
        out = torch.empty_like(psi)
        part = torch.empty(rows(psi, "ThreePoint"), n_red, dtype=torch.float64, device=dev)
        kernel(psi, out, coef, part, order="ThreePoint", scale=0.05, analytic=analytic,
               store=store, apply_coef=True)
        outs.append((out, part))
    torch.cuda.synchronize()
    return torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


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
    of K2 as one block (G = 1), of the column-pass design it replaced and of
    ``partials.sum(dim=0)`` on the same partials; the host µs a call of the
    chunk's bound launcher and of ``finish_coef`` (the checks every call);
    the plain version's device µs; and G."""
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
    one = held_times(lambda: lib.wafer_finish_coef(*ptrs, launch.scratch.data_ptr(), 1,
                                                   dev.index, stream), n)
    columns = held_times(lambda: lib.wafer_finish_coef_columns(*ptrs, dev.index, stream), n)
    library = held_times(lambda: part.sum(dim=0), n)
    wrapper = held_times(lambda: hs.finish_coef(part, red, coef), n)
    plain = held_times(lambda: hs.finish_coef_plain(part, red, coef), 40)
    return {"rows": rows, "n_red": n_red, "groups": hs.finish_groups(rows, n_red),
            "k2_us": k2[0], "one_block_us": one[0], "columns_us": columns[0],
            "sum_us": library[0], "plain_us": plain[0], "host_launcher_us": k2[1],
            "host_finish_coef_us": wrapper[1],
            "bound_us": bound(finish_work(rows, n_red))[0] * 1e3}


def noop_us(dev, n=100):
    """Device µs of an empty kernel launched through ctypes as K2 is."""
    import torch

    from wafer_torch.ops import _build

    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    return held_times(lambda: lib.wafer_noop(dev.index, stream), n)


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


def main_path(config_text, mesh_shape=None):
    """Run ``wafer_torch.cli.main`` on ``config_text`` in a temporary
    directory, or with ``mesh_shape`` ``solver.run(config, mesh=...)`` with
    every shard on the card (the CLI puts one shard on each card). Returns
    (energies E/‖ψ‖² of the final level, complex for a complex potential,
    [(SolveResult, wall seconds, grid points, launches, sharded)] for each
    solve, every multigrid level's included, kernel launches, plain-sweep
    calls, wall seconds); launches and plain calls are counted from just
    before the run. Each state's observables file must hold Re E."""
    import logging

    import torch
    import yaml

    from wafer_torch import cli, solver
    from wafer_torch.config import Config
    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs, split_complex, stencil
    from wafer_torch.parallel import make_mesh, solver_sharded

    plain_calls = [0]

    def counted(fn):
        def wrapper(*args, **kwargs):
            plain_calls[0] += 1
            return fn(*args, **kwargs)
        return wrapper

    states = []
    orig_solve, orig_sharded = solver.solve, solver_sharded._solve_state

    def timed(fn, sharded):
        def run(config, *args, **kwargs):
            before = dict(hs.LAUNCHES)
            t = time.perf_counter()
            res = fn(config, *args, **kwargs)  # ends on a host read of its scalars
            secs = time.perf_counter() - t
            launched = {k: hs.LAUNCHES[k] - before[k] for k in before}
            states.append((res, secs, math.prod(config.grid.size.as_tuple()), launched, sharded))
            return res
        return run

    patched = [(m, n, getattr(m, n)) for m, n in
               ((stencil, "evolve_step"), (hs, "sweep_step_plain"), (hs, "finish_coef_plain"),
                (split_complex, "evolve_step_sc"), (hsp, "sweep_step_sc_plain"))]
    n_states = yaml.safe_load(config_text)["wavemax"] + 1
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="wafer_torch_smoke_") as tmp:
        os.chdir(tmp)
        try:
            with open("smoke.yaml", "w") as fh:
                fh.write(config_text)
            for mod, name, fn in patched:
                setattr(mod, name, counted(fn))
            solver.solve = timed(orig_solve, False)
            solver_sharded._solve_state = timed(orig_sharded, True)
            mesh = None
            if mesh_shape is not None:
                mesh = make_mesh(mesh_shape, [torch.device("cuda", 0)] * math.prod(mesh_shape))
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
            solver.solve, solver_sharded._solve_state = orig_solve, orig_sharded
            for mod, name, fn in patched:
                setattr(mod, name, fn)
            os.chdir(cwd)
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
    return energies, states, launches, plain_calls[0], wall


def smoke_config(n, potential, dn, dt, su, **extra):
    """A port ``Config`` for the chunk phases: f32 ThreePoint on an n grid."""
    from wafer_torch.config import Config

    return Config.from_dict({
        "project_name": "smoke chunk", "grid": {"size": dict(zip("xyz", n)), "dn": dn, "dt": dt},
        "tolerance": 1e-5, "central_difference": "ThreePoint", "max_steps": 1000,
        "wavenum": 0, "wavemax": 0,
        "output": {"screen_update": su, "snap_update": None, "file_type": "Json",
                   "save_wavefns": False, "save_potential": False},
        "potential": potential, "mass": 1.0, "init_condition": "Constant", "sig": 1.0,
        "init_symmetry": "NotConstrained", "precision": "f32", **extra,
    })


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
    from wafer_torch.parallel.halo import halo_copies, run_copies

    plan = halo_copies(blocks, 1, mesh, zero_edges=False)  # made once, as a chunk does

    def sharded():
        run_copies(plan)
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


def run_example(argv):
    """``--example PATH [--mesh X,Y,Z] [--no-save]``: one example through
    the sharded main path (every shard on the card), its states printed;
    ``--no-save`` turns ``save_wavefns`` off."""
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--example", required=True)
    ap.add_argument("--mesh", default="8,1,1")
    ap.add_argument("--no-save", action="store_true")
    args = ap.parse_args(argv)
    with open(args.example) as fh:
        text = fh.read()
    if args.no_save:
        check("save_wavefns: true" in text, f"{args.example} does not save its wavefunction")
        text = text.replace("save_wavefns: true", "save_wavefns: false")
    shape = tuple(int(x) for x in args.mesh.split(","))
    energies, states, launches, plain, wall = main_path(text, shape)
    check(plain == 0, f"the plain sweep ran {plain} times")
    for res, secs, n_points, launched, sharded in states:
        e = res.observables.energy / res.observables.norm2
        print(f"[example] {args.example} {'mesh ' + args.mesh if sharded else 'one device'} "
              f"{round(n_points ** (1 / 3))}^3 state {res.wnum}: E = {e}, {res.steps} steps, "
              f"wall {secs:.2f} s, chunks {res.chunk_seconds:.2f} s = "
              f"{n_points * res.steps / res.chunk_seconds:.4g} grid-point updates/s; "
              f"launches {launched}")
    print(f"[example] {args.example}: {wall:.2f} s wall; launches {launches}")


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
    for line in _build.build().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("    " + line.strip())
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
    floor_us, floor_host_us = noop_us(dev)
    k2_times = [finish_times(rows, n_red, gen, dev)
                for rows, n_red in ((16384, 1), (16384, 2), (16384, 3), (2048, 1), (2048, 2),
                                    (100003, 3))]
    print(f"[2e] device us per launch, device held while the host enqueues 100 (torch.cuda._sleep): "
          f"empty ctypes launch {floor_us:.3f} (host {floor_host_us:.3f} us a call)")
    for t in k2_times:
        print(f"     {t['rows']} rows x {t['n_red']}: finish_coef {t['k2_us']:.3f} us "
              f"({t['groups']} blocks), one block {t['one_block_us']:.3f}, column passes "
              f"{t['columns_us']:.3f}, partials.sum(dim=0) {t['sum_us']:.3f}, plain "
              f"{t['plain_us']:.3f}, bound {t['bound_us']:.4f}; host us a call: chunk launcher "
              f"{t['host_launcher_us']:.3f}, finish_coef {t['host_finish_coef_us']:.3f}")
    print(json.dumps({"finish_coef_times": k2_times, "empty_launch_us": floor_us,
                      "empty_launch_host_us": floor_host_us}))

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
    from wafer_torch.parallel.halo import halo_copies, run_copies
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
                                       None if streamed else an5, per_step_norm=psn, store=st,
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
            ex_ms = cuda_ms(lambda: run_copies(plan), 50)
            n_store = 0 if st is None else 1
            reduce = psn or n_store > 0
            # one launch on shard 0's block, with its origin, as the chunk launches it
            (shape0, origin0), out0 = mesh.blocks(n5)[0], torch.empty_like(blocks[0])
            n_red = ops._n_red(n_store)
            coef0 = torch.tensor([0.9] + [0.05] * (n_red - 1), device=dev)
            part0 = (torch.empty(ops._rows(blocks[0]), n_red, dtype=torch.float64, device=dev)
                     if reduce else None)
            blk_ms = cuda_ms(lambda: ops._sweep(blocks[0], out0, coef0, part0,
                                                None if b_blk is None else b_blk[0],
                                                None if st_blk is None else st_blk[0],
                                                origin0, reduce), 50)
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
    del a5, b5, b5_int, g5, x5, y5, out5, store5, c5

    # ---------------------------------------------------------------- 4c
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "multigrid_512.yaml")) as fh:
        mg_text = fh.read()
    check("wavemax: 0\n" in mg_text, "examples/multigrid_512.yaml no longer says wavemax: 0")
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
            check(launched["sweep_step"] > 0,
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
            check(launched[sweep] > 0, f"{tag}: {sweep} did not launch in state {res.wnum}")
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
        {"name": "sweep_step_sc", "route": "cuda", "source": "wafer_torch/csrc/split_sweep.cu",
         "replaces": "wafer_tpu/ops/pallas_split.py:179 (B8), wafer_tpu/ops/pallas_split.py:473 "
                     "(B8 sharded, x_origin), :1009 (B9, B12 pair), :2723 (B15)",
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

#!/usr/bin/env python3
"""Hold this tree's K1/K3 launches, and a mesh chunk, bit for bit against
another checkout's on one CUDA card, and time the 256³ sweeps of both.

    python3 tools/compare_launches.py --other OTHER_ROOT [--pairs N] [--sass]
        [--solves] [--walls] [--no-launches]

Each tree runs in a process of its own (this file is copied into the
other tree's ``tools/``) and launches, through the wrappers' arguments
that both trees take, the same seeded cases: K1 and K3 on ``chip_smoke``'s
ragged grids and at 256³, orders 3/5/7, S = 0..3 with the coefficients
and S = 0 without, with and without a block origin (at 256³: ThreePoint,
S = 0 and 1, no origin), K1's launches with S >= 1 again on the same
stored states in bf16, all with Coulomb's B; every other source of B
(K1: NoPotential, Harmonic, SimpleCornell, Periodic, streamed; K3:
Harmonic, streamed) at orders 3/7, S = 0 and 1, on 37×45×29 and
64×64×128, with and without an origin; and 20-step 128³ chunks of
``ShardedOps`` on a (4, 2, 1) mesh (ground, per-step-norm, S = 1). It
writes a SHA-256 of the bytes of every output and partial row, and this
process compares the two trees' digests. Then the per-launch time of K1 and K3 at 256³ and of K1
at 512³, ground and S = 1 with reductions (CUDA events; N pairs of
processes in turns, 3 by default), and for the 256³ K1 ground launch the
device's time with the device held and the host's time a call
(``chip_smoke.held_times``), and K1 with bf16 and with f32 stored states
at ``chip_smoke`` 3i's shapes (``time_streams``), and the chunks of
PERF.md's per-step table (``time_chunks``: 256³ real and complex, 512³,
the (8, 1, 1) and (4, 2, 1) meshes and 2 × (2, 2, 1) multi-slice Coulomb,
with f32 stored-state streams).
``--solves`` adds whole solves to the digests (:func:`solve_cases`: each
state's steps, observables, launches and ψ), ``--walls`` times chip_smoke
4j's per-chunk runs in both trees, N pairs of processes in turns (each
state's wall and chunk seconds, the graph counters where the tree has
them, and a traced 128³ run's share of Python between launches; medians
and spreads), and ``--no-launches`` skips the launch times.
Every case is held bit for bit but those :func:`b_changed` names, K1
with Coulomb or SimpleCornell B and the solves of those potentials, whose
B the two trees may compute apart (one rsqrt and one reciprocal against an
IEEE sqrt and two divides): their ψ′ within 1e-6 of max|ψ′|, their
reductions within 1e-5 and their energies within 1e-6 relative, a solve's
steps within one ``screen_update`` chunk (:func:`changed_close`).
``--costly-b`` does only this: K1 against its plain version on
``chip_smoke``'s costly-B cases (:func:`costly_errors`; this tree's
chip_smoke in both trees, so both launch the same seeded inputs), each
tree's worst ψ′ and reduction errors beside the gates 1e-6 and 1e-5.
``--sass`` also holds the machine code of every K1 (f32 and bf16), K3
and K2 kernel of the other tree (``cuobjdump -sass``, read by
:func:`parse_sass`) against this tree's kernel for the same arguments,
the one without the plane checks (template argument ``false``), with the
parameter offsets masked, and counts the kernels of each family that are
identical. Prints one JSON line.
"""

import argparse
import difflib
import hashlib
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def dump(path, solves=False):
    """Run the cases in this tree and write their outputs' digests to
    ``path`` (JSON); with ``solves`` also :func:`solve_digests`."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from wafer_torch import geometry
    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs
    from wafer_torch.parallel import make_mesh
    from wafer_torch.parallel.sharded import ShardedOps

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2027)
    outs = {}
    kept = Path(path + ".t")  # the outputs of the cases b_changed names
    kept.mkdir(exist_ok=True)

    def put(key, t):
        digest = hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()
        outs[key] = digest
        if b_changed(key):
            name = f"{len(list(kept.iterdir()))}.pt"
            torch.save(t.detach().cpu(), kept / name)
            outs[key] = {"digest": digest, "file": str(kept / name)}

    for pair in (False, True):
        kernel, rows = (hsp.sweep_step_sc, hsp.num_partials) if pair else (hs.sweep_step,
                                                                         hs.num_partials)
        lead = (2,) if pair else ()
        for order in ("ThreePoint", "FivePoint", "SevenPoint"):
            ext = geometry.EXT[order]
            for n in cs.RAGGED + ((256, 256, 256),):
                for n_store, apply in ((0, False), (0, True), (1, True), (2, True), (3, True)):
                    for origin in ((0, 0, 0), (3, 5, 2)):
                        if n[0] == 256 and (order != "ThreePoint" or n_store > 1 or any(origin)
                                            or (n_store, apply) == (0, True)):
                            continue
                        glob = tuple(d + 7 for d in n) if any(origin) else n
                        psi = F.pad(torch.randn((*lead, *n), generator=gen, device=dev),
                                    (ext,) * 6)
                        store = None
                        if n_store:
                            store = F.pad(torch.randn((n_store, *lead, *n), generator=gen,
                                                      device=dev), (ext,) * 6)
                            store = store / torch.sqrt((store * store).sum())
                        n_red = 1 + (2 if pair else 1) * n_store
                        coef = torch.tensor([0.9] + [0.05] * (n_red - 1), device=dev)
                        analytic = ("Coulomb", 0.2, 0.004, 1.0, *glob, 1.0, 0.0) + (
                            (0.2,) if pair else ())
                        out = torch.empty_like(psi)
                        part = (torch.empty(rows(psi, order), n_red, dtype=torch.float64,
                                            device=dev) if apply else None)
                        kernel(psi, out, coef, part, order=order, scale=0.05, analytic=analytic,
                               store=store, apply_coef=apply, origin=origin)
                        key = (f"{'K3' if pair else 'K1'} Coulomb {order} {n} S={n_store} "
                               f"{apply} {origin}")
                        put(key, out)
                        if part is not None:
                            put(key + " partials", part)
                        if n_store and apply and not pair:  # the same launch on a bf16 store
                            kernel(psi, out, coef, part, order=order, scale=0.05,
                                   analytic=analytic, store=store.to(torch.bfloat16),
                                   apply_coef=apply, origin=origin)
                            put(key + " bf16", out)
                            put(key + " bf16 partials", part)
    # every other source of B (the cases above take Coulomb's): each analytic
    # kind and B streamed, S = 0 and 1 with the coefficients and reductions,
    # without and with an origin
    for pair in (False, True):
        kernel, rows = (hsp.sweep_step_sc, hsp.num_partials) if pair else (hs.sweep_step,
                                                                         hs.num_partials)
        lead = (2,) if pair else ()
        kinds = ("Harmonic", "streamed") if pair else ("NoPotential", "Harmonic", "SimpleCornell",
                                                       "Periodic", "streamed")
        for kind, order, n, n_store, origin in itertools.product(
                kinds, ("ThreePoint", "SevenPoint"), ((37, 45, 29), (64, 64, 128)), (0, 1),
                ((0, 0, 0), (3, 5, 2))):
            ext = geometry.EXT[order]
            glob = tuple(d + 7 for d in n) if any(origin) else n
            psi = F.pad(torch.randn((*lead, *n), generator=gen, device=dev), (ext,) * 6)
            store = None
            if n_store:
                store = F.pad(torch.randn((n_store, *lead, *n), generator=gen, device=dev),
                              (ext,) * 6)
                store = store / torch.sqrt((store * store).sum())
            n_red = 1 + (2 if pair else 1) * n_store
            coef = torch.tensor([0.9] + [0.05] * (n_red - 1), device=dev)
            b = 1.0 / (1.0 + 0.002 * torch.rand((*lead, *n), generator=gen, device=dev))
            source = {"b2" if pair else "b_int": b}
            if kind != "streamed":
                source = dict(analytic=cs.analytic_for(kind, glob) + ((0.2,) if pair else ()))
            out = torch.empty_like(psi)
            part = torch.empty(rows(psi, order), n_red, dtype=torch.float64, device=dev)
            kernel(psi, out, coef, part, order=order, scale=0.05, store=store, apply_coef=True,
                   origin=origin, **source)
            key = f"{'K3' if pair else 'K1'} {kind} {order} {n} S={n_store} {origin}"
            put(key, out)
            put(key + " partials", part)
    cfg = cs.smoke_config((128,) * 3, "Harmonic", 0.075, 0.0016, 20)
    ground = cs.harmonic_state(128, 0.075, gen, dev)
    odd = cs.harmonic_state(128, 0.075, gen, dev, odd=True)
    for name, phi, psn, st in (("ground", ground, False, None), ("psn", ground, True, None),
                               ("S=1", odd, False, ground[None])):
        ops = ShardedOps(cfg, make_mesh((4, 2, 1), [dev] * 8), 0 if st is None else 1)
        chunk = ops.evolve_chunk_psn if psn else ops.evolve_chunk
        blocks = ops.put(geometry.work_area(phi, 1))
        stored = None if st is None else ops.put_store(geometry.work_area(st, 1))
        put(f"mesh chunk {name}", ops.get(chunk(blocks, None, None, stored)))
    if solves:
        outs.update(solve_digests())
    with open(path, "w") as fh:
        json.dump(outs, fh)


def time_sweeps():
    """ms per launch of K1 and K3 at 256³ (Harmonic; ground, and S = 1 with
    the coefficients and reductions) and of K1 at 512³ (ground, S = 1)."""
    import torch

    import chip_smoke as cs
    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    times = {}
    for n, reps in ((256, 200), (512, 30)):
        psi = cs.harmonic_state(n, 0.0375, gen, dev)
        store = psi[None].clone()
        out = torch.empty_like(psi)
        an = ("Harmonic", 0.0375, 4e-4, 1.0, n, n, n, 1.0, 0.0)
        coef = torch.tensor([0.9, 0.05], device=dev)
        part = torch.empty(hs.num_partials(psi, "ThreePoint"), 2, dtype=torch.float64, device=dev)
        kw = dict(order="ThreePoint", scale=0.14, analytic=an)
        times[f"k1_{n}_ms"] = cs.cuda_ms(lambda: hs.sweep_step(psi, out, coef[:1], None, **kw),
                                         reps)
        if n == 256:  # the device alone, held while the host enqueues; and the host a call
            times["k1_256_held_us"], times["k1_256_host_us"] = cs.held_times(
                lambda: hs.sweep_step(psi, out, coef[:1], None, **kw), 50)
        times[f"k1_s1_{n}_ms"] = cs.cuda_ms(
            lambda: hs.sweep_step(psi, out, coef, part, store=store, apply_coef=True, **kw), reps)
        if n == 256:
            pair = torch.stack([psi, 0.1 * psi])
            out_c, store_c = torch.empty_like(pair), pair[None].clone()
            coef_c = torch.tensor([0.9, 0.05, -0.02], device=dev)
            part_c = torch.empty(hsp.num_partials(pair, "ThreePoint"), 3, dtype=torch.float64,
                                 device=dev)
            kw_c = dict(order="ThreePoint", scale=0.14, analytic=an + (0.2,))
            times["k3_256_ms"] = cs.cuda_ms(
                lambda: hsp.sweep_step_sc(pair, out_c, coef_c[:1], None, **kw_c), reps)
            times["k3_s1_256_ms"] = cs.cuda_ms(
                lambda: hsp.sweep_step_sc(pair, out_c, coef_c, part_c, store=store_c,
                                          apply_coef=True, **kw_c), reps)
        del psi, store, out, part
    return times


def time_streams():
    """ms of K1 with bf16 and with f32 stored states at chip_smoke 3i's
    shapes (Harmonic, ThreePoint): per launch at 256³ S = 1, and per step of
    a 500-step 256³ S = 1 chunk, 100-step 512³ S = 1 and S = 2 chunks and
    the 100-step 512³ S = 1 chunk of an (8, 1, 1) mesh on the card."""
    import torch

    import chip_smoke as cs
    from wafer_torch import geometry
    from wafer_torch.ops import hopper_stencil as hs
    from wafer_torch.parallel import make_mesh
    from wafer_torch.parallel.sharded import ShardedOps

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    streams = (("bf16", torch.bfloat16), ("f32", torch.float32))
    times = {}
    dn, dt = 0.0375, 4e-4
    an = ("Harmonic", dn, dt, 1.0, 256, 256, 256, 1.0, 0.0)
    low, phi = cs.harmonic_state(256, dn, gen, dev), cs.harmonic_state(256, dn, gen, dev, odd=True)
    out = torch.empty_like(phi)
    coef = torch.tensor([0.9, 0.05], device=dev)
    part = torch.empty(hs.num_partials(phi, "ThreePoint"), 2, dtype=torch.float64, device=dev)
    kw = dict(order="ThreePoint", scale=dt / (2.0 * dn * dn), analytic=an, apply_coef=True)
    for name, dtype in streams:
        st = low[None].to(dtype)
        times[f"k1_{name}_s1_256_ms"] = cs.cuda_ms(
            lambda: hs.sweep_step(phi, out, coef, part, store=st, **kw), 200)
        times[f"chunk_{name}_s1_256_ms_step"] = cs.cuda_ms(
            lambda: hs.evolve_chunk(phi, "ThreePoint", dt, dn, 1.0, 500, an, store=st), 3) / 500
    del low, phi, out, part
    dn, dt = 0.03, 2.8e-4
    an = ("Harmonic", dn, dt, 1.0, 512, 512, 512, 1.0, 0.0)
    g5 = cs.harmonic_state(512, dn, gen, dev)
    x5 = cs.harmonic_state(512, dn, gen, dev, odd=True, axis=0)
    y5 = cs.harmonic_state(512, dn, gen, dev, odd=True, axis=1)
    store = torch.stack([g5, x5])
    for s, phi in ((1, x5), (2, y5)):  # each shape with both streams in turn
        for name, dtype in streams:
            st = store[:s].to(dtype)
            times[f"chunk_{name}_s{s}_512_ms_step"] = cs.cuda_ms(
                lambda: hs.evolve_chunk(phi, "ThreePoint", dt, dn, 1.0, 100, an, store=st), 3) / 100
            del st
    cfg = cs.smoke_config((512,) * 3, "Harmonic", dn, dt, 100)
    mesh = make_mesh((8, 1, 1), [dev] * 8)
    old = os.environ.get("WAFER_EXC_STREAM")
    for name, _dtype in streams:
        os.environ["WAFER_EXC_STREAM"] = name
        ops = ShardedOps(cfg, mesh, 1)
        blocks = ops.put(geometry.work_area(x5, 1))
        st = ops.put_store(geometry.work_area(store[:1], 1))
        times[f"mesh_{name}_s1_512_ms_step"] = cs.cuda_ms(
            lambda: ops.evolve_chunk(blocks, None, None, st), 3) / 100
        del ops, blocks, st
    if old is None:
        os.environ.pop("WAFER_EXC_STREAM")
    else:
        os.environ["WAFER_EXC_STREAM"] = old
    return times


def time_chunks():
    """ms per step of the chunks of PERF.md's per-step table (chip_smoke
    phases 3-3e, kernels only, f32 stored-state streams): 500-step 256³
    real (ground, per-step-norm, S = 1) and complex (ground, streamed,
    per-step-norm, S = 1) chunks; 100-step 512³ chunks (ground analytic
    and streamed, per-step-norm, S = 1, S = 2); the five 100-step 512³
    chunks of (8, 1, 1) and (4, 2, 1) meshes on the card (ground analytic
    and streamed, per-step-norm, S = 1, complex ground); and the Coulomb
    chunks of a 2 × (2, 2, 1) multi-slice mesh (ground, per-step-norm,
    S = 1)."""
    import math

    import torch

    import chip_smoke as cs
    from wafer_torch import geometry
    from wafer_torch.models import potentials
    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs
    from wafer_torch.parallel import make_mesh
    from wafer_torch.parallel.multislice import MultiSliceOps, make_multislice_mesh
    from wafer_torch.parallel.sharded import ShardedOps
    from wafer_torch.parallel.sharded_split import ShardedSplitOps

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    times = {}

    def per_step(key, fn, steps):
        times[key] = cs.cuda_ms(fn, 2) / steps

    old = os.environ.get("WAFER_EXC_STREAM")
    os.environ["WAFER_EXC_STREAM"] = "f32"
    try:
        n3, su = (256,) * 3, 500
        dn, dt = 0.0375, 4e-4
        an = ("Harmonic", dn, dt, 1.0, *n3, 1.0, 0.0)
        ground = cs.harmonic_state(256, dn, gen, dev)
        excited = cs.harmonic_state(256, dn, gen, dev, odd=True)
        for name, phi0, psn, st in (("ground", ground, False, None),
                                    ("psn", ground, True, None),
                                    ("S=1", excited, False, ground[None].contiguous())):
            per_step(f"256 {name}", lambda: hs.evolve_chunk(
                phi0, "ThreePoint", dt, dn, 1.0, su, an, per_step_norm=psn, store=st), su)
        del ground, excited
        dn_c, dt_c = 0.0625, 1.2e-3
        an_c = ("Harmonic", dn_c, dt_c, 1.0, *n3, 1.0, 0.0, 0.2)
        vr = 0.5 * (dn_c * dn_c) * geometry.r2_index_grid((258,) * 3, n3, torch.float32, dev)
        _ar, _ai, br, bi = potentials.build_ab_split(vr, 0.2 * vr, dt_c)
        b2 = geometry.work_area(torch.stack([br, bi]), 1).contiguous()
        g0 = torch.stack([cs.harmonic_state(256, dn_c, gen, dev),
                          0.1 * cs.harmonic_state(256, dn_c, gen, dev)])
        e1 = torch.stack([cs.harmonic_state(256, dn_c, gen, dev, odd=True),
                          0.1 * cs.harmonic_state(256, dn_c, gen, dev, odd=True)])
        store_g = (g0 / torch.sqrt((g0 * g0).sum()))[None].contiguous()
        for name, phi0, psn, st, streamed in (("ground", g0, False, None, False),
                                              ("streamed", g0, False, None, True),
                                              ("psn", g0, True, None, False),
                                              ("S=1", e1, False, store_g, False)):
            per_step(f"256 complex {name}", lambda: hsp.evolve_chunk_sc(
                phi0, "ThreePoint", dt_c, dn_c, 1.0, su, None if streamed else an_c,
                per_step_norm=psn, store=st, b2=b2 if streamed else None), su)
        del vr, br, bi, b2, g0, e1, store_g

        n5, su5 = (512,) * 3, 100
        dn5, dt5 = 0.03, 2.8e-4
        an5 = ("Harmonic", dn5, dt5, 1.0, *n5, 1.0, 0.0)
        v5 = 0.5 * (dn5 * dn5) * geometry.r2_index_grid((514,) * 3, n5, torch.float32, dev)
        _a5, b5 = potentials.build_ab(v5, dt5)
        b5_int = geometry.work_area(b5, 1).contiguous()
        del v5, _a5, b5
        g5 = cs.harmonic_state(512, dn5, gen, dev)
        x5 = cs.harmonic_state(512, dn5, gen, dev, odd=True, axis=0)
        y5 = cs.harmonic_state(512, dn5, gen, dev, odd=True, axis=1)
        store5 = torch.stack([g5, x5])
        for name, phi0, psn, st, streamed in (("ground analytic", g5, False, None, False),
                                              ("ground streamed", g5, False, None, True),
                                              ("psn", g5, True, None, False),
                                              ("S=1", x5, False, store5[:1], False),
                                              ("S=2", y5, False, store5, False)):
            per_step(f"512 {name}", lambda: hs.evolve_chunk(
                phi0, "ThreePoint", dt5, dn5, 1.0, su5, None if streamed else an5,
                per_step_norm=psn, store=st, b_int=b5_int if streamed else None), su5)
        cfg_r = cs.smoke_config(n5, "Harmonic", dn5, dt5, su5)
        cfg_c = cs.smoke_config(n5, "ComplexHarmonic", dn5, dt5, su5, absorb=0.2)
        c5 = torch.stack([g5, 0.1 * x5])
        for shape in ((8, 1, 1), (4, 2, 1)):
            mesh = make_mesh(shape, [dev] * math.prod(shape))
            for name, pair, phi0, psn, st, streamed in (
                    ("ground analytic", False, g5, False, None, False),
                    ("ground streamed", False, g5, False, None, True),
                    ("psn", False, g5, True, None, False),
                    ("S=1", False, x5, False, store5[:1], False),
                    ("complex ground", True, c5, False, None, False)):
                ops = (ShardedSplitOps(cfg_c, mesh, 0) if pair
                       else ShardedOps(cfg_r, mesh, 0 if st is None else 1))
                if streamed:
                    ops.analytic = None
                blocks = ops.put(geometry.work_area(phi0, 1))
                b_blk = ops.put(b5_int, halo=False) if streamed else None
                st_blk = None if st is None else ops.put_store(geometry.work_area(st, 1))
                chunk = ops.evolve_chunk_psn if psn else ops.evolve_chunk
                per_step(f"512 mesh {shape} {name}", lambda: chunk(blocks, None, b_blk, st_blk),
                         su5)
                del ops, blocks, b_blk, st_blk
        cfg_ms = cs.smoke_config(n5, "Coulomb", dn5, dt5, su5,
                                 mesh={"x": 2, "y": 2, "z": 1, "slices": 2})
        ms_mesh = make_multislice_mesh((2, 2, 1), 2, [dev] * 8)
        for name, phi0, psn, st in (("ground", g5, False, None), ("psn", g5, True, None),
                                    ("S=1", x5, False, store5[:1])):
            ops = MultiSliceOps(cfg_ms, ms_mesh, 0 if st is None else 1)
            blocks = ops.put(geometry.work_area(phi0, 1))
            st_blk = None if st is None else ops.put_store(geometry.work_area(st, 1))
            chunk = ops.evolve_chunk_psn if psn else ops.evolve_chunk
            per_step(f"512 multi-slice 2 x (2, 2, 1) Coulomb {name}",
                     lambda: chunk(blocks, None, None, st_blk), su5)
            del ops, blocks, st_blk
    finally:
        if old is None:
            os.environ.pop("WAFER_EXC_STREAM")
        else:
            os.environ["WAFER_EXC_STREAM"] = old
    return times


# an instruction line of a cuobjdump -sass dump: /*address*/ instruction ;
_SASS_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def solve_cases(kind):
    """The solves ``--solves`` holds bit for bit (``"bits"``) and ``--walls``
    times (``"walls"``): (tag, config text, mesh shape or None, slices,
    ``WAFER_EXC_STREAM`` or None). Bits: phase 4's 256³ E₀/E₁ with bf16
    and f32 stored-state streams, 4b's complex harmonic,
    ``complex_cornell.yaml``, ``multigrid_512.yaml`` (seed 7), phase 4's
    config on (8, 1, 1), (4, 2, 1) and 2 × (2, 2, 1), 4b's on 2 × (2, 1,
    1), and ``coulomb_states.yaml`` and ``cornell.yaml`` (their tags name
    the potential: :func:`b_changed` holds them within tolerance). Walls:
    chip_smoke 4j's per-chunk runs (the five small examples, phase 4, 4f's
    128³ without its trace, phase 4 on (4, 2, 1))."""
    import chip_smoke as cs

    def example(name):
        with open(ROOT / "examples" / name) as fh:
            return fh.read()

    def mesh(text, shape, slices=1):
        return text + "mesh: {x: %d, y: %d, z: %d%s}\n" % (
            *shape, ", slices: %d" % slices if slices > 1 else "")

    main, cplx = cs.MAIN_PATH_CONFIG, cs.COMPLEX_HARMONIC_CONFIG
    if kind == "bits":
        return [
            ("phase 4", main, None, 1, None),
            ("phase 4 f32 streams", main, None, 1, "f32"),
            ("4b complex harmonic", cplx, None, 1, None),
            ("complex_cornell.yaml", example("complex_cornell.yaml"), None, 1, None),
            ("multigrid_512.yaml seed 7", example("multigrid_512.yaml") + "seed: 7\n", None, 1,
             None),
            ("(8, 1, 1)", mesh(main, (8, 1, 1)), (8, 1, 1), 1, None),
            ("(4, 2, 1)", mesh(main, (4, 2, 1)), (4, 2, 1), 1, None),
            ("2 x (2, 2, 1)", mesh(main, (2, 2, 1), 2), (2, 2, 1), 2, None),
            ("complex 2 x (2, 1, 1)", mesh(cplx, (2, 1, 1), 2), (2, 1, 1), 2, None),
            ("coulomb_states.yaml Coulomb", example("coulomb_states.yaml"), None, 1, None),
            ("cornell.yaml SimpleCornell", example("cornell.yaml"), None, 1, None),
        ]
    names = ("harmonic_ground.yaml", "harmonic_excited.yaml", "cornell.yaml",
             "complex_harmonic.yaml", "coulomb_states.yaml")
    return [(name, example(name), None, 1, None) for name in names] + [
        ("phase 4", main, None, 1, None),
        ("4f 128^3", cs.trace_128_text(), None, 1, None),
        ("(4, 2, 1)", mesh(main, (4, 2, 1)), (4, 2, 1), 1, None),
    ]


def run_solves(kind):
    """Each case of :func:`solve_cases` through ``chip_smoke.main_path``:
    {tag: [(SolveResult, wall seconds, launches, seconds writing files) a
    state]}; the writes are the wavefunction and snapshot files a state
    saves inside its wall (``writers.wavefunction``, host work that the
    chunks do not touch)."""
    from wafer_torch import solver
    from wafer_torch.io import writers
    from wafer_torch.parallel import solver_sharded

    writing, per_state = [0.0], []
    orig_write = writers.wavefunction

    def timed_write(*a, **k):
        t = time.perf_counter()
        try:
            return orig_write(*a, **k)
        finally:
            writing[0] += time.perf_counter() - t

    def counted(fn):
        def run(*a, **k):
            writing[0] = 0.0
            res = fn(*a, **k)
            per_state.append(writing[0])
            return res
        return run

    patched = [(writers, "wavefunction", timed_write), (solver, "solve", counted(solver.solve)),
               (solver_sharded, "_solve_state", counted(solver_sharded._solve_state))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _fn in patched]
    for mod, name, fn in patched:
        setattr(mod, name, fn)
    try:
        return _run_solves(kind, per_state)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _run_solves(kind, per_state):
    import chip_smoke as cs

    out = {}
    for tag, text, shape, slices, stream in solve_cases(kind):
        del per_state[:]
        old = os.environ.get("WAFER_EXC_STREAM")
        if stream is not None:
            os.environ["WAFER_EXC_STREAM"] = stream
        try:
            _e, states, _l, _p, _w = cs.main_path(text, shape, slices)
        finally:
            if old is None:
                os.environ.pop("WAFER_EXC_STREAM", None)
            else:
                os.environ["WAFER_EXC_STREAM"] = old
        out[tag] = [(res, secs, launched, write)
                    for (res, secs, _n, launched, _sh), write in zip(states, per_state)]
    return out


def solve_digests():
    """The bit-for-bit record of ``--solves``: each state's steps,
    observables, launches and the SHA-256 of its ψ; for a solve that
    :func:`b_changed` names, one record of its steps, E = energy/norm²
    and ``screen_update``, with the rest beside them."""
    import yaml

    su = {tag: yaml.safe_load(text)["output"]["screen_update"]
          for tag, text, *_rest in solve_cases("bits")}
    outs = {}
    for tag, states in run_solves("bits").items():
        for i, (res, _secs, launched, _write) in enumerate(states):
            key = f"solve {tag} #{i} state {res.wnum}"
            o = res.observables
            record = repr((res.steps, o.energy, o.norm2, o.v_infinity, o.r2))
            launches = json.dumps(launched, sort_keys=True)
            phi = hashlib.sha256(res.phi.contiguous().cpu().numpy().tobytes()).hexdigest()
            if b_changed(key):
                outs[key] = {"steps": res.steps, "energy": float(o.energy / o.norm2),
                             "screen_update": su[tag], "record": record, "launches": launches,
                             "phi": phi}
                continue
            outs[key] = record
            outs[key + " launches"] = launches
            outs[key + " phi"] = phi
    return outs


def time_solves():
    """``--walls`` in one process: each state's wall and chunk seconds,
    steps and graph counters (``SolveResult.graphs``, where the tree has
    them), and the traced 128³ run's share of the loop's wall in Python
    between launches (``chip_smoke.trace_split``)."""
    import chip_smoke as cs

    rows = {tag: [{"wnum": res.wnum, "steps": res.steps, "wall_s": secs,
                   "write_s": write, "loop_s": secs - write, "chunk_s": res.chunk_seconds,
                   "graphs": getattr(res, "graphs", None)}
                  for res, secs, _l, write in states]
            for tag, states in run_solves("walls").items()}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            split, _size = cs.traced_cli("trace", cs.trace_128_text())
        finally:
            os.chdir(cwd)
    rows["traced 128^3"] = [{"wall_ms": split["wall_ms"],
                             "python_ms": split["python_between_launches_ms"],
                             "python_share": split["python_between_launches_ms"]
                             / split["wall_ms"]}]
    return rows


def wall_medians(runs):
    """Each state's median and spread (max − min) of each number over one
    tree's processes."""
    out = {}
    for tag, states in runs[0].items():
        for i, row in enumerate(states):
            for m in row:
                if isinstance(row[m], float):
                    xs = sorted(r[tag][i][m] for r in runs)
                    out[f"{tag} #{i} {m}"] = {"median": xs[len(xs) // 2],
                                             "spread": xs[-1] - xs[0], "all": xs}
    return out


# The kinds of B whose K1 launches the two trees may compute apart.
B_CHANGED = re.compile(r"\b(Coulomb|SimpleCornell)\b")
# K1's launches with three stored states or more (its many-state kernels
# and its wide route) and K3's (its wide route), whose overlaps add in
# another order than the run-time count's (a tree before them)
MANY_CHANGED = re.compile(r"\bS=(?:[3-9]|[1-9]\d+)\b")


def costly_errors(smoke):
    """{case: [ψ′ error of max|ψ′|, reduction error]} of this tree's K1
    against its plain version on the costly-B cases of the chip_smoke.py at
    ``smoke`` (``costly_b_case_list``: Coulomb and SimpleCornell B)."""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("costly_smoke", smoke)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(83)
    return {label: list(cs.costly_b_vs_plain(*args, gen, dev, **kw))
            for label, args, kw in cs.costly_b_case_list(("Coulomb", "SimpleCornell"),
                                                         ("ThreePoint", "SevenPoint"))}


def costly_summary(errs):
    """The trees' :func:`costly_errors` side by side: the case count, each
    tree's worst ψ′ and reduction errors beside their gates, and the cases
    of each that miss a gate."""
    out = {"cases": len(errs["this"]), "same_cases": sorted(errs["other"]) == sorted(errs["this"]),
           "gates": [1e-6, 1e-5]}
    for label, got in errs.items():
        out[label] = {"worst": [max((e[i] for e in got.values()), default=0.0) for i in (0, 1)],
                      "missed": sorted(k for k, e in got.items() if e[0] > 1e-6 or e[1] > 1e-5)}
    return out


def b_changed(key):
    """Whether a case may leave the other tree's bits: a K1 launch (f32 or
    bf16 stored states) with Coulomb or SimpleCornell B or with three stored
    states or more (its many-state kernels and its wide route, whatever its
    B), a K3 launch with three stored pairs or more (its wide route), or a
    solve of those potentials (its tag names the potential). Every other K3
    launch (ComplexCoulomb included), K2, every other K1 launch and the mesh
    chunks (Harmonic) are held bit for bit."""
    if key.startswith(("K1 ", "K3 ")) and MANY_CHANGED.search(key) is not None:
        return True
    return key.startswith(("K1 ", "solve ")) and B_CHANGED.search(key) is not None


def changed_close(key, mine, theirs):
    """(within tolerance, error) of a :func:`b_changed` case against the
    other tree's: ψ′ as max|Δψ′|/max|ψ′| ≤ 1e-6; partial rows by their
    sums, each relative to the norm² (overlaps: to its root, the stored
    states having norm ≤ 1) ≤ 1e-5; a solve's E = energy/norm² ≤ 1e-6
    relative with its steps within one ``screen_update`` chunk (error:
    the larger of the two ratios to their limits). ``mine`` and
    ``theirs`` are tensors for a launch, records for a solve."""
    if key.startswith("solve "):
        e = abs(mine["energy"] - theirs["energy"]) / abs(theirs["energy"])
        steps = abs(mine["steps"] - theirs["steps"]) / theirs["screen_update"]
        return e <= 1e-6 and steps <= 1, max(e / 1e-6, steps)
    if key.endswith("partials"):
        a, b = mine.double().sum(dim=0).tolist(), theirs.double().sum(dim=0).tolist()
        scale = [abs(b[0])] + [abs(b[0]) ** 0.5] * (len(b) - 1)
        err = max(abs(x - y) / z for x, y, z in zip(a, b, scale))
        return err <= 1e-5, err
    err = ((mine.float() - theirs.float()).abs().max() / theirs.float().abs().max()).item()
    return err <= 1e-6, err


def compare_digests(a, b):
    """The cases of dump ``b`` (this tree's) that leave dump ``a``'s (the
    other's): a differing digest, or a :func:`b_changed` case outside
    :func:`changed_close`; and {case: error} of the b_changed cases whose
    bits differ."""
    import torch

    differ, changed = [], {}
    for key in sorted(a):
        x, y = a[key], b.get(key)
        if b_changed(key) and isinstance(x, dict) and isinstance(y, dict):
            if key.startswith("solve "):
                ok, err = changed_close(key, y, x)
            elif x["digest"] == y["digest"]:
                continue
            else:
                ok, err = changed_close(key, torch.load(y["file"]), torch.load(x["file"]))
            if x != y:
                changed[key] = err
            if not ok:
                differ.append(key)
        elif x != y:
            differ.append(key)
    return differ, changed


def parse_sass(text):
    """{mangled name: [(address, instruction)]} of every function in the
    text of a ``cuobjdump -sass`` dump. Only instruction lines count (each
    starts with its address; the instruction is kept with its predicate,
    without the ``;`` and the encoding): not the encoding lines between
    them, nor the headers of the next cubin that follow a file's last
    function."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _SASS_LINE.match(line)
        if name is not None and m:
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def sass_text(lib):
    """``cuobjdump -sass`` of a built library."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(lib)], stdout=subprocess.PIPE, text=True,
                          check=True).stdout


def masked_kernels(text):
    """The K1, K1 bf16, K3, K2 and empty-launch kernels of a dump's text:
    {name: instructions} with addresses, encodings and constant-bank
    offsets (the parameters' places) masked. The anonymous namespace's
    prefix (the file's name and a hash) is cut from each name, and a kernel with
    the template argument ``false`` (no plane checks) is keyed by the name
    of the kernel without that argument."""
    kernels = {}
    for name, code in parse_sass(text).items():
        # the last mention: the prefix may name the file (finish_coef_cu)
        at = [name.rfind(k) for k in ("sweep_step", "finish_coef", "noop_kernel") if k in name]
        if at:
            kernels[name[max(at):].replace("Lb0E", "")] = [
                re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][P]", ins) for _addr, ins in code]
    return kernels


def sass_kernels(root):
    """:func:`masked_kernels` of ``root``'s newest built library."""
    (lib,) = sorted((root / "wafer_torch" / "_kernels").glob("libwafer_torch_*.so"),
                    key=os.path.getmtime)[-1:]
    return masked_kernels(sass_text(lib))


def family(name):
    """The kernel a masked name belongs to: K1 f32, K1 bf16 (each with its
    costly-B kernel, its many-state kernels and its wide route apart), K3
    (its wide route apart) or K2."""
    for prefix, fam in (("sweep_step_wide", "K1 f32 wide"), ("sweep_step_bf16_wide", "K1 bf16 wide"),
                        ("sweep_step_sc_wide", "K3 wide"),
                        ("sweep_step_many_costly", "K1 f32 many costly B"),
                        ("sweep_step_bf16_many_costly", "K1 bf16 many costly B"),
                        ("sweep_step_many", "K1 f32 many"), ("sweep_step_bf16_many", "K1 bf16 many")):
        if name.startswith(prefix):
            return fam
    if name.startswith("sweep_step_costly"):
        return "K1 f32 costly B"
    if name.startswith("sweep_step_bf16_costly"):
        return "K1 bf16 costly B"
    if name.startswith("sweep_step_bf16"):
        return "K1 bf16"
    if name.startswith("sweep_step_sc"):
        return "K3"
    return "K1 f32" if name.startswith("sweep_step_kernel") else "K2"


def run(root, *args):
    out = subprocess.run([sys.executable, str(root / "tools" / Path(__file__).name), *args],
                         cwd=root, stdout=subprocess.PIPE, text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def main(argv):
    ap = argparse.ArgumentParser(prog="compare_launches.py")
    ap.add_argument("--other")
    ap.add_argument("--dump")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--solves", action="store_true")
    ap.add_argument("--walls", action="store_true")
    ap.add_argument("--no-launches", action="store_true")
    ap.add_argument("--time-solves", action="store_true")
    ap.add_argument("--costly-b", action="store_true")
    ap.add_argument("--costly-errors")
    args = ap.parse_args(argv)
    if args.costly_errors:
        print(json.dumps(costly_errors(args.costly_errors)))
        return 0
    if args.dump:
        dump(args.dump, args.solves)
        print("dumped")
        return 0
    if args.time:
        print(json.dumps({**time_sweeps(), **time_streams(), **time_chunks()}))
        return 0
    if args.time_solves:
        print(json.dumps(time_solves()))
        return 0
    other = Path(args.other).resolve()
    shutil.copy(__file__, other / "tools" / Path(__file__).name)
    if args.costly_b:
        errs = {label: json.loads(run(root, "--costly-errors", str(ROOT / "chip_smoke.py")))
                for label, root in (("other", other), ("this", ROOT))}
        print(json.dumps(costly_summary(errs)))
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        digests = {}
        for label, root in (("other", other), ("this", ROOT)):
            path = str(Path(tmp) / f"{label}.json")
            run(root, "--dump", path, *(["--solves"] if args.solves else []))
            with open(path) as fh:
                digests[label] = json.load(fh)
        a, b = digests["other"], digests["this"]
        differ, changed = compare_digests(a, b)
    result = {"cases": len(a), "same_keys": sorted(a) == sorted(b),
              "held": not differ and sorted(a) == sorted(b), "differ": differ[:20],
              "b_changed_cases": sum(1 for k in a if b_changed(k)),
              "b_changed_bits_differ": len(changed),
              "b_changed_worst": max(changed.values(), default=0.0),
              "b_changed_errors": dict(sorted(changed.items(), key=lambda kv: -kv[1])[:20])}
    if args.sass:
        ka, kb = sass_kernels(other), sass_kernels(ROOT)
        changed, families = {}, {}
        for name, ins in ka.items():
            mine = kb.get(name)
            same = families.setdefault(family(name), [0, 0])
            same[1] += 1
            if mine == ins:
                same[0] += 1
            else:
                changed[name] = (None if mine is None else
                                 sum(1 for d in difflib.ndiff(ins, mine) if d[:1] in "+-"))
        result["sass"] = {"kernels": sum(n for _i, n in families.values()),
                          "identical": sum(i for i, _n in families.values()),
                          "identical_of": families, "changed_lines": changed,
                          "only_this": sorted(set(kb) - set(ka))}
    if not args.no_launches:
        times = {"other": [], "this": []}
        for k in range(args.pairs):
            for label in (("other", "this") if k % 2 == 0 else ("this", "other")):
                times[label].append(json.loads(run(other if label == "other" else ROOT,
                                                   "--time")))
        result["times"] = times
        result["medians"] = {label: {m: sorted(t[m] for t in runs)[len(runs) // 2]
                                     for m in runs[0]}
                             for label, runs in times.items()}
    if args.walls:
        walls = {"other": [], "this": []}
        for k in range(args.pairs):
            for label in (("other", "this") if k % 2 == 0 else ("this", "other")):
                walls[label].append(json.loads(run(other if label == "other" else ROOT,
                                                   "--time-solves")))
        result["walls"] = {label: wall_medians(runs) for label, runs in walls.items()}
        result["wall_runs"] = walls
    print(json.dumps(result))
    return 0 if not differ and sorted(a) == sorted(b) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

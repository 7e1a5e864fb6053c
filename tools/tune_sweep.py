#!/usr/bin/env python3
"""Time the sweep kernels K1 and K3 on one CUDA card for several tile heights,
rows a thread owns, segment lengths, copy-ring sizes and register caps, or for
other versions of their sources.

    python3 tools/tune_sweep.py                   # the sources as they stand
    python3 tools/tune_sweep.py 8,2,16,32768,1    # variants: thread rows, rows a
                                                  # thread, segment, ring bytes, min blocks
    python3 tools/tune_sweep.py OLD/wafer_torch/csrc wafer_torch/csrc   # source trees
    python3 tools/tune_sweep.py wafer_torch/csrc many_max=2   # K1's wide route from S = 3

Each variant is built from a copy of ``wafer_torch/csrc``, a named one with
each sweep's ``kTileY``, ``kRows``, ``kRingBytes`` and ``kMinBlocks`` set
(every sweep alike: K1's routes and K3) and the launch shape's ``kTileRows``
and ``kSegment`` to match (``sweep_common.cuh``), or from a copy of a directory
of sources given instead (another checkout's ``wafer_torch/csrc``, or an
edited copy), or, named ``many_max=N``, from the sources as they stand with
K1's many-state kernels taking at most N stored states (N = 2: none; the wide
route takes the counts past N), all variants' nvcc runs started together. The
script prints, for each sweep kernel of each variant, nvcc's registers and
spill bytes and the instructions of its plane loop (``sass_count.loop_body``),
checks each variant against the plain versions on odd grids (K1 also on bf16
stores, with every analytic kind of B), and holds each variant's outputs at
the timed shapes (ψ' and the partial rows) against the first variant's: bit
for bit, but for the cases ``compare_launches.b_changed`` names (K1 with
Coulomb or SimpleCornell B), held within ``compare_launches.changed_close``.
Then it times every variant in turns, ``--rounds`` times, and prints one JSON
line per variant: the median ms per launch at the main paths' shapes (K1 with
f32 and with bf16 stored states; ThreePoint, and FivePoint/SevenPoint at 256³;
Harmonic, Coulomb, SimpleCornell and Periodic B at 256³ and 512³ with S = 0, 1
and 2, Coulomb also at FivePoint and SevenPoint, the costly kinds also on a
windowed deep block, Coulomb's bf16 S = 1, 2 there and at coulomb_states.yaml's
128³ too; Harmonic, Coulomb and streamed B with S = 3, 4, 5, 6, 8
and 9 (``chip_smoke.MANY_S``: K1's many-state kernels and its wide route) at
256³ and 512³; K3 also with S = 3, 4 and 5 (its wide route) at 256³ and 512³;
CUDA events over repeated launches; ``--match REGEX`` times only the cases
whose name matches), beside the same-work bound of ``chip_smoke.sweep_work``,
and the time of ``Tensor.copy_`` over a ground sweep's bytes, the practical
ceiling of a sweep that reads ψ once and writes ψ' once. Needs nvcc, cuobjdump
and a CUDA card; the port itself is not changed."""

import argparse
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import compare_launches  # noqa: E402
import sass_count  # noqa: E402

# The analytic B of each timed kind: the examples' physics (Coulomb:
# multislice_512.yaml's dn and dt; SimpleCornell: cornell.yaml's, vshift
# its V's least value; Periodic: chip_smoke.analytic_for's).
KINDS = {"Harmonic": (0.03, 2.8e-4, 1.0, 1.0, 0.0), "Coulomb": (0.03, 2.8e-4, 1.0, 1.0, 0.0),
         "SimpleCornell": (0.35, 0.04, 4.65, 0.223, 16.78),
         "Periodic": (0.2, 0.004, 1.0, 1.0, 0.0)}


# The most stored states the wide route's rings hold at ThreePoint with B
# from coordinates (H100, 227 KB of shared memory a block): K1's, K3's pairs.
WIDE_CAP = {"K1": 24, "K3": 11}


def analytic(kind, n):
    dn, dt, mass, sig, vshift = KINDS[kind]
    return (kind, dn, dt, mass, *n, sig, vshift)


def build(variants, tmp):
    """One shared library per variant (thread rows, rows a thread, segment,
    ring bytes, min blocks; () for the sources as they stand; or a
    directory of sources), each sweep kernel's registers, spills and plane
    loop printed."""
    from wafer_torch.ops import _build

    nvcc = _build.find_nvcc()
    jobs = []
    for idx, key in enumerate(variants):
        src = Path(tmp) / f"v{idx}"
        shutil.copytree(key if isinstance(key, str) else _build.CSRC, src)
        if isinstance(key, tuple) and key and key[0] == "many_max":
            # the route rule's bound and its export; the kernels stay as built
            for name, pattern in (("sweep_common.cuh", r"(if \(n_store > )kManyS(\))"),
                                  ("stencil_sweep.cu", r"(wafer_sweep_many_max\(void\) \{ return )"
                                                       r"kManyS(; \})")):
                text, n = re.subn(pattern, rf"\g<1>{key[1]}\2", (src / name).read_text())
                if n != 1:
                    raise RuntimeError(f"{name}: kManyS's use not found once")
                (src / name).write_text(text)
        tiles = isinstance(key, tuple) and key and key[0] != "many_max"
        for cu in src.glob("*.cu*") if tiles else ():
            ty, rows, seg, ring, minb = key
            text = cu.read_text()
            names = ((("kTileRows", ty * rows), ("kSegment", seg)) if cu.suffix == ".cuh" else
                     (("kTileY", ty), ("kRows", rows), ("kRingBytes", ring), ("kMinBlocks", minb)))
            if "constexpr int kTileY" not in text and cu.suffix == ".cu":  # not a sweep (K2)
                continue
            for name, val in names:
                text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {val};",
                                  text)
                if n > 1 or (n == 0 and name in ("kTileY", "kRows", "kTileRows", "kSegment")):
                    raise RuntimeError(f"{cu.name}: {name} not found once")
            cu.write_text(text)
        objs = [src / f"{cu.stem}.o" for cu in sorted(src.glob("*.cu"))]
        procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(o), str(cu)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cu, o in zip(sorted(src.glob("*.cu")), objs)]
        jobs.append((key, src, objs, procs))
    libs = {}
    for key, src, objs, procs in jobs:
        logs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            err = [line for line in "\n".join(logs).splitlines() if "error" in line]
            print(f"variant {key}: nvcc failed: {err[:2]}")
            continue
        lib = src / "lib.so"
        subprocess.run([nvcc, *_build.LINK_FLAGS, "-o", str(lib), *map(str, objs)], check=True)
        print(f"variant {key}: kernel EXT S windowed [K1 f32: unroll]: registers, spill "
              "bytes, plane-loop instructions (MUFU, CALL of them: the special-function unit, "
              "and the IEEE divide's and sqrt's slow paths)")
        code = sass_count.kernels(lib)
        for name, rep in sorted(cs.ptxas_report("\n".join(logs)).items()):
            inst = cs.sweep_instance(name)
            if inst is not None:
                body = sass_count.loop_body(code.get(name, []))
                ops = [sass_count.opcode(ins) for ins in body]
                form = re.search(r"Lb[01]E((?:L[ib]\d+E)+)", name)
                form = " " + ",".join(re.findall(r"\d+", form[1])) if form else ""
                print(f"    {cs.SWEEP_NAMES[inst[0]]} {inst[1]} {inst[2]} {int(inst[3])}{form}: "
                      f"{rep['registers']}, {rep['spill_stores'] + rep['spill_loads']}, "
                      f"{len(body)} ({ops.count('MUFU')}, {ops.count('CALL')})")
        dll = ctypes.CDLL(str(lib))
        for name, (argtypes, restype) in _build._SIGNATURES.items():
            if not hasattr(dll, name):  # an older tree's sources
                continue
            getattr(dll, name).argtypes = argtypes
            getattr(dll, name).restype = restype
        if not hasattr(dll, "wafer_sweep_many_max"):  # sources before K1's many-state route
            dll.wafer_sweep_many_max = lambda: 2
        if not hasattr(dll, "wafer_sweep_row_copy_bytes"):  # sources before the tile copy
            dll.wafer_sweep_row_copy_bytes = lambda *args: 0
        if not hasattr(dll, "wafer_sweep_wide_min"):  # sources before the wide route
            dll.wafer_sweep_wide_min = lambda pair, many=dll.wafer_sweep_many_max: (
                3 if pair else many() + 1)
        if not hasattr(dll, "wafer_sweep_route"):  # sources before the route export: its rule
            dll.wafer_sweep_route = lambda pair, s, bf16, d=dll: (
                6 + (s >= d.wafer_sweep_wide_min(1)) if pair else
                (4 if s >= d.wafer_sweep_wide_min(0) else 2 if s > 2 else 0) + (bf16 and s > 0))
        libs[key] = dll
    return libs


def use(lib):
    """Route the port's wrappers to ``lib``."""
    from wafer_torch.ops import _build, hopper_stencil as hs

    _build.library = lambda: lib
    hs._num_blocks.cache_clear()
    hs._row_copy_widths.cache_clear()
    hs.route.cache_clear()


def cases(dev, gen):
    """(name, n, pair, n_store, reduce, launch) at the main paths' shapes;
    a launch returns the tensors it wrote (ψ' and the partial rows, whose
    count is the current library's)."""
    import torch
    import torch.nn.functional as F

    from wafer_torch import geometry
    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs

    scratch = {}

    def partials(rows, n_red):
        if (rows, n_red) not in scratch:
            scratch[rows, n_red] = torch.empty(rows, n_red, dtype=torch.float64, device=dev)
        return scratch[rows, n_red]

    out = []
    for n in ((256, 256, 256), (512, 512, 512)):
        psi = cs.harmonic_state(n[0], 0.03, gen, dev)
        an = ("Harmonic", 0.03, 2.8e-4, 1.0, *n, 1.0, 0.0)
        for s, red in ((0, False), (0, True), (1, True), (2, True)):
            store = torch.stack([psi] * s) if s else None
            coef = torch.tensor([0.9] + [0.05] * s, device=dev)
            dst = torch.empty_like(psi)

            def k1(psi=psi, dst=dst, coef=coef, s=s, store=store, an=an, red=red):
                part = partials(hs.num_partials(psi, "ThreePoint"), 1 + s) if red else None
                hs.sweep_step(psi, dst, coef, part, order="ThreePoint", scale=0.1, analytic=an,
                              store=store, apply_coef=red)
                return dst, part
            out.append((f"K1 {n[0]}^3 S={s}{' reduce' if red else ''}", n, False, s, red, k1))
            if s:  # the same launch on a bf16 store (K1's bf16 sweep)
                st16 = store.to(torch.bfloat16)

                def k1_16(psi=psi, dst=dst, coef=coef, s=s, st16=st16, an=an):
                    part = partials(hs.num_partials(psi, "ThreePoint"), 1 + s)
                    hs.sweep_step(psi, dst, coef, part, order="ThreePoint", scale=0.1,
                                  analytic=an, store=st16, apply_coef=True)
                    return dst, part
                out.append((f"K1 bf16 {n[0]}^3 S={s} reduce", n, False, s, True, k1_16))
        dst = torch.empty_like(psi)
        out.append((f"copy_ {n[0]}^3 (K1 ground's bytes)", n, False, 0, False,
                    lambda psi=psi, dst=dst: (dst.copy_(psi),)))
        pair = torch.stack([psi, 0.1 * psi])
        dst2 = torch.empty_like(pair)
        out.append((f"copy_ pair {n[0]}^3 (K3 ground's bytes)", n, True, 0, False,
                    lambda pair=pair, dst2=dst2: (dst2.copy_(pair),)))
        an_c = an + (0.2,)
        pairs = torch.stack([pair * 0.5 ** k for k in range(5)])
        for s, red in ((0, False), (0, True), (1, True), (3, True), (4, True), (5, True)):
            store = pairs[:s] if s else None
            coef = torch.tensor([0.9] + [0.05] * (2 * s), device=dev)
            dst = torch.empty_like(pair)

            def k3(pair=pair, dst=dst, coef=coef, s=s, store=store, an_c=an_c, red=red):
                part = partials(hsp.num_partials(pair, "ThreePoint"), 1 + 2 * s) if red else None
                hsp.sweep_step_sc(pair, dst, coef, part, order="ThreePoint", scale=0.1,
                                  analytic=an_c, store=store, apply_coef=red)
                return dst, part
            out.append((f"K3 {n[0]}^3 S={s}{' reduce' if red else ''}", n, True, s, red, k3))
    # the wider stencils at 256^3: K1 and K3, S = 0 and S = 1 with reductions
    for order in ("FivePoint", "SevenPoint"):
        ext = geometry.EXT[order]
        psi = F.pad(geometry.work_area(cs.harmonic_state(256, 0.03, gen, dev), 1), (ext,) * 6)
        pair = torch.stack([psi, 0.1 * psi])
        an = ("Harmonic", 0.03, 2.8e-4, 1.0, 256, 256, 256, 1.0, 0.0)
        for s in (0, 1):
            coef = torch.tensor([0.9] + [0.05] * s, device=dev)
            coef_c = torch.tensor([0.9] + [0.05] * (2 * s), device=dev)
            dst, dst2 = torch.empty_like(psi), torch.empty_like(pair)

            def k1(psi=psi, dst=dst, coef=coef, s=s, an=an, order=order):
                part = partials(hs.num_partials(psi, order), 1 + s) if s else None
                hs.sweep_step(psi, dst, coef, part, order=order, scale=0.05, analytic=an,
                              store=psi[None] if s else None, apply_coef=s > 0)
                return dst, part

            def k3(pair=pair, dst=dst2, coef=coef_c, s=s, an=an, order=order):
                part = partials(hsp.num_partials(pair, order), 1 + 2 * s) if s else None
                hsp.sweep_step_sc(pair, dst, coef, part, order=order, scale=0.05,
                                  analytic=an + (0.2,), store=pair[None] if s else None,
                                  apply_coef=s > 0)
                return dst, part
            red = " reduce" if s else ""
            out.append((f"K1 {order} 256^3 S={s}{red}", (256,) * 3, False, s, s > 0, k1))
            out.append((f"K3 {order} 256^3 S={s}{red}", (256,) * 3, True, s, s > 0, k3))
            # the costly kinds' kernel at the wider stencil: Coulomb B, on f32
            # and (S = 1) bf16 stores
            an_co = analytic("Coulomb", (256,) * 3)
            for st in ((None,) if s == 0 else (psi[None], psi[None].to(torch.bfloat16))):

                def k1_co(psi=psi, dst=dst, coef=coef, s=s, an=an_co, order=order, st=st):
                    part = partials(hs.num_partials(psi, order), 1 + s) if s else None
                    hs.sweep_step(psi, dst, coef, part, order=order, scale=0.05, analytic=an,
                                  store=st, apply_coef=s > 0)
                    return dst, part
                bf16 = " bf16" if st is not None and st.dtype == torch.bfloat16 else ""
                out.append((f"K1{bf16} Coulomb {order} 256^3 S={s}{red}", (256,) * 3, False, s,
                            s > 0, k1_co))
    # the other analytic kinds of B (Coulomb, SimpleCornell, Periodic): K1 at
    # 256^3 and 512^3 with S = 0, 1 and 2 (S >= 1 with the coefficients and
    # reductions, again on bf16 stores), and on a deep block of a 2 x (2, 2, 1)
    # multi-slice shard of 512^3 (136 x 256 x 512, origin 124) with its
    # reduction window (the plane checks), S = 0 and 1
    for n in ((256, 256, 256), (512, 512, 512)):
        psi = cs.harmonic_state(n[0], 0.03, gen, dev)
        stack = torch.stack([psi, 0.5 * psi, 0.25 * psi])
        for kind in ("Coulomb", "SimpleCornell", "Periodic"):
            an = analytic(kind, n)
            for s in (0, 1, 2):
                coef = torch.tensor([0.9] + [0.05] * s, device=dev)
                dst = torch.empty_like(psi)
                for st in ((None,) if s == 0 else (stack[:s], stack[:s].to(torch.bfloat16))):

                    def k1(psi=psi, dst=dst, coef=coef, s=s, st=st, an=an):
                        part = partials(hs.num_partials(psi, "ThreePoint"), 1 + s) if s else None
                        hs.sweep_step(psi, dst, coef, part, order="ThreePoint", scale=0.1,
                                      analytic=an, store=st, apply_coef=s > 0)
                        return dst, part
                    bf16 = " bf16" if st is not None and st.dtype == torch.bfloat16 else ""
                    out.append((f"K1{bf16} {kind} {n[0]}^3 S={s}{' reduce' if s else ''}", n,
                                False, s, s > 0, k1))
        del stack
    # K1 past its kernels of each count (chip_smoke.MANY_S): S = 3 and 4 on
    # its many-state kernels and more on its wide route, Harmonic, Coulomb
    # and streamed B, f32 and bf16 stores, at 256^3 and 512^3
    for n in ((256, 256, 256), (512, 512, 512)):
        psi = cs.harmonic_state(n[0], 0.03, gen, dev)
        stack = torch.stack([psi * 0.5 ** k for k in range(max(cs.MANY_S))])
        stack16 = stack.to(torch.bfloat16)
        b_int = (1.0 / (1.0 + 0.002 * torch.rand(n, generator=gen, device=dev))).contiguous()
        dst = torch.empty_like(psi)
        for kind in ("Harmonic", "Coulomb", "streamed"):
            an = None if kind == "streamed" else analytic(kind, n)
            for s in cs.MANY_S:
                coef = torch.tensor([0.9] + [0.05] * s, device=dev)
                for st in (stack[:s], stack16[:s]):

                    def k1_many(psi=psi, dst=dst, coef=coef, s=s, st=st, an=an, b_int=b_int):
                        part = partials(hs.num_partials(psi, "ThreePoint"), 1 + s)
                        hs.sweep_step(psi, dst, coef, part, order="ThreePoint", scale=0.1,
                                      analytic=an, b_int=None if an else b_int, store=st,
                                      apply_coef=True)
                        return dst, part
                    bf16 = " bf16" if st.dtype == torch.bfloat16 else ""
                    out.append((f"K1{bf16} {kind} {n[0]}^3 S={s} reduce", n, False, s, True,
                                k1_many))
        del stack, stack16
    # the wide route at 256^3 ThreePoint Harmonic with as many stored states
    # as its rings hold and one more (WIDE_CAP: chip_smoke phase 1 prints
    # the caps), K1 on f32 and bf16 stores and K3
    n_w = (256, 256, 256)
    psi_w = cs.harmonic_state(256, 0.03, gen, dev)
    pair_w = torch.stack([psi_w, 0.1 * psi_w])
    for name, s_cap in WIDE_CAP.items():
        for s in (s_cap, s_cap + 1):
            src = pair_w if name == "K3" else psi_w
            stack = torch.stack([src * 0.9 ** k for k in range(s)])
            dst = torch.empty_like(src)
            coef = torch.tensor([0.9] + [0.01] * ((2 if name == "K3" else 1) * s), device=dev)
            for st in ((stack,) if name == "K3" else (stack, stack.to(torch.bfloat16))):

                def wide(src=src, dst=dst, coef=coef, st=st, k3=name == "K3"):
                    mod = hsp if k3 else hs
                    part = partials(mod.num_partials(src, "ThreePoint"), coef.numel())
                    an = analytic("Harmonic", n_w) + ((0.2,) if k3 else ())
                    sweep = hsp.sweep_step_sc if k3 else hs.sweep_step
                    sweep(src, dst, coef, part, order="ThreePoint", scale=0.1, analytic=an,
                          store=st, apply_coef=True)
                    return dst, part
                bf16 = " bf16" if st.dtype == torch.bfloat16 else ""
                label = "K3 Harmonic" if name == "K3" else f"K1{bf16} Harmonic"
                out.append((f"{label} 256^3 S={s} reduce (wide cap {s_cap})", n_w, name == "K3",
                            s, True, wide))
            del stack
    del psi_w, pair_w
    deep = psi[:138, :258].contiguous()
    deep_store = (0.5 * deep)[None].contiguous()  # its own bytes, as a chunk's store
    for kind in ("Coulomb", "SimpleCornell", "Periodic"):
        an = analytic(kind, (512, 512, 512))
        for s in (0, 1):
            coef = torch.tensor([0.9] + [0.05] * s, device=dev)
            dst = torch.empty_like(deep)

            def k1_deep(deep=deep, dst=dst, coef=coef, s=s, an=an):
                part = partials(hs.num_partials(deep, "ThreePoint"), 1 + s)
                hs.sweep_step(deep, dst, coef, part, order="ThreePoint", scale=0.1,
                              analytic=an, store=deep_store if s else None, apply_coef=True,
                              origin=(124, 0, 0), red=(4, 132))
                return dst, part
            out.append((f"K1 {kind} deep 136x256x512 windowed S={s} reduce", (136, 256, 512),
                         False, s, True, k1_deep))
    # K1's bf16 costly kernels on the same deep block (the windowed form),
    # S = 1 and 2, and at coulomb_states.yaml's whole 128^3 grid
    deep16 = torch.stack([0.5 * deep, 0.25 * deep]).to(torch.bfloat16)
    small = cs.harmonic_state(128, 0.125, gen, dev)
    small16 = torch.stack([0.5 * small, 0.25 * small]).to(torch.bfloat16)
    for s in (1, 2):
        coef = torch.tensor([0.9] + [0.05] * s, device=dev)
        dst, dst_s = torch.empty_like(deep), torch.empty_like(small)

        def k1_deep16(dst=dst, coef=coef, s=s):
            part = partials(hs.num_partials(deep, "ThreePoint"), 1 + s)
            hs.sweep_step(deep, dst, coef, part, order="ThreePoint", scale=0.1,
                          analytic=analytic("Coulomb", (512, 512, 512)), store=deep16[:s],
                          apply_coef=True, origin=(124, 0, 0), red=(4, 132))
            return dst, part

        def k1_small16(dst=dst_s, coef=coef, s=s):
            part = partials(hs.num_partials(small, "ThreePoint"), 1 + s)
            hs.sweep_step(small, dst, coef, part, order="ThreePoint", scale=0.1,
                          analytic=("Coulomb", 0.125, 0.005, 1.0, 128, 128, 128, 1.0, 0.0),
                          store=small16[:s], apply_coef=True)
            return dst, part
        out.append((f"K1 bf16 Coulomb deep 136x256x512 windowed S={s} reduce", (136, 256, 512),
                    False, s, True, k1_deep16))
        out.append((f"K1 bf16 Coulomb 128^3 coulomb_states.yaml S={s} reduce", (128,) * 3,
                    False, s, True, k1_small16))
    # one shard block of an (8, 1, 1) mesh of 512^3, at its origin, ground
    blk = cs.harmonic_state(512, 0.03, gen, dev)[:66].contiguous()
    an = ("Harmonic", 0.03, 2.8e-4, 1.0, 512, 512, 512, 1.0, 0.0)
    for pair in (False, True):
        src = torch.stack([blk, 0.1 * blk]) if pair else blk
        dst = torch.empty_like(src)
        sweep = hsp.sweep_step_sc if pair else hs.sweep_step

        def shard(src=src, dst=dst, sweep=sweep, an=an + ((0.2,) if pair else ())):
            sweep(src, dst, torch.ones(1, device=dev), None, order="ThreePoint", scale=0.1,
                  analytic=an, origin=(64, 0, 0))
            return (dst,)
        out.append((f"{'K3' if pair else 'K1'} shard 64x512x512", (64, 512, 512), pair, 0, False,
                    shard))
    return out


def digests(work, kept):
    """({case: SHA-256 of the bytes of each tensor a launch writes}, {case:
    error}). The tensors of the cases ``compare_launches.b_changed`` names
    go into ``kept`` (a copy, on the card) the first time; later their
    largest error against the kept ones (``compare_launches.changed_close``:
    ψ' and the partial rows' sums) goes into the errors, and the digests'
    place holds "within tolerance", or the error where it is not."""
    import torch

    out, errors = {}, {}
    for name, _n, _pair, _s, _red, fn in work:
        written = [t for t in fn() if t is not None]
        torch.cuda.synchronize()
        out[name] = [hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()
                     for t in written]
        if compare_launches.b_changed(name):
            if name not in kept:
                kept[name] = [t.clone() for t in written]
            out[name] = "within tolerance"
            for t, ref, tag in zip(written, kept[name], ("", " partials")):
                ok, err = compare_launches.changed_close(name + tag, t, ref)
                errors[name] = max(errors.get(name, 0.0), err)
                if not ok:
                    out[name] = f"{name + tag}: {err}"
    return out, errors


def variant(arg):
    """A variant of the command line: a source directory, ("many_max", N)
    or the tile constants."""
    if Path(arg).is_dir():
        return str(Path(arg).resolve())
    m = re.fullmatch(r"many_max=(\d+)", arg)
    if m:
        return ("many_max", int(m[1]))
    return tuple(int(x) for x in arg.split(","))


def main(argv):
    import torch

    ap = argparse.ArgumentParser(prog="tune_sweep.py")
    ap.add_argument("variants", nargs="*",
                    help="ty,rows,seg,ring,minblocks, many_max=N or a source directory")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--match", default="", help="time only the cases whose name matches")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_sweep: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    variants = [variant(a) for a in args.variants] or [()]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    with tempfile.TemporaryDirectory(prefix="tune_sweep_") as tmp:
        libs = build(variants, tmp)
        work = [c for c in cases(dev, gen) if re.search(args.match, c[0])]
        first, differ, kept, errors = None, {}, {}, {}
        for key in libs:
            use(libs[key])
            for pair, kinds in ((False, ("Harmonic", "streamed", "Coulomb", "SimpleCornell",
                                         "Periodic")), (True, ("Coulomb",))):
                for order in ("ThreePoint", "SevenPoint"):
                    for kind in kinds:
                        for n_store, apply in cs.RAGGED_MODES:
                            for n in cs.RAGGED:
                                streams = ((None, torch.bfloat16) if n_store and not pair
                                           else (None,))
                                for stream in streams:
                                    errs = cs.ragged_vs_plain(order, kind, n_store, apply, pair,
                                                              n, False, gen, dev, stream)
                                    cs.check(errs[0] <= 1e-6 and errs[1] <= 1e-5,
                                             f"variant {key}: {order} {kind} S={n_store} {n} "
                                             f"stream {stream}: {errs}")
            got, errors[key] = digests(work, kept)
            first = got if first is None else first
            differ[key] = sorted(name for name in got if got[name] != first[name])
        kept.clear()
        times = {key: {} for key in libs}
        for r in range(args.rounds):  # every variant in turns, the order reversed each round
            for key in list(libs)[::1 if r % 2 == 0 else -1]:
                use(libs[key])
                for name, _n, _pair, _s, _red, fn in work:
                    times[key].setdefault(name, []).append(cs.cuda_ms(fn, 100))
        for key in libs:
            row = {"variant": key if isinstance(key, str) else list(key) or "as checked in",
                   "differs_from_first": differ[key],
                   "b_changed_worst_vs_first": max(errors[key].values(), default=0.0)}
            for name, n, pair, s, red, _fn in work:
                ms = sorted(times[key][name])[len(times[key][name]) // 2]
                ext = 3 if "SevenPoint" in name else 2 if "FivePoint" in name else 1
                b = cs.bound(cs.sweep_work(n, ext, s, " streamed " in name, red, pair,
                                           2 if "bf16" in name else 4))[0]
                row[name] = [round(ms, 5), round(b, 5), round(100 * b / ms, 1)]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

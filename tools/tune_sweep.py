#!/usr/bin/env python3
"""Time the sweep kernels K1 and K3 on one CUDA card for several tile
heights, rows a thread owns, segment lengths, copy-ring sizes and register
caps.

    python3 tools/tune_sweep.py                   # the sources as they stand
    python3 tools/tune_sweep.py 8,2,16,32768,1    # variants: thread rows, rows a
                                                  # thread, segment, ring bytes, min blocks

Each variant is built from a copy of ``wafer_torch/csrc``, a named one with its
``kTileY``, ``kRows``, ``kSegment``, ``kRingBytes`` and ``kMinBlocks`` set (both
sweeps alike), all
variants' nvcc runs started together. The script prints nvcc's register
and spill report of each instantiation, checks each variant against the
plain versions on odd grids, and prints one JSON line per variant: ms per
launch at the main paths' shapes (ThreePoint; CUDA events over repeated
launches), beside the same-work bound of ``chip_smoke.sweep_work``, and
the time of ``Tensor.copy_`` over a ground sweep's bytes, the practical
ceiling of a sweep that reads ψ once and writes ψ' once.
Needs nvcc and a CUDA card; the port itself is not changed.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

def build(variants, tmp):
    """One shared library per variant (thread rows, rows a thread, segment,
    ring bytes, min blocks; () for the sources as they stand), nvcc's report
    of each printed."""
    from wafer_torch.ops import _build

    nvcc = _build.find_nvcc()
    jobs = []
    for key in variants:
        src = Path(tmp) / ("v" + "_".join(map(str, key)))
        shutil.copytree(_build.CSRC, src)
        for cu in src.glob("*.cu") if key else ():
            ty, rows, seg, ring, minb = key
            text = cu.read_text()
            if "constexpr int kTileY" not in text:  # not a sweep (K2)
                continue
            for name, val in (("kTileY", ty), ("kRows", rows), ("kSegment", seg),
                              ("kRingBytes", ring), ("kMinBlocks", minb)):
                text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {val};",
                                  text)
                if n != 1:
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
        print(f"variant {key}:")
        kernel = ""
        for line in "\n".join(logs).splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                print(f"    {kernel}: {line.strip()}")
        dll = ctypes.CDLL(str(lib))
        for name, (argtypes, restype) in _build._SIGNATURES.items():
            getattr(dll, name).argtypes = argtypes
            getattr(dll, name).restype = restype
        libs[key] = dll
    return libs


def use(lib):
    """Route the port's wrappers to ``lib``."""
    from wafer_torch.ops import _build, hopper_split as hsp, hopper_stencil as hs

    _build.library = lambda: lib
    hs._num_blocks.cache_clear()
    hsp._num_blocks.cache_clear()


def cases(dev, gen):
    """(name, n, pair, n_store, reduce, launch) at the main paths' shapes."""
    import torch

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
            out.append((f"K1 {n[0]}^3 S={s}{' reduce' if red else ''}", n, False, s, red, k1))
        dst = torch.empty_like(psi)
        out.append((f"copy_ {n[0]}^3 (K1 ground's bytes)", n, False, 0, False,
                    lambda psi=psi, dst=dst: dst.copy_(psi)))
        pair = torch.stack([psi, 0.1 * psi])
        dst2 = torch.empty_like(pair)
        out.append((f"copy_ pair {n[0]}^3 (K3 ground's bytes)", n, True, 0, False,
                    lambda pair=pair, dst2=dst2: dst2.copy_(pair)))
        an_c = an + (0.2,)
        for s, red in ((0, False), (0, True), (1, True)):
            store = pair[None].clone() if s else None
            coef = torch.tensor([0.9] + [0.05] * (2 * s), device=dev)
            dst = torch.empty_like(pair)

            def k3(pair=pair, dst=dst, coef=coef, s=s, store=store, an_c=an_c, red=red):
                part = partials(hsp.num_partials(pair, "ThreePoint"), 1 + 2 * s) if red else None
                hsp.sweep_step_sc(pair, dst, coef, part, order="ThreePoint", scale=0.1,
                                  analytic=an_c, store=store, apply_coef=red)
            out.append((f"K3 {n[0]}^3 S={s}{' reduce' if red else ''}", n, True, s, red, k3))
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
        out.append((f"{'K3' if pair else 'K1'} shard 64x512x512", (64, 512, 512), pair, 0, False,
                    shard))
    return out


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("tune_sweep: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    variants = [tuple(int(x) for x in a.split(",")) for a in argv] or [()]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    with tempfile.TemporaryDirectory(prefix="tune_sweep_") as tmp:
        libs = build(variants, tmp)
        work = cases(dev, gen)
        for key in libs:
            use(libs[key])
            for pair, kinds in ((False, ("Harmonic", "streamed")), (True, ("Coulomb",))):
                for order in ("ThreePoint", "SevenPoint"):
                    for kind in kinds:
                        for n_store, apply in cs.RAGGED_MODES:
                            for n in cs.RAGGED:
                                errs = cs.ragged_vs_plain(order, kind, n_store, apply, pair, n,
                                                          False, gen, dev)
                                cs.check(errs[0] <= 1e-6 and errs[1] <= 1e-5,
                                         f"variant {key}: {order} {kind} S={n_store} {n}: {errs}")
            row = {"variant": list(key) or "as checked in"}
            for name, n, pair, s, red, fn in work:
                ms = cs.cuda_ms(fn, 30)
                b = cs.bound(cs.sweep_work(n, 1, s, False, red, pair))[0]
                row[name] = [round(ms, 5), round(b, 5), round(100 * b / ms, 1)]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

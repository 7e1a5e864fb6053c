#!/usr/bin/env python3
"""Time K2 (``csrc/finish_coef.cu``) on one CUDA card for several shapes of
its single block: threads, and rows a thread loads before adding them.

    python3 tools/tune_finish.py                  # the source as it stands
    python3 tools/tune_finish.py 1024,2 512,4     # variants: threads, rows ahead

Each variant is built from a copy of ``wafer_torch/csrc`` with
``kOneThreads`` and ``kRowsAhead`` set (``kRowsAhead`` holds for the groups'
blocks too), all nvcc runs started together; nvcc's register and spill
report of each single-block instantiation is printed. For each variant and each (rows, n_red) below the
script checks K2 against its plain version, then prints one JSON line of
device µs a launch with the device held (``chip_smoke.held_times``): K2 as
one block and as G groups (G from ``hopper_stencil.finish_groups``'s rule
for more doubles than one block takes), beside ``partials.sum(dim=0)``,
all in one process on one card. Needs nvcc and a CUDA card; the port
itself is not changed.
"""

import ctypes
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

SHAPES = ((2048, 1), (4096, 1), (8192, 1), (16384, 1), (32768, 1), (2048, 2), (4096, 2),
          (8192, 2), (16384, 2), (4096, 3), (8192, 3), (16384, 3))


def build(variants, tmp):
    """One library of finish_coef.cu per variant ((threads, ahead), or ()
    for the source as it stands)."""
    from wafer_torch.ops import _build

    nvcc = _build.find_nvcc()
    jobs = []
    for key in variants:
        src = Path(tmp) / ("v" + "_".join(map(str, key)))
        shutil.copytree(_build.CSRC, src)
        cu = src / "finish_coef.cu"
        text = cu.read_text()
        for name, val in zip(("kOneThreads", "kRowsAhead"), key):
            text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {val};",
                              text)
            if n != 1:
                raise RuntimeError(f"{cu.name}: {name} not found once")
        cu.write_text(text)
        obj = src / "finish_coef.o"
        proc = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(obj), str(cu)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((key, src, obj, proc))
    libs = {}
    for key, src, obj, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"variant {key}: nvcc failed: {[l for l in log.splitlines() if 'error' in l][:2]}")
            continue
        lib = src / "lib.so"
        subprocess.run([nvcc, *_build.LINK_FLAGS, "-o", str(lib), str(obj)], check=True)
        text = (src / "finish_coef.cu").read_text()
        threads, ahead = (int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
                          for name in ("kOneThreads", "kRowsAhead"))
        kernel = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line
            elif ("registers" in line or "spill" in line) and f"kernelILi{threads}E" in kernel:
                nq = re.search(rf"kernelILi{threads}ELi(\d)E", kernel)[1]
                print(f"variant {(threads, ahead)}: one block, NQ {nq}: {line.strip()}")
        handle = ctypes.CDLL(str(lib))
        fn = handle.wafer_finish_coef
        fn.argtypes, fn.restype = _build._SIGNATURES["wafer_finish_coef"]
        libs[key] = handle
    return libs


def main(argv):
    import torch

    from wafer_torch.ops import hopper_stencil as hs

    if not torch.cuda.is_available():
        print("tune_finish: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    variants = [tuple(int(x) for x in a.split(",")) for a in argv] or [()]
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(5)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(variants, tmp)
        for key, lib in libs.items():
            for rows, n_red in SHAPES:
                part = cs.finish_inputs(rows, n_red, gen, dev)
                red = torch.empty(n_red, dtype=torch.float64, device=dev)
                coef = torch.empty(n_red, device=dev)
                red_p, coef_p = torch.empty_like(red), torch.empty_like(coef)
                hs.finish_coef_plain(part, red_p, coef_p)
                groups = min(hs.FINISH_MAX_GROUPS, -(-rows // hs.FINISH_GROUP))
                row = {"variant": key, "rows": rows, "n_red": n_red}
                for g in sorted({1, groups}):
                    scratch = torch.zeros(1 + g * n_red, dtype=torch.float64, device=dev)
                    args = (part.data_ptr(), rows, n_red, red.data_ptr(), coef.data_ptr(),
                            scratch.data_ptr(), g, None, dev.index, stream)
                    red.fill_(float("nan"))
                    cs.check(lib.wafer_finish_coef(*args) == 0, f"{key} launch failed")
                    err = ((red - red_p).abs() / part.abs().sum(dim=0)).max().item()
                    cs.check(err <= 1e-5, f"{key} {rows} x {n_red} G {g}: error {err:.3e}")
                    row[f"k2_g{g}_us"] = cs.held_times(lambda: lib.wafer_finish_coef(*args))[0]
                row["sum_us"] = cs.held_times(lambda: part.sum(dim=0))[0]
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

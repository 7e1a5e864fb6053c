"""Build the CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` (with the shared ``csrc/*.cuh``) compiles with its own
nvcc, all started together, and the objects link into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds,
not minutes). The library is keyed by a hash of the sources and flags and
lands in ``wafer_torch/_kernels/`` (listed in ``.gitignore``); a later
process with the same sources loads it without rebuilding.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from wafer_torch.errors import KernelCompileError

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels"
# No --use_fast_math: B = 1/(1 + dt·V/2) needs an IEEE divide, and the
# drift guard's e-fold limit assumes IEEE denormals.
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*_ARCH, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "wafer_sweep_num_blocks": ([_I, _I, _I, _I], _I),
    "wafer_sweep_route": ([_I, _I, _I], _I),
    "wafer_sweep_many_max": ([], _I),
    "wafer_sweep_row_copy_bytes": ([_P, _I, _I, _I, _I, _I], _I),
    "wafer_sweep_wide_min": ([_I], _I),
    "wafer_sweep_wide_occupancy": ([_I, _I, _I, _I, _I, _IP, _IP], _I),
    "wafer_sweep_step": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         _D, _I, _I, _I, _I, _I, _I, _I, _D, _D, _D, _D, _D, _I, _I, _P, _I, _P],
        _I,
    ),
    "wafer_sweep_step_sc": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         _D, _I, _I, _I, _I, _I, _I, _I, _D, _D, _D, _D, _I, _I, _P, _P],
        _I,
    ),
    "wafer_finish_coef": ([_P, _I, _I, _P, _P, _P, _I, _P, _I, _P], _I),
    "wafer_error_string": ([_I], ctypes.c_char_p),
}


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise KernelCompileError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA sweep kernels "
        "are built from wafer_torch/csrc at first use"
    )


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources unless a library of the same hash exists: one
    nvcc per source, all running at once, then one link. nvcc's report
    (registers, spills) is kept beside the library as ``.log``, with each
    step's wall seconds on lines ``# seconds <step> <s>`` (:func:`build_seconds`)."""
    lib = build_dir / f"libwafer_torch_{source_hash()}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = build_dir / f"{lib.name}.{os.getpid()}.tmp"
    objs = [build_dir / f"{lib.stem}.{src.stem}.{os.getpid()}.o" for src in sources()]
    outs = [obj.with_suffix(".out") for obj in objs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)]
    t0 = time.perf_counter()
    procs = []
    for cmd, out in zip(cmds, outs):
        with open(out, "w") as fh:  # a file, not a pipe: nvcc's report may pass a pipe's size
            procs.append(subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT))
    secs = [None] * len(procs)
    while None in secs:
        for k, proc in enumerate(procs):
            if secs[k] is None and proc.poll() is not None:
                secs[k] = time.perf_counter() - t0
        time.sleep(0.02)
    steps = [(cmd, out.read_text(), proc.returncode) for cmd, out, proc in zip(cmds, outs, procs)]
    timing = [(src.name, t) for src, t in zip(sources(), secs)]
    if all(rc == 0 for _c, _o, rc in steps):
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        t1 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        steps.append((cmd, proc.stdout, proc.returncode))
        timing.append(("link", time.perf_counter() - t1))
    timing.append(("total", time.perf_counter() - t0))
    for path in objs + outs:
        path.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text(
        "".join(" ".join(cmd) + "\n" + out for cmd, out, _rc in steps)
        + "".join(f"# seconds {name} {t:.2f}\n" for name, t in timing))
    failed = [(cmd, out, rc) for cmd, out, rc in steps if rc != 0]
    if failed:
        cmd, out, rc = failed[0]
        raise KernelCompileError(f"{' '.join(cmd)} exited {rc}:\n{out[-4000:]}")
    os.replace(tmp, lib)
    return lib


def build_seconds(lib: Path) -> dict:
    """{source file, "link", "total": wall seconds} of the build that made
    ``lib`` (its ``.log``; empty for a log without them)."""
    out = {}
    for line in lib.with_suffix(".log").read_text().splitlines():
        if line.startswith("# seconds "):
            name, secs = line.split()[2:4]
            out[name] = float(secs)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib

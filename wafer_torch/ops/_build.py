"""Build the CUDA sources at first use and load them with ctypes.

``csrc/*.cu`` (with the shared ``csrc/*.cuh``) compile with nvcc into one
shared library with a plain C interface (no PyTorch headers, so the build takes seconds, not minutes).
The library is keyed by a hash of the sources and flags and lands in
``wafer_torch/_kernels/`` (listed in ``.gitignore``); a later process with
the same sources loads it without rebuilding.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from wafer_torch.errors import KernelCompileError

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels"
# No --use_fast_math: B = 1/(1 + dt·V/2) needs an IEEE divide, and the
# drift guard's e-fold limit assumes IEEE denormals.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "wafer_sweep_num_blocks": ([_I, _I, _I, _I], _I),
    "wafer_sweep_step": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         _D, _I, _D, _D, _D, _D, _D, _P],
        _I,
    ),
    "wafer_sweep_step_sc": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         _D, _I, _D, _D, _D, _D, _P],
        _I,
    ),
    "wafer_finish_coef": ([_P, _I, _I, _P, _P, _P], _I),
    "wafer_error_string": ([_I], ctypes.c_char_p),
}


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
    """Compile the sources unless a library of the same hash exists.
    nvcc's report (registers, spills) is kept beside it as ``.log``."""
    lib = build_dir / f"libwafer_torch_{source_hash()}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = build_dir / f"{lib.name}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise KernelCompileError(
            f"nvcc exited {proc.returncode}:\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib

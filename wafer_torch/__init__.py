"""Wavefarm on PyTorch + CUDA: the imaginary-time Schrödinger solver of
``wafer_tpu`` ported to one NVIDIA Hopper GPU.

The JAX package ``wafer_tpu`` stays the reference. This package imports
``torch`` and never ``jax``; the host layer that needs no array library is
shared with the reference and imported as it is: the YAML schema
(``wafer_tpu.config``), the error hierarchy, the five file formats and the
run-directory lifecycle (``wafer_tpu.io``), logging and terminal output.

Every public array function keeps the reference's fully padded ``(N+bb)³``
layout so the two packages compare like with like. The hot sweep runs as
hand-written CUDA (``csrc/stencil_sweep.cu``, bound in
``ops/hopper_stencil.py``) for real f32 ψ on a CUDA device and as plain
torch ops otherwise.
"""

__version__ = "0.1.0"

from wafer_tpu.config import (  # noqa: F401
    CentralDifference,
    Config,
    FileType,
    Grid,
    Index3,
    InitialCondition,
    OutputConfig,
    PotentialType,
    SymmetryConstraint,
)

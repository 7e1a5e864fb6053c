"""Grid geometry on torch tensors (counterpart of ``wafer_tpu/geometry.py``).

Every field is allocated at ``(N + bb)³`` with ``bb = 2·ext``; the
``ext``-wide frame holds the Dirichlet zero shell (reference:
src/grid.rs:505-534, src/config.rs:222-239).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

EXT = {"ThreePoint": 1, "FivePoint": 2, "SevenPoint": 3}


def work_area(arr: torch.Tensor, ext: int) -> torch.Tensor:
    """Interior view: drop an ``ext``-wide frame from all six faces of the
    last three axes (reference: src/grid.rs:505-513); leading axes, such as
    the (re, im) axis of a pair, are kept."""
    if ext == 0:
        return arr
    return arr[..., ext:-ext, ext:-ext, ext:-ext]


def set_work_area(arr: torch.Tensor, ext: int, value: torch.Tensor) -> torch.Tensor:
    """A copy of ``arr`` with its interior replaced (the functional
    counterpart of the reference's mutable work-area view,
    src/grid.rs:526-534)."""
    if ext == 0:
        return value
    out = arr.clone()
    out[..., ext:-ext, ext:-ext, ext:-ext] = value
    return out


def zero_boundary(arr: torch.Tensor, ext: int) -> torch.Tensor:
    """Force the ``ext``-wide Dirichlet shell on all six faces of the last
    three axes to zero (reference: src/config.rs:597-622)."""
    if ext == 0:
        return arr
    return F.pad(work_area(arr, ext), (ext,) * 6)


def r2_index_grid(
    size: Tuple[int, int, int],
    grid_size: Tuple[int, int, int],
    dtype=torch.float64,
    device=None,
    offset: Tuple[int, int, int] = (0, 0, 0),
) -> torch.Tensor:
    """Squared index-space distance from the grid centre over the work
    area (``calculate_r2``, reference: src/potential.rs:366-371): the ⟨r²⟩
    observable is in raw index units, as in src/grid.rs:428-437. ``size``
    and ``offset`` select a block of the work area (a shard's)."""
    c = [(g + 1.0) / 2.0 for g in grid_size]
    i, j, k = (
        (torch.arange(n, dtype=dtype, device=device) + o).reshape(
            [-1 if a == ax else 1 for a in range(3)]
        ) - c[ax]
        for ax, (n, o) in enumerate(zip(size, offset))
    )
    return i * i + j * j + k * k


def stencil_coefficients(order: str):
    """Per-axis central-difference tap weights and normalisation
    ``(offsets, coeffs, center, k)``: the Laplacian numerator is
    ``Σ_axis Σ_o coeffs[o]·ψ(shift o) − center·ψ`` over the denominator
    ``k·dn²·mass`` (reference: src/grid.rs:568-663)."""
    if order == "ThreePoint":
        return ((1,), (1.0,), 6.0, 2.0)
    if order == "FivePoint":
        return ((1, 2), (16.0, -1.0), 90.0, 24.0)
    if order == "SevenPoint":
        return ((1, 2, 3), (270.0, -27.0, 2.0), 1470.0, 360.0)
    raise ValueError(f"unknown central difference order: {order}")

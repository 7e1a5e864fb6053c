"""Normalisation and Gram-Schmidt orthogonalisation
(counterpart of ``wafer_tpu/ops/gram_schmidt.py``; reference:
src/grid.rs:454-492). The sequential subtraction order is kept: stored
states need not be exactly orthogonal to each other."""

from __future__ import annotations

from typing import Optional

import torch


def get_norm_squared(w: torch.Tensor) -> torch.Tensor:
    """⟨ψ|ψ⟩ over the full padded array (the halo is zero)."""
    if w.is_complex():
        return torch.sum(w.real * w.real + w.imag * w.imag)
    return torch.sum(w * w)


def normalise_wavefunction(w: torch.Tensor, norm2) -> torch.Tensor:
    """ψ / √norm2 (reference: src/grid.rs:459-468). ``norm2`` may be a
    float (taken as f64) or a tensor of any float dtype; the root is taken
    in that precision and cast to ψ's real dtype, as the reference package
    does under x64."""
    if not torch.is_tensor(norm2):
        norm2 = torch.tensor(norm2, dtype=torch.float64, device=w.device)
    return w / torch.sqrt(norm2).to(w.real.dtype)


def orthogonalise_wavefunction(
    w: torch.Tensor, w_store: Optional[torch.Tensor], n_lower: int
) -> torch.Tensor:
    """Project out each stored lower state in turn
    (reference: src/grid.rs:477-492): ψ ← ψ − l·⟨l|ψ⟩."""
    if n_lower == 0 or w_store is None:
        return w
    for s in range(n_lower):
        lower = w_store[s]
        overlap = torch.sum(lower.conj() * w)
        w = w - lower * overlap
    return w

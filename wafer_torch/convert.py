"""State carried across from the JAX package: its arrays, as numpy, into
the port's tensors. The equivalence tests build both sides from the same
arrays through these functions.

Nothing here imports jax: anything with ``__array__`` (a jax array, a
numpy array) converts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from wafer_torch.models.potentials import Potentials


def tensor(arr, device=None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A padded field (ψ, V, A, B, …) as a contiguous tensor; the dtype
    follows the array unless given."""
    out = torch.from_numpy(np.array(arr, copy=True))
    return out.to(device=device, dtype=dtype or out.dtype).contiguous()


def pair(re, im, device=None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The reference's split-complex arrays (ψ, (Br, Bi), stored states) as
    the port's (re, im) pair: ``(2, …)`` for fields, ``(S, 2, …)`` for a
    stack of S fields. ``pair(a.real, a.imag)`` carries a complex array."""
    return torch.stack([tensor(re, device, dtype), tensor(im, device, dtype)], dim=-4).contiguous()


def potentials(pots, device=None) -> Potentials:
    """The reference's ``models.potentials.Potentials`` as the port's."""
    psa = pots.pot_sub_array
    return Potentials(
        v=tensor(pots.v, device),
        a=tensor(pots.a, device),
        b=tensor(pots.b, device),
        pot_sub_array=None if psa is None else tensor(psa, device),
        pot_sub_scalar=None if pots.pot_sub_scalar is None else float(pots.pot_sub_scalar),
        v_min=None if pots.v_min is None else float(pots.v_min),
        v_shift=float(pots.v_shift),
    )


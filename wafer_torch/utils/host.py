"""Dtypes, device resolution and device→host transfer
(counterpart of ``wafer_tpu/utils/host.py``).

``Config.dtype``/``Config.real_dtype`` return jax dtypes (they import
``jax.numpy``), so the port maps ``config.precision`` itself and never
calls them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from wafer_torch.errors import DeviceUnavailableError

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def real_dtype(config) -> torch.dtype:
    """torch dtype of ``config.precision`` (the real ψ/V/A/B dtype)."""
    return DTYPES[config.precision]


def to_numpy(t) -> np.ndarray:
    """Host copy of a tensor (any device) as a numpy array."""
    return t.detach().cpu().numpy()


def resolve_device(env=None) -> torch.device:
    """The device the CLI runs on: CUDA unless ``WAFER_DEVICE`` names
    another (``WAFER_DEVICE=cpu`` is the counterpart of the reference's
    ``JAX_PLATFORMS=cpu``). A missing CUDA device raises; it never falls
    back to the CPU silently."""
    env = os.environ if env is None else env
    name = env.get("WAFER_DEVICE", "cuda")
    try:
        device = torch.device(name)
    except RuntimeError as exc:
        raise DeviceUnavailableError(f"WAFER_DEVICE={name!r} is not a torch device") from exc
    if device.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "no CUDA device is available; set WAFER_DEVICE=cpu to run the "
            "plain torch ops on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise DeviceUnavailableError(f"unsupported device type {device.type!r}")
    return device

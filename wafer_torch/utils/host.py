"""Device resolution and device→host transfer (counterpart of
``wafer_tpu/utils/host.py``). Dtypes come from ``Config.dtype`` and
``Config.real_dtype``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from wafer_torch import geometry
from wafer_torch.errors import DeviceUnavailableError


def to_numpy(t) -> np.ndarray:
    """Host copy of a tensor (any device) as a numpy array."""
    return t.detach().cpu().numpy()


def host_work_area(t: torch.Tensor, ext: int) -> np.ndarray:
    """A padded field's work area on the host for the writers; an (re, im)
    pair is fused to re + i·im (complex arrays exist only on the host)."""
    w = to_numpy(geometry.work_area(t, ext))
    return w[0] + 1j * w[1] if t.dim() == 4 else w


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

"""Errors the port adds to the shared hierarchy (``wafer_tpu.errors``)."""

from __future__ import annotations

from wafer_tpu.errors import ConfigParseError, WaferError


class DeviceUnavailableError(WaferError):
    """The requested torch device does not exist on this machine."""

    def __init__(self, msg: str):
        super().__init__(msg)


class NotPortedError(ConfigParseError):
    """A configuration feature the reference supports but the port does
    not run yet; the message names the ROADMAP.md item that ports it."""

    def __init__(self, feature: str, roadmap_item: str):
        super().__init__(
            f"{feature} is not supported by wafer_torch yet "
            f"(ROADMAP.md {roadmap_item}); run it with wafer_tpu"
        )
        self.roadmap_item = roadmap_item


class KernelCompileError(WaferError):
    """nvcc is missing or refused the CUDA sources."""

    def __init__(self, msg: str):
        super().__init__(msg)


class KernelLaunchError(WaferError):
    """A CUDA kernel launch returned a non-zero ``cudaError_t``."""

    def __init__(self, kernel: str, code: int, text: str):
        super().__init__(f"{kernel} launch failed: cudaError {code} ({text})")
        self.code = code

"""Typed error hierarchy (the port's copy of ``wafer_tpu/errors.py``).

The reference implements a 34-variant ``error_chain!`` (src/errors.rs:1-140).
Python exceptions give us chaining (``raise ... from ...``) for free, so each
reference *kind* becomes an exception class with the same display semantics.
The classes at the end are the port's own: a missing device, a
multi-process run that cannot start, and the CUDA kernels' build and
launch failures.
"""

from __future__ import annotations


class WaferError(Exception):
    """Base class for every error raised by the framework."""


class ConfigLoadError(WaferError):
    def __init__(self, path: str):
        super().__init__(f"Unable to read file `{path}`")
        self.path = path


class ConfigParseError(WaferError):
    def __init__(self, msg: str = "an error occurred trying to parse the configuration file"):
        super().__init__(msg)


class SetInitialConditionsError(WaferError):
    def __init__(self):
        super().__init__(
            "an error occurred trying to set the initialisation conditions "
            "on the starting wavefunction"
        )


class LargeDtError(ConfigParseError):
    """Stability guard: dt must be ≤ dn²/3 (reference: src/config.rs:362-365)."""

    def __init__(self):
        super().__init__("Temporal step (grid.dt) must be less than or equal to grid.dn²/3")


class LargeWavenumError(ConfigParseError):
    def __init__(self):
        super().__init__("Wavenum can not be larger than wavemax")


class CreateLogError(WaferError):
    def __init__(self, path: str):
        super().__init__(f"Unable to write log file `{path}`")


class FileNotFoundWaferError(WaferError):
    def __init__(self, path: str):
        super().__init__(f"Unable to find file `{path}`")
        self.path = path


class CreateInputDirError(WaferError):
    def __init__(self):
        super().__init__("Unable to create an input directory")


class CreateOutputDirError(WaferError):
    def __init__(self, path: str):
        super().__init__(f"Unable to create the output directory '{path}'")


class CreateFileError(WaferError):
    def __init__(self, path: str):
        super().__init__(f"Unable to create {path}")


class ReadFileError(WaferError):
    def __init__(self, path: str):
        super().__init__(f"Unable to read {path}")


class ParseFloatError(WaferError):
    def __init__(self):
        super().__init__("Unable to parse string to f64")


class ParsePlainRecordError(WaferError):
    def __init__(self, path: str):
        super().__init__(f"Unable to parse a string of data into a valid record from file {path}")


class ArrayShapeError(WaferError):
    def __init__(self, length: int, dims):
        super().__init__(
            f"Unable to reshape vector with length {length} into an array "
            f"with dimensions {list(dims)}"
        )


class StdInError(WaferError):
    def __init__(self):
        super().__init__("Unable to write to stdin in of the python script process")


class StdOutError(WaferError):
    def __init__(self):
        super().__init__("Unable to recieve data from stdout of the python script process")


class SpawnScriptError(WaferError):
    def __init__(self):
        super().__init__("Unable to spawn a python script process")


class SaveObservablesError(WaferError):
    def __init__(self):
        super().__init__("Unable to save observables data to disk")


class SavePotentialError(WaferError):
    def __init__(self):
        super().__init__("Unable to save potential data to disk")


class SavePotentialSubError(WaferError):
    def __init__(self):
        super().__init__("Unable to save potential_sub data to disk")


class WrongPotentialSubDimsError(WaferError):
    def __init__(self):
        super().__init__("Unable to identify the correct dimensions in potential_sub input file")


class SaveWavefunctionError(WaferError):
    def __init__(self):
        super().__init__("Unable to save wavefunction data to disk")


class SerializeError(WaferError):
    def __init__(self):
        super().__init__("Unable to serialize data from struct")


class DeserializeError(WaferError):
    def __init__(self):
        super().__init__("Unable to deserialize data")


class LoadPotentialError(WaferError):
    def __init__(self):
        super().__init__("Unable to load potential from disk")


class LoadWavefunctionError(WaferError):
    def __init__(self, wnum: int):
        super().__init__(f"Unable to load wavefunction {wnum} from disk")
        self.wnum = wnum


class PotentialNotAvailableError(WaferError):
    def __init__(self):
        super().__init__("Requested potential routine is not available for this potential type")


class ScriptNotFoundError(WaferError):
    def __init__(self):
        super().__init__("No script location was configured for a FromScript potential")


class MaxStepError(WaferError):
    """Divergence guard (reference: src/grid.rs:211-213,244; src/errors.rs:111-114)."""

    def __init__(self):
        super().__init__("Maximum step limit reached before convergence")


class CopyConfigError(WaferError):
    def __init__(self, path: str):
        super().__init__(f"Unable to copy configuration file `{path}` to the output directory")


class DeletePartialError(WaferError):
    def __init__(self, wnum: int):
        super().__init__(f"Unable to remove the partial wavefunction_{wnum} file")


class FlushError(WaferError):
    def __init__(self):
        super().__init__("Unable to flush output buffer")


class NonFiniteError(WaferError):
    """Runtime numeric guard — the counterpart of the reference's
    noisy_float NaN/Inf panics (R64 is the array dtype everywhere,
    src/config.rs:19-22)."""

    def __init__(self, what: str, step: int):
        super().__init__(
            f"non-finite {what} at step {step}: the evolution has diverged "
            "(check dt against the stencil stability bound)"
        )


class DeviceUnavailableError(WaferError):
    """The requested torch device does not exist on this machine."""

    def __init__(self, msg: str):
        super().__init__(msg)


class DistributedInitError(WaferError):
    """A multi-process run (``WAFER_COORDINATOR``) that cannot start: a
    missing or malformed variable, or ranks on unlike devices."""

    def __init__(self, msg: str):
        super().__init__(msg)


class KernelCompileError(WaferError):
    """nvcc is missing or refused the CUDA sources."""

    def __init__(self, msg: str):
        super().__init__(msg)


class KernelLaunchError(WaferError):
    """A CUDA kernel launch returned a non-zero ``cudaError_t``."""

    def __init__(self, kernel: str, code: int, text: str):
        super().__init__(f"{kernel} launch failed: cudaError {code} ({text})")
        self.code = code


class ChunkGraphError(WaferError):
    """Capturing or replaying a chunk's CUDA graph failed (``what``: capture
    or replay) for the bound chunk at ``key``; the chunk does not go on
    eagerly."""

    def __init__(self, what: str, key, exc: Exception):
        super().__init__(f"chunk graph {what} failed for key {key!r}: {exc}")
        self.key = key

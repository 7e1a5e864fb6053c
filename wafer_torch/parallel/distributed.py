"""The multi-process entry (counterpart of
``wafer_tpu/parallel/distributed.py``).

The reference starts ``jax.distributed`` from ``WAFER_COORDINATOR`` (host:port
of process 0), ``WAFER_NUM_PROCESSES`` and ``WAFER_PROCESS_ID``; every
process then sees all devices as one list, and its solver code runs
unchanged. The port's mesh is single-process: a multi-process run, each
rank owning its slice's shards, is ROADMAP.md A10c. Until then a process
started with ``WAFER_COORDINATOR`` set refuses to run, instead of solving
the whole problem alone and writing the same output as every other rank.
"""

from __future__ import annotations

import os

from wafer_torch.errors import NotPortedError


def maybe_initialize_distributed(log=None) -> bool:
    """False when ``WAFER_COORDINATOR`` is unset (the single-process run);
    raises :class:`~wafer_torch.errors.NotPortedError` naming A10c when it
    is set. ``torch.distributed`` is not initialised."""
    if not os.environ.get("WAFER_COORDINATOR"):
        return False
    raise NotPortedError("a multi-process run (WAFER_COORDINATOR)", "A10c")

"""Multi-device solves on a single-process device mesh (counterpart of
``wafer_tpu/parallel``): a mesh of torch devices, per-shard padded blocks
with halo exchange, the multi-slice mesh whose x faces are exchanged once
per window of ``slice_update`` steps, and the sharded driver that
``solver.run`` dispatches to for a config with a multi-device ``mesh``.

Multi-process runs (the reference's ``jax.distributed`` entry) are not
ported yet (ROADMAP.md A10c): ``distributed.maybe_initialize_distributed``
refuses them.
"""

from wafer_torch.parallel.halo import exchange_halos  # noqa: F401
from wafer_torch.parallel.mesh import AXIS_NAMES, Mesh, make_mesh  # noqa: F401

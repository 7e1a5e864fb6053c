"""Multi-device solves on a single-process device mesh (counterpart of
``wafer_tpu/parallel``): a mesh of torch devices, per-shard padded blocks
with halo exchange, and the sharded driver that ``solver.run`` dispatches
to for a config with a multi-device ``mesh``.

The reference's multi-process tiers (``jax.distributed``, multi-slice
meshes) are not ported yet (ROADMAP.md A10b).
"""

from wafer_torch.parallel.halo import exchange_halos  # noqa: F401
from wafer_torch.parallel.mesh import AXIS_NAMES, Mesh, make_mesh  # noqa: F401

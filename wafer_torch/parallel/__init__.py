"""Multi-device solves on a device mesh (counterpart of
``wafer_tpu/parallel``): a mesh of torch devices, per-shard padded blocks
with halo exchange, the multi-slice mesh whose x faces are exchanged once
per window of ``slice_update`` steps, and the sharded driver that
``solver.run`` dispatches to for a config with a multi-device ``mesh``.

A mesh may span processes (``WAFER_COORDINATOR``: the reference's
``jax.distributed`` entry, started by ``distributed``): each process holds
its own shards, and ``transport`` carries the faces and the sums that
cross processes.
"""

from wafer_torch.parallel.halo import exchange_halos  # noqa: F401
from wafer_torch.parallel.mesh import AXIS_NAMES, Mesh, make_mesh  # noqa: F401

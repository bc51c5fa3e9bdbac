"""Device meshes of the port and the store's sharded top-k: one process
drives every shard, a device may hold several (see
:mod:`sema_tpu_torch.parallel.mesh`)."""

from sema_tpu_torch.parallel.mesh import (DATA_AXIS, INDEX_AXIS, Mesh,
                                          default_mesh, local_devices,
                                          make_mesh)
from sema_tpu_torch.parallel.sharded_topk import sharded_topk

__all__ = ["DATA_AXIS", "INDEX_AXIS", "Mesh", "default_mesh",
           "local_devices", "make_mesh", "sharded_topk"]

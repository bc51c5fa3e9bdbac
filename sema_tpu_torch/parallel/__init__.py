"""Device meshes of the port: one process drives every shard, a device may
hold several (see :mod:`sema_tpu_torch.parallel.mesh`)."""

from sema_tpu_torch.parallel.mesh import (DATA_AXIS, INDEX_AXIS, Mesh,
                                          default_mesh, local_devices,
                                          make_mesh)

__all__ = ["DATA_AXIS", "INDEX_AXIS", "Mesh", "default_mesh",
           "local_devices", "make_mesh"]

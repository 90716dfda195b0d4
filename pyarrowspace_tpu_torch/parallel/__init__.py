"""Multi-device build and serving on ``torch.distributed`` (port of
pyarrowspace_tpu/parallel): one process per device, every function a
collective."""

from .mesh import DATA_AXIS, MODEL_AXIS, Comm, make_mesh
from .sharded import ShardedArrowSpace, build_sharded

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Comm", "make_mesh",
           "ShardedArrowSpace", "build_sharded"]

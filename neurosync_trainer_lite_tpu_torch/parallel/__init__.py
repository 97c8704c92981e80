"""Data parallelism over torch.distributed: the rank mesh (mesh.py) and the
multi-process runtime (distributed.py)."""

from neurosync_trainer_lite_tpu_torch.parallel.distributed import (
    initialize_distributed,
)
from neurosync_trainer_lite_tpu_torch.parallel.mesh import (
    Mesh,
    batch_rows,
    make_mesh,
)

__all__ = ["Mesh", "batch_rows", "initialize_distributed", "make_mesh"]

"""Data and tensor parallelism over torch.distributed: the rank mesh and
the sharding rules (mesh.py), the multi-process runtime (distributed.py)
and the Megatron linears over 'model' (tensor.py)."""

from neurosync_trainer_lite_tpu_torch.parallel.distributed import (
    initialize_distributed,
)
from neurosync_trainer_lite_tpu_torch.parallel.mesh import (
    Mesh,
    batch_rows,
    make_mesh,
    param_specs,
    shard_state_dict,
)

__all__ = ["Mesh", "batch_rows", "initialize_distributed", "make_mesh",
           "param_specs", "shard_state_dict"]

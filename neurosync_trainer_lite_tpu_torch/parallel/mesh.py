"""The rank mesh (port of neurosync_trainer_lite_tpu/parallel/mesh.py).

The JAX package lays its devices out as a (dp, tp) mesh with the axes
'data' and 'model'. Here a rank is a device (parallel/distributed.py), so
the mesh is the process group: its 'data' axis the default group's ranks,
the rank's data index its rank. make_mesh keeps the JAX arithmetic and
error text: dp = -1 takes the world divided by tp, and a mesh larger than
the world raises. One stated difference: with a process group up, the
mesh must use every rank (JAX leaves the devices past dp·tp idle; here
they would be whole processes with nothing to do).

Tensor parallelism ('model': param_specs, param_shardings, shard_params)
is not ported yet: tp > 1 raises, and the mesh's collectives run over the
default group, which is the 'data' axis while 'model' has one rank.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np

from neurosync_trainer_lite_tpu_torch.config import check_batch_split
from neurosync_trainer_lite_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class Mesh:
    """dp ranks on 'data' (the default process group; 'model' has one
    rank); data_index is this rank's place on 'data'."""

    dp: int
    data_index: int = 0

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.dp, "model": 1}


def make_mesh(cfg, world: int | None = None) -> Mesh:
    """The (dp, tp) mesh over `world` ranks (default: the process group's
    size, 1 without one)."""
    live = world is None
    world = distributed.world_size() if live else world
    tp = max(1, cfg.tp)
    dp = cfg.dp if cfg.dp > 0 else max(1, world // tp)
    n = dp * tp
    if n > world:
        raise ValueError(f"mesh {dp}x{tp} needs {n} devices, have {world}")
    if tp > 1:
        raise NotImplementedError("tensor parallelism is not ported yet")
    if live and n != world:
        raise ValueError(f"mesh {dp}x{tp} uses {n} of the {world} ranks: "
                         f"launch {n} processes")
    return Mesh(dp=dp, data_index=distributed.rank() if live else 0)


def resolve_mesh(cfg, mesh: Mesh | None = None) -> Mesh | None:
    """`mesh`, or the config's when it asks for dp > 1 or a process group is
    up, else None (one process, no collectives)."""
    if mesh is not None:
        return mesh
    if cfg.dp > 1 or distributed.is_initialized():
        return make_mesh(cfg)
    return None


def batch_rows(mesh: Mesh | None, batch_size: int, accum: int = 1
               ) -> np.ndarray:
    """The global rows of a batch of batch_size that this rank owns.

    The JAX step's micro-batch i is the global rows [i·B/A, (i+1)·B/A)
    (training/step.py), sharded over 'data'. Rank r's share of it is
    [i·B/A + r·m, i·B/A + (r+1)·m) with m = B/(A·dp), so the rank's local
    batch is those shares concatenated over i: with accumulation the rows
    interleave, and the local micro-batch i is exactly the rank's rows of
    the global micro-batch i."""
    dp, r = (1, 0) if mesh is None else (mesh.dp, mesh.data_index)
    check_batch_split(batch_size, accum, dp)
    micro, m = batch_size // accum, batch_size // (accum * dp)
    return np.concatenate([np.arange(i * micro + r * m, i * micro + (r + 1) * m)
                           for i in range(accum)])

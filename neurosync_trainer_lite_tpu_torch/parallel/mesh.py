"""The rank mesh and the sharding rules (port of
neurosync_trainer_lite_tpu/parallel/mesh.py).

The JAX package lays its devices out as a (dp, tp) mesh with the axes
'data' and 'model'. Here a rank is a device (parallel/distributed.py), and
the ranks lay out as JAX's devices[:n].reshape(dp, tp): rank = data_index ·
tp + model_index, so a 'model' group is tp contiguous ranks ({0, 1},
{2, 3}) and a 'data' group the ranks of one model index ({0, 2}, {1, 3}).
make_mesh keeps the JAX arithmetic and error text: dp = -1 takes the world
divided by tp, and a mesh larger than the world raises. One stated
difference: with a process group up, the mesh must use every rank (JAX
leaves the devices past dp·tp idle; here they would be whole processes
with nothing to do).

The Megatron rules (param_specs): q, k, v and linear1 are column-parallel
(a rank holds num_heads / tp heads, ffn_dim / tp hidden units), out and
linear2 row-parallel, everything else replicated. JAX's w is [in, out] and
torch's weight [out, in], so JAX's column rule P(None, 'model') shards
torch's dim 0 (weight and bias) and its row rule P('model', None) torch's
dim 1 (the bias replicated). shard_state_dict cuts a rank's shard from a
full state dict (shard_params' counterpart); parallel/distributed.py:
gather_state_dict puts the shards back together.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from neurosync_trainer_lite_tpu_torch.config import (
    check_batch_split,
    check_tp_split,
)
from neurosync_trainer_lite_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class Mesh:
    """dp ranks on 'data' and tp on 'model'; data_index and model_index
    place this rank. data_group and model_group are its process groups
    (None: the default group, or no group at all in one process)."""

    dp: int
    data_index: int = 0
    tp: int = 1
    model_index: int = 0
    data_group: Any = field(default=None, compare=False, repr=False)
    model_group: Any = field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.dp, "model": self.tp}


def make_mesh(cfg, world: int | None = None) -> Mesh:
    """The (dp, tp) mesh over `world` ranks (default: the process group's
    size, 1 without one). With a process group up, tp > 1 builds the 'data'
    and 'model' subgroups (collective: every rank calls it)."""
    live = world is None
    world = distributed.world_size() if live else world
    tp = max(1, cfg.tp)
    dp = cfg.dp if cfg.dp > 0 else max(1, world // tp)
    n = dp * tp
    if n > world:
        raise ValueError(f"mesh {dp}x{tp} needs {n} devices, have {world}")
    check_tp_split(cfg, tp)
    if live and n != world:
        raise ValueError(f"mesh {dp}x{tp} uses {n} of the {world} ranks: "
                         f"launch {n} processes")
    rank = distributed.rank() if live else 0
    groups = {}
    if live and tp > 1:
        groups = dict(zip(("data_group", "model_group"),
                          distributed.mesh_groups(dp, tp)))
    return Mesh(dp=dp, data_index=rank // tp, tp=tp, model_index=rank % tp,
                **groups)


def resolve_mesh(cfg, mesh: Mesh | None = None) -> Mesh | None:
    """`mesh`, or the config's when it asks for dp > 1 or tp > 1 or a
    process group is up, else None (one process, no collectives)."""
    if mesh is not None:
        return mesh
    if cfg.dp > 1 or cfg.tp > 1 or distributed.is_initialized():
        return make_mesh(cfg)
    return None


def model_sharded(mesh: Mesh | None) -> bool:
    """Whether the mesh shards the model (a 'model' axis of several
    ranks)."""
    return mesh is not None and mesh.tp > 1


def batch_rows(mesh: Mesh | None, batch_size: int, accum: int = 1
               ) -> np.ndarray:
    """The global rows of a batch of batch_size that this rank owns (the
    ranks of one 'model' group own the same rows).

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


# ---------------------------------------------------------------------------
# the Megatron rules

_COLUMN = ("q_linear", "k_linear", "v_linear", "linear1")
_ROW = ("out_linear", "linear2")


def param_specs(cfg) -> dict[str, int | None]:
    """{state-dict key: the torch dim sharded over 'model', or None where
    the leaf is replicated}, for every key of the reference state dict."""
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq

    return {key: param_spec(key) for key in Seq2Seq(cfg, "meta").state_dict()}


def param_spec(key: str) -> int | None:
    """The rule for one state-dict key (a parameter or its Adam moment)."""
    module, leaf = key.rsplit(".", 1)
    name = module.rsplit(".", 1)[-1]
    if name in _COLUMN:
        return 0
    if name in _ROW and leaf == "weight":
        return 1
    return None


def shard_tensor(t: torch.Tensor, dim: int | None, mesh: Mesh | None
                 ) -> torch.Tensor:
    """This rank's block of a full leaf along `dim` (a copy, so the full
    leaf can be freed), or the leaf itself where it is replicated."""
    if dim is None or not model_sharded(mesh):
        return t
    return t.chunk(mesh.tp, dim)[mesh.model_index].clone()


def shard_state_dict(sd: dict, cfg, mesh: Mesh | None) -> dict:
    """A full state dict → this rank's shard of it (param_specs' rules)."""
    if model_sharded(mesh):
        check_tp_split(cfg, mesh.tp)
    return {k: shard_tensor(v, param_spec(k), mesh) for k, v in sd.items()}


def shard_optimizer_state(osd: dict, names: list[str],
                          mesh: Mesh | None) -> dict:
    """A full Adam state dict → this rank's shard: each moment cut as its
    parameter (names[i] is the i-th parameter's key); the step counts and
    the param groups as they are."""
    if not model_sharded(mesh):
        return osd
    state = {i: {k: (shard_tensor(v, param_spec(names[i]), mesh)
                     if k != "step" else v) for k, v in s.items()}
             for i, s in osd["state"].items()}
    return {**osd, "state": state}

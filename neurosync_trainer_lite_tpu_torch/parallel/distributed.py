"""The multi-process runtime over torch.distributed (port of
neurosync_trainer_lite_tpu/parallel/distributed.py).

One JAX device is one rank here: a JAX process drives all the devices it
can address, a PyTorch process drives one card. Rank r runs on
cuda:{LOCAL_RANK} when torchrun set it, else on cuda:{r % device count}, or
on the CPU when the caller asks for it. The process group's backend is
NCCL for CUDA ranks and gloo for CPU ranks, unless the caller names one
(gloo also reduces CUDA tensors, which lets two ranks share one card).

Three launch modes, as the JAX package's:
- single process (the default): initialize_distributed() with no arguments
  is a no-op and returns False;
- auto-detection: init_method="env://" reads torchrun's environment
  (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), where JAX reads a TPU pod's;
- explicit: a coordinator HOST:PORT (tcp://), the process count and this
  process's rank; tests pass a file:// store instead, which needs no port.

A failed collective raises: nothing here falls back to a single process.

The mesh's collectives (parallel/mesh.py) name their axis: the gradient
mean and the rows' all-gather run over 'data', the broadcast of rank 0's
state within each 'data' group; parallel/tensor.py's Megatron sums run
over 'model'. With tp = 1 the 'data' axis is the default group; with tp > 1
make_mesh builds both axes' subgroups (mesh_groups).

host_put has no counterpart: a rank holds its own rows of a batch and
nothing else, so there is no host-global array to place (rank_rows is
assemble_sharded_batch's counterpart). gather_state_dict is
host_local_params': the full state on one rank's host, gathered over
'model' one leaf at a time.
"""

from __future__ import annotations

import datetime
import os
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           backend: str | None = None,
                           init_method: str | None = None, device=None,
                           timeout_s: float | None = None) -> bool:
    """Join the process group. Returns True if this call initialized it.

    coordinator: HOST:PORT of rank 0's store (explicit mode), or
    init_method: a torch.distributed URL (env:// for torchrun, file:// in
    tests). device: "cpu" for CPU ranks (gloo); otherwise this rank's card
    (rank_device) is made current before any CUDA work, as NCCL's barriers
    need. timeout_s bounds every collective (default: torch's)."""
    if (coordinator is None and num_processes is None and process_id is None
            and init_method is None):
        return False
    if init_method is None:
        if coordinator is None:
            raise ValueError("num_processes/process_id need a coordinator "
                             "HOST:PORT")
        init_method = f"tcp://{coordinator}"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        rank_hint = process_id if process_id is not None else int(
            os.environ.get("RANK", "0"))
        torch.cuda.set_device(rank_device(for_rank=rank_hint))
    dist.init_process_group(backend or ("gloo" if on_cpu else "nccl"),
                            init_method=init_method, **kw)
    return True


def is_multiprocess() -> bool:
    return world_size() > 1


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank_device(device=None, *, for_rank: int | None = None) -> torch.device:
    """This rank's device: `device` if it names the CPU; else
    cuda:{LOCAL_RANK} under torchrun, else cuda:{rank % device count}.
    Raises when a CUDA rank finds no card."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for this rank; pass "
                           "device='cpu' to run CPU ranks over gloo")
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    r = rank() if for_rank is None else for_rank
    return torch.device("cuda", r % torch.cuda.device_count())


def _backend_device() -> torch.device:
    """Where a small tensor of the host (a flag) must live for the group's
    backend: the current card under NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(tag: str) -> None:
    """Every rank waits here (a no-op in one process). `tag` names the sync
    point in the error a failed barrier raises."""
    if not is_initialized():
        return
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r} failed") from e


def any_failed(flag: bool) -> bool:
    """True on every rank if `flag` is true on any (an all-reduce of 0/1;
    the JAX package's process_allgather of the flag)."""
    if not is_initialized():
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=_backend_device())
    dist.all_reduce(t)
    return bool(t.item())


@contextmanager
def fenced(tag: str):
    """The sync point `tag` after a block that may fail on some ranks only
    (rank 0's file work): the all-reduce of a failure flag is the barrier,
    and a failure on any rank raises on every rank, where a lone raise
    would leave the others waiting in the next collective. In one process
    the block's own exception propagates unchanged."""
    if not is_initialized():
        yield
        return
    err = None
    try:
        yield
    except Exception as e:  # noqa: BLE001 — re-raised below, on every rank
        err = e
    if any_failed(err is not None):
        raise RuntimeError(f"{tag}: failed" + (
            "" if err is not None else " on another process")) from err


_GROUPS: dict = {}


def mesh_groups(dp: int, tp: int):
    """(this rank's 'data' group, its 'model' group) of a (dp, tp) mesh
    over the default group, rank = data_index · tp + model_index. Every
    rank builds every group, in one order (dist.new_group's contract);
    a mesh's groups are built once a process group."""
    if (dp, tp) not in _GROUPS:
        model, _ = dist.new_subgroups_by_enumeration(
            [[d * tp + m for m in range(tp)] for d in range(dp)])
        data, _ = dist.new_subgroups_by_enumeration(
            [[d * tp + m for d in range(dp)] for m in range(tp)])
        _GROUPS[dp, tp] = (data, model)
    return _GROUPS[dp, tp]


def _group_for(mesh, axis: str = "data") -> bool:
    """Whether the mesh's collectives over `axis` run: with a process group
    up, over an axis of several ranks, and over the one rank of a one-rank
    mesh (its default group); an axis of one rank beside an axis of
    several has nothing to reduce. In one process, False for an axis of
    one rank; an axis of several ranks with no group raises: nothing here
    falls back to a single process."""
    size = mesh.dp if axis == "data" else mesh.tp
    if is_initialized():
        return size > 1 or mesh.dp * mesh.tp == 1
    if size != 1:
        raise RuntimeError(f"a {size}-rank mesh without a process group")
    return False


def all_reduce_mean_(t: torch.Tensor, mesh) -> torch.Tensor:
    """t ← the mean of t over the mesh's 'data' ranks, in place: one
    all-reduce (a sum) and one division by dp."""
    if not _group_for(mesh, "data"):
        return t
    dist.all_reduce(t, group=mesh.data_group)
    if mesh.dp != 1:
        t.div_(mesh.dp)
    return t


def all_reduce_sum_(t: torch.Tensor, mesh) -> torch.Tensor:
    """t ← the sum of t over the mesh's 'model' ranks, in place (fp32 in
    every caller)."""
    if not _group_for(mesh, "model"):
        return t
    dist.all_reduce(t, group=mesh.model_group)
    return t


def broadcast_(tensors: list[torch.Tensor], mesh, src: int = 0) -> None:
    """Overwrite `tensors` on every rank of each 'data' group with its rank
    of data index src, one broadcast a (device, dtype) run of them through
    a flat buffer."""
    if not _group_for(mesh, "data") or not tensors:
        return
    root = src * mesh.tp + mesh.model_index
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, root, group=mesh.data_group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """[m, ...] on each 'data' rank → [dp·m, ...] on every rank, rank
    order."""
    if not _group_for(mesh, "data"):
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.dp)]
    dist.all_gather(parts, t.contiguous(), group=mesh.data_group)
    return torch.cat(parts)


def _gather_leaf(t: torch.Tensor, dim, mesh, keep: bool):
    """A leaf on the host, its 'model' shards concatenated along dim (an
    all-gather over 'model', where a mesh is given); None where not
    keep."""
    if dim is not None and mesh is not None:
        parts = [torch.empty_like(t) for _ in range(mesh.tp)]
        dist.all_gather(parts, t.detach().contiguous(),
                        group=mesh.model_group)
        t = torch.cat(parts, dim)
    return t.detach().to("cpu", copy=True) if keep else None


def gather_state_dict(model, mesh=None, dst: int = 0, optimizer=None):
    """The full reference-format state dict (and, given the optimizer, its
    full Adam state dict) on rank dst's host: {"model": ..., "optimizer":
    ...}; None on every other rank. Collective over 'model' where the mesh
    shards the model: every rank calls it, and the 'model' group of dst
    gathers one leaf at a time, as the JAX package's host_local_params
    does, so no device holds a second full copy of the state (the peak is
    one whole leaf). Without a sharded mesh it is rank dst's host copy."""
    from neurosync_trainer_lite_tpu_torch.parallel.mesh import param_spec

    keep = rank() == dst
    if mesh is None or mesh.tp == 1 or not _group_for(mesh, "model"):
        if not keep:
            return None
        mesh = None                  # every leaf whole on every rank
    elif rank() // mesh.tp != dst // mesh.tp:
        return None                  # no part of dst's 'model' group
    out = {"model": {k: _gather_leaf(v, param_spec(k), mesh, keep)
                     for k, v in model.state_dict().items()}}
    if optimizer is not None:
        names = [k for k, p in model.named_parameters() if p.requires_grad]
        osd = optimizer.state_dict()
        out["optimizer"] = {**osd, "state": {
            i: {k: _gather_leaf(v, None if k == "step" else
                                param_spec(names[i]), mesh, keep)
                for k, v in s.items()}
            for i, s in osd["state"].items()}}
    return out if keep else None


def rank_rows(chunk: np.ndarray, mesh, accum: int = 1) -> np.ndarray:
    """This rank's window indices of one global batch's `chunk`: the rows
    parallel/mesh.py:batch_rows gives it, the only ones it gathers."""
    from neurosync_trainer_lite_tpu_torch.parallel.mesh import batch_rows

    return np.asarray(chunk)[batch_rows(mesh, len(chunk), accum)]


def destroy() -> None:
    """Leave the process group, if one is up."""
    _GROUPS.clear()
    if is_initialized():
        dist.destroy_process_group()

"""The training and eval step (port of
neurosync_trainer_lite_tpu/training/step.py).

One step: the forward with dropout (the step's torch.Generator seeds every
dropout site), the loss, the backward, the pre-clip global gradient norm,
the clip at cfg.grad_clip, and the Adam update at the schedule's LR. With
cfg.grad_accum_steps = A > 1 the batch splits into A micro-batches, run one
after the other with one seed each; their fp32 gradients and losses are
summed and divided by A, and one update follows, as the JAX step's scan.

The model is the one cfg.architecture names (models/architectures.py: the
Seq2Seq or wav2vec 2.0); leaves that take no gradient (wav2vec2's frozen
feature encoder) get no Adam state and no share of the clip's norm.

PyTorch runs eagerly: the step is a Python function over a TrainState that
it updates in place (the JAX step donates its state). Remat comes with the
model (cfg.remat and its knobs, models/layers.py:run_layers).

Data parallelism (a mesh, parallel/mesh.py): each rank runs the forward and
backward on its rows of the batch (batch_rows' layout), micro-batch by
micro-batch, with each dropout mask the rank's rows of the global
micro-batch's (ops/attention.py:dropout_rows). Then one explicit
all-reduce of the flat fp32 gradient, with the loss in its last element,
over the 'data' group, divided by dp: JAX's single psum. The loss's terms
are all means, so the mean of equal shards' means is the global mean.
The pre-clip norm, the clip and Adam follow on every rank from the same
sums, so every rank holds bitwise the same parameters; init_train_state
broadcasts rank 0's to start them equal. No DistributedDataParallel: its
per-bucket hooks fire inside the backward, need no_sync across
accumulation and meet the remat checkpoints and the port's autograd
Functions. Overlapping the reduction with the backward is later work.

Tensor parallelism (a mesh with tp > 1): each rank holds its shard of the
model (models/seq2seq.py, parallel/tensor.py) and its Adam moments, and
the ranks of one 'model' group run the same rows, with every mask their
block of the global draw at the global width (dropout_rows' width block).
The all-reduce above runs over 'data' only; the pre-clip norm sums the
sharded leaves over 'model' (training/optim.py:global_norm), then the clip
and Adam run on the shard. The replicated leaves' gradients are equal on
the ranks of a 'model' group, so those leaves stay bitwise equal there.
init_train_state builds the full model (the generator's init or the
state dict) on every rank and keeps the rank's shard, as the JAX package
inits and then places its state (shard_state); rank 0's broadcast runs
within each 'data' group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from neurosync_trainer_lite_tpu_torch.config import Config, check_batch_split
from neurosync_trainer_lite_tpu_torch.models.loss import (
    loss_fn,
    smoothness_loss_fn,
)
from neurosync_trainer_lite_tpu_torch.models.architectures import architecture
from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq
from neurosync_trainer_lite_tpu_torch.models.wav2vec2 import Wav2Vec2
from neurosync_trainer_lite_tpu_torch.ops.attention import dropout_rows
from neurosync_trainer_lite_tpu_torch.parallel.distributed import (
    all_reduce_mean_,
    broadcast_,
)
from neurosync_trainer_lite_tpu_torch.parallel.mesh import (
    Mesh,
    model_sharded,
    param_spec,
    resolve_mesh,
    shard_optimizer_state,
    shard_state_dict,
)
from neurosync_trainer_lite_tpu_torch.training.optim import (
    clip_by_global_norm_,
    global_norm,
    make_optimizer,
    make_schedule,
)
from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device
from neurosync_trainer_lite_tpu_torch.utils.profiling import span


def trainable(model) -> list[tuple[str, torch.nn.Parameter]]:
    """The (name, parameter) pairs that train: all but frozen ones (the
    wav2vec2 feature encoder's), which get no gradient and no Adam state."""
    return [(k, p) for k, p in model.named_parameters() if p.requires_grad]


@dataclass
class TrainState:
    model: Seq2Seq | Wav2Vec2
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]


def _broadcast_state(state: TrainState, mesh: Mesh | None) -> None:
    """Every rank takes the parameters and Adam moments of the rank of data
    index 0 in its 'data' group (rank 0 without tensor parallelism). Adam's
    step counts stay: they are host scalars, equal on every rank that read
    the same checkpoint (and absent before the first step)."""
    if mesh is None:
        return
    tensors = [p.data for p in state.model.parameters()]
    for param_state in state.optimizer.state.values():
        tensors += [v for k, v in sorted(param_state.items())
                    if k != "step" and isinstance(v, torch.Tensor)]
    broadcast_(tensors, mesh)


def init_train_state(cfg: Config, steps_per_epoch: int, *,
                     generator: torch.Generator | None = None, device=None,
                     state_dict=None, optimizer_state=None,
                     mesh: Mesh | None = None) -> TrainState:
    """A model in train mode (seeded init from `generator`, which lives on
    the device, or `state_dict`), its Adam (from `optimizer_state` if
    given) and its LR schedule. Under a mesh (default: the config's,
    parallel/mesh.py:resolve_mesh) every rank starts from the weights and
    moments of data index 0 in its 'data' group; where the mesh shards the
    model, each rank draws (init_seq2seq) or keeps (of the full state
    dicts) its shard."""
    mesh = resolve_mesh(cfg, mesh)
    device = resolve_device(device)
    arch = architecture(cfg.architecture)
    if state_dict is None:
        if generator is None:
            raise ValueError("init_train_state needs a generator or a "
                             "state_dict")
        model = arch.init(cfg, generator, device, mesh)
    else:
        model = arch.model(cfg, device, mesh)
        model.load_state_dict(shard_state_dict(state_dict, cfg, mesh),
                              strict=True)
        del state_dict
    model.train()
    params = trainable(model)
    state = TrainState(model, make_optimizer(cfg, [p for _, p in params]),
                       make_schedule(cfg, steps_per_epoch))
    if optimizer_state is not None:
        state.optimizer.load_state_dict(shard_optimizer_state(
            optimizer_state, [k for k, _ in params], mesh))
    _broadcast_state(state, mesh)
    return state


def opt_step_count(state: TrainState) -> int:
    """The optimizer's count of updates applied so far."""
    for param_state in state.optimizer.state.values():
        return int(param_state["step"])
    return 0


def _compute_loss(model, src, trg, cfg: Config, generator, step_count=None,
                  total_steps: int = 1):
    pred = model(src, generator)
    if cfg.loss_variant == "smoothness":
        return smoothness_loss_fn(
            pred, trg, delta=cfg.delta, w1=cfg.w1, w2=cfg.w2, w3=cfg.w3,
            w4=cfg.w4, current_step=step_count, total_steps=total_steps,
            anneal=cfg.smoothness_annealing)
    return loss_fn(pred, trg, delta=cfg.delta, w1=cfg.w1, w2=cfg.w2,
                   w3=cfg.w3, zero_penalty_weight=cfg.zero_penalty_weight)


def _reduce_gradients(grads: list[torch.Tensor], loss: torch.Tensor,
                      mesh: Mesh) -> torch.Tensor:
    """The mean over the 'data' ranks of every gradient (in place) and of
    the loss (returned, a copy: a view would keep the flat buffer alive
    while the loop holds the epoch's losses), in one all-reduce of a flat
    fp32 buffer."""
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
    all_reduce_mean_(flat, mesh)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[-1].clone()


def make_train_step(cfg: Config, *, total_steps: int = 1,
                    mesh: Mesh | None = None):
    """Returns step(state, src, trg, generator) → (state, loss, grad_norm),
    the grad norm taken before the clip. Loss and norm stay on the device.

    Under a mesh (default: the config's, parallel/mesh.py:resolve_mesh)
    src and trg are this rank's rows (batch_rows) and the loss and norm
    are the global batch's, equal on every rank. Where the mesh shards the
    model, state.model is this rank's shard (init_train_state)."""
    mesh = resolve_mesh(cfg, mesh)
    if mesh is not None:
        check_batch_split(cfg.batch_size, cfg.grad_accum_steps, mesh.dp)
    blocks = ((1, 0, 1, 0) if mesh is None else
              (mesh.dp, mesh.data_index, mesh.tp, mesh.model_index))
    tp_mesh = mesh if model_sharded(mesh) else None
    anneal = cfg.loss_variant == "smoothness" and cfg.smoothness_annealing
    if anneal and total_steps <= 1:
        # with total_steps=1 the phase is a multiple of 2π at every step
        raise ValueError("smoothness_annealing needs the real step count: "
                         "pass total_steps=steps_per_epoch * n_epochs")

    def step(state: TrainState, src, trg, generator: torch.Generator):
        with span("nsync.step"):
            return _step(state, src, trg, generator)

    def _step(state, src, trg, generator):
        model, opt = state.model, state.optimizer
        count = opt_step_count(state)
        step_count = count if anneal else None
        accum = cfg.grad_accum_steps
        if src.shape[0] % accum:
            raise ValueError(f"batch {src.shape[0]} is not a multiple of "
                             f"grad_accum_steps {accum}")
        model.train()
        with span("nsync.optim.zero_grad"):
            opt.zero_grad(set_to_none=True)
        loss = None
        with dropout_rows(*blocks):
            for s, t in zip(src.chunk(accum), trg.chunk(accum)):
                with span("nsync.step.forward"):
                    micro = _compute_loss(model, s, t, cfg, generator,
                                          step_count, total_steps)
                with span("nsync.step.backward"):
                    micro.backward()
                loss = (micro.detach() if loss is None
                        else loss + micro.detach())
        named = [(k, p.grad) for k, p in model.named_parameters()
                 if p.grad is not None]
        grads = [g for _, g in named]
        if accum > 1:
            for g in grads:
                g.div_(accum)
            loss = loss / accum
        if mesh is not None:
            with span("nsync.step.all_reduce"):
                loss = _reduce_gradients(grads, loss, mesh)
        with span("nsync.optim.clip"):
            grad_norm = global_norm(
                grads, [param_spec(k) is not None for k, _ in named],
                tp_mesh)
            clip_by_global_norm_(grads, grad_norm, cfg.grad_clip)
        with span("nsync.optim.adam"):
            lr = state.schedule(count)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        return state, loss, grad_norm

    return step


def make_eval_step(cfg: Config, *, total_steps: int = 1,
                   mesh: Mesh | None = None):
    """Returns step(model, src, trg, step_count=None) → loss, dropout off.

    step_count matters only for the annealed smoothness loss: the
    optimizer's count keeps the validation loss on the training loss's
    alpha/beta scale. Under a mesh the loss of this rank's rows is
    all-reduced to the global batch's mean."""
    mesh = resolve_mesh(cfg, mesh)

    @torch.no_grad()
    def step(model, src, trg, step_count=None):
        loss = _compute_loss(model, src, trg, cfg, None, step_count,
                             total_steps)
        if mesh is not None:
            loss = all_reduce_mean_(loss.reshape(1), mesh)[0]
        return loss

    return step

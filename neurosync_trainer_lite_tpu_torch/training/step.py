"""The training and eval step (port of
neurosync_trainer_lite_tpu/training/step.py).

One step: the forward with dropout (the step's torch.Generator seeds every
dropout site), the loss, the backward, the pre-clip global gradient norm,
the clip at cfg.grad_clip, and the Adam update at the schedule's LR. With
cfg.grad_accum_steps = A > 1 the batch splits into A micro-batches, run one
after the other with one seed each; their fp32 gradients and losses are
summed and divided by A, and one update follows, as the JAX step's scan.

PyTorch runs eagerly: the step is a Python function over a TrainState that
it updates in place (the JAX step donates its state). Remat comes with the
model (cfg.remat and its knobs, models/seq2seq.py); tensor and data
parallelism are not ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.models.loss import (
    loss_fn,
    smoothness_loss_fn,
)
from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq, init_seq2seq
from neurosync_trainer_lite_tpu_torch.training.optim import (
    clip_by_global_norm_,
    global_norm,
    make_optimizer,
    make_schedule,
)
from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device


@dataclass
class TrainState:
    model: Seq2Seq
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]


def _check_ported(cfg: Config) -> None:
    if cfg.tp != 1 or cfg.dp > 1:
        raise NotImplementedError("tensor and data parallelism are not "
                                  "ported yet")


def init_train_state(cfg: Config, steps_per_epoch: int, *,
                     generator: torch.Generator | None = None, device=None,
                     state_dict=None) -> TrainState:
    """A model in train mode (seeded init from `generator`, which lives on
    the device, or `state_dict`), its Adam and its LR schedule."""
    _check_ported(cfg)
    device = resolve_device(device)
    if state_dict is None:
        if generator is None:
            raise ValueError("init_train_state needs a generator or a "
                             "state_dict")
        model = init_seq2seq(cfg, generator, device)
    else:
        model = Seq2Seq(cfg, device)
        model.load_state_dict(state_dict, strict=True)
    model.train()
    return TrainState(model, make_optimizer(cfg, model.parameters()),
                      make_schedule(cfg, steps_per_epoch))


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


def make_train_step(cfg: Config, *, total_steps: int = 1):
    """Returns step(state, src, trg, generator) → (state, loss, grad_norm),
    the grad norm taken before the clip. Loss and norm stay on the device."""
    _check_ported(cfg)
    anneal = cfg.loss_variant == "smoothness" and cfg.smoothness_annealing
    if anneal and total_steps <= 1:
        # with total_steps=1 the phase is a multiple of 2π at every step
        raise ValueError("smoothness_annealing needs the real step count: "
                         "pass total_steps=steps_per_epoch * n_epochs")

    def step(state: TrainState, src, trg, generator: torch.Generator):
        model, opt = state.model, state.optimizer
        count = opt_step_count(state)
        step_count = count if anneal else None
        accum = cfg.grad_accum_steps
        if src.shape[0] % accum:
            raise ValueError(f"batch {src.shape[0]} is not a multiple of "
                             f"grad_accum_steps {accum}")
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = None
        for s, t in zip(src.chunk(accum), trg.chunk(accum)):
            micro = _compute_loss(model, s, t, cfg, generator, step_count,
                                  total_steps)
            micro.backward()
            loss = micro.detach() if loss is None else loss + micro.detach()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if accum > 1:
            for g in grads:
                g.div_(accum)
            loss = loss / accum
        grad_norm = global_norm(grads)
        clip_by_global_norm_(grads, grad_norm, cfg.grad_clip)
        lr = state.schedule(count)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        return state, loss, grad_norm

    return step


def make_eval_step(cfg: Config, *, total_steps: int = 1):
    """Returns step(model, src, trg, step_count=None) → loss, dropout off.

    step_count matters only for the annealed smoothness loss: the
    optimizer's count keeps the validation loss on the training loss's
    alpha/beta scale."""

    @torch.no_grad()
    def step(model, src, trg, step_count=None):
        return _compute_loss(model, src, trg, cfg, None, step_count,
                             total_steps)

    return step

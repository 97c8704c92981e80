"""Optimizer, LR schedule and gradient clip (port of
neurosync_trainer_lite_tpu/training/optim.py).

- Adam(lr=5e-5, weight_decay=1e-5) with torch semantics: the weight decay is
  L2 added to the gradient before the moments (torch.optim.Adam, not AdamW),
  as optax's add_decayed_weights → scale_by_adam; betas (0.9, 0.999),
  eps 1e-8 after the sqrt.
- The reference's LambdaLR factor per epoch, applied per optimizer step:
  epoch = count // steps_per_epoch, so a resumed run keeps its LR
  trajectory from the optimizer's own step count.
- Global-norm clipping at cfg.grad_clip on the raw gradients, with optax's
  formula: g / ‖g‖ · max where ‖g‖ ≥ max, else g unchanged (not
  clip_grad_norm_'s max / (‖g‖ + 1e-6)). Under tensor parallelism the norm
  is the global arrays' (optax's over GSPMD-sharded leaves): the sharded
  leaves' sums of squares summed over 'model', the replicated leaves'
  counted once, so the clip factor is equal on every rank.
"""

from __future__ import annotations

import torch

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.parallel.tensor import reduce_model_


def lr_factor(epoch: int | float, cfg: Config) -> float:
    """The reference's LambdaLR lambda (model_utils.py:13-16)."""
    if epoch < cfg.warmup_epochs:
        return float(epoch) / float(max(1, cfg.warmup_epochs))
    return max(0.0, float(cfg.n_epochs - epoch)
               / float(max(1, cfg.n_epochs - cfg.warmup_epochs)))


def make_schedule(cfg: Config, steps_per_epoch: int):
    """Per-step LR: base_lr × the epoch factor (epoch = count // steps_per_epoch)."""

    def schedule(count: int) -> float:
        return cfg.learning_rate * lr_factor(count // max(1, steps_per_epoch),
                                             cfg)

    return schedule


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """Adam with L2 weight decay; the step sets the LR from the schedule."""
    return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.weight_decay)


def global_norm(grads, sharded=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm).
    With a mesh that shards the model, sharded[i] says whether grads[i] is
    this rank's block of a leaf sharded over 'model': those sums of squares
    are summed over 'model' (one all-reduce), the others counted once.

    On the card each leaf's sum of squares is the square of its norm from
    one multi-tensor pass (torch._foreach_norm): a few launches for all the
    leaves, where three a leaf left the step paced by the host's dispatch.
    The CPU keeps a sum a leaf, whose cascade summation its norm kernel
    lacks."""
    def sq(gs):
        gs = [g.float() for g in gs]
        if gs and gs[0].is_cuda:
            return torch.stack(torch._foreach_norm(gs)).square().sum()
        return sum(torch.sum(torch.square(g)) for g in gs)

    if mesh is None or mesh.tp == 1:
        return torch.sqrt(sq(grads))
    part = sq(g for g, s in zip(grads, sharded) if s)
    rest = sq(g for g, s in zip(grads, sharded) if not s)
    part = reduce_model_(part.reshape(1), mesh, "grad_norm")[0]
    return torch.sqrt(part + rest)


def clip_by_global_norm_(grads, norm: torch.Tensor, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g / norm * max_norm unless
    norm < max_norm: one factor, chosen on the device (no sync)."""
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)

"""Training loss (port of neurosync_trainer_lite_tpu/models/loss.py).

The reference's active loss (utils/model.py:268-291):

  total = w1 * SmoothL1(pred, target; beta=delta)
        + w2 * L1(Δpred, Δtarget)                     (temporal consistency)
        + w3 * (1 - mean cosine(Δpred, Δtarget))      (directional consistency)

plus the optional zero-dimension penalty (zero_penalty_weight > 0) and the
reference's experimental smoothness variant with its annealed weights. All
math is fp32.
"""

from __future__ import annotations

import math

import torch

# Blendshape dims that are always zero in Lite capture data
# (reference: model.py:313).
ZERO_INDICES = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13,
                51, 52, 53, 54, 55, 56, 57, 58, 59, 60)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative at 0 is +1, as jnp.abs's (torch.abs's is 0).
    Frames that repeat exactly in both prediction and target give zero
    deltas, and the two conventions give those frames other gradients."""
    return torch.where(x >= 0, x, -x)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """torch.nn.SmoothL1Loss(beta) with mean reduction."""
    diff = _abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return loss.mean()


def _cosine_similarity(x: torch.Tensor, y: torch.Tensor,
                       eps: float = 1e-8) -> torch.Tensor:
    """F.cosine_similarity semantics (norms clamped to eps) over the last dim.

    The 1e-24 inside the sqrt keeps the gradient finite where a frame-delta
    vector is exactly zero (silent frames): a plain norm would give 0/0 and
    poison the whole backward pass.
    """
    nx = torch.sqrt((x * x).sum(-1) + 1e-24)
    ny = torch.sqrt((y * y).sum(-1) + 1e-24)
    return (x * y).sum(-1) / (torch.clamp(nx, min=eps) * torch.clamp(ny, min=eps))


def loss_fn(predictions: torch.Tensor, targets: torch.Tensor, *,
            delta: float = 1.0, w1: float = 1.0, w2: float = 1.0,
            w3: float = 1.0, zero_penalty_weight: float = 0.0) -> torch.Tensor:
    """predictions/targets: [B, T, F] → scalar fp32 loss."""
    predictions = predictions.float()
    targets = targets.float()

    rec_loss = smooth_l1(predictions, targets, beta=delta)

    pred_diff = predictions[:, 1:, :] - predictions[:, :-1, :]
    target_diff = targets[:, 1:, :] - targets[:, :-1, :]
    temp_loss = _abs(pred_diff - target_diff).mean()

    cos_sim = _cosine_similarity(pred_diff, target_diff)
    dir_loss = 1.0 - cos_sim.mean()

    total = w1 * rec_loss + w2 * temp_loss + w3 * dir_loss

    if zero_penalty_weight > 0.0:
        zero_features = predictions[:, :, list(ZERO_INDICES)]
        total = total + zero_penalty_weight * _abs(zero_features).mean()

    return total


def smoothness_loss_fn(predictions: torch.Tensor, targets: torch.Tensor, *,
                       delta: float = 1.0, w1: float = 1.0, w2: float = 1.0,
                       w3: float = 1.0, w4: float = 1.0, current_step=None,
                       total_steps: int = 1, anneal: bool = False,
                       anneal_cycles: int = 1000) -> torch.Tensor:
    """The reference's experimental smoothness variant
    (utils/model.py:377-485):

      w1·Huber + α·w2·L2(Δ) + β·w4·L2(Δ²) + w3·(1 − cos(frames))

    with α/β antiphase cosine-annealed over `anneal_cycles` cycles when
    `anneal` is on, else 1. The phase is computed in fp32 from the integer
    step, as the JAX step computes it from the optimizer's int32 counter.
    """
    predictions = predictions.float()
    targets = targets.float()

    err = _abs(targets - predictions)
    huber = torch.where(err <= delta, 0.5 * torch.square(err),
                        delta * err - 0.5 * delta * delta).mean()

    d_pred = predictions[:, :-1] - predictions[:, 1:]
    d_targ = targets[:, :-1] - targets[:, 1:]
    l2_smooth = torch.square(d_pred - d_targ).mean()

    d2_pred = d_pred[:, :-1] - d_pred[:, 1:]
    d2_targ = d_targ[:, :-1] - d_targ[:, 1:]
    second_order = torch.square(d2_pred - d2_targ).mean()

    cos = _cosine_similarity(predictions, targets)
    cos_loss = 1.0 - cos.mean()

    if anneal and current_step is not None:
        step = torch.as_tensor(current_step, dtype=torch.int32,
                               device=predictions.device)
        phase = (step / total_steps) * 2.0 * math.pi * anneal_cycles
        alpha = (torch.cos(phase) + 1.0) / 2.0
        beta = (torch.cos(phase + math.pi) + 1.0) / 2.0
    else:
        alpha = beta = 1.0

    return (w1 * huber + alpha * w2 * l2_smooth
            + beta * w4 * second_order + w3 * cos_loss)

"""The comparisons that decide `correct`: what the program produced on the
timed path against what the plain reference computes from the same inputs.

Training: the batches the program was fed against the windows that the
loop's stated order cuts from the corpus (reference/windows.py), exactly;
each check step's loss, the first gradient as the optimiser got it (Adam's
first moment after step 1) and the parameters' change over the check
steps, the last two per leaf: the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger, and the worst leaf counts. Leaves whose reference
gradient is under a thousandth of the median leaf's are left out: Adam
moves them by round-off alone (a key's bias under softmax).

Serving: each sampled request's frames against the reference's, as the
relative RMS of the difference and as the widest gap over the reference's
largest magnitude.
"""

from __future__ import annotations

import math
from statistics import median

import numpy as np

from benchmark.common import flops, inputs
from benchmark.common.harness import Check
from benchmark.reference import model as ref_model
from benchmark.reference import windows

SMALL_LEAF = 1e-3


def lr_at_start(cfg: dict) -> float:
    """The reference schedule's rate in the first epoch (model_utils.py's
    LambdaLR lambda at epoch 0)."""
    warm, n = int(cfg.get("warmup_epochs", 0)), int(cfg["n_epochs"])
    factor = 0.0 if warm > 0 else max(0.0, n / max(1, n - warm))
    return float(cfg["learning_rate"]) * factor


def check_batches(ctx, device) -> list:
    """The check epoch's first `check_steps` global batches, cut from the
    seeded corpus on the device: [(src, trg)]. On several cards the global
    batch is batch_size_per_chip rows a card."""
    cfg, p = ctx.config, ctx.params
    batch = (int(p["batch_size_per_chip"]) * ctx.chips if ctx.chips > 1
             else int(cfg["batch_size"]))
    window = int(cfg["micro_batch_size"])
    frames = [int(p["clip_frames"])] * int(p["clips"])
    audio, facial = inputs.corpus_series(
        ctx.seed, int(p["clips"]), int(p["clip_frames"]),
        int(cfg["input_dim"]), int(cfg["output_dim"]), device)
    rows = windows.epoch_batches(frames, window, float(cfg["val_split"]),
                                 ctx.seed, 0, batch, int(p["check_steps"]))
    out = [(windows.gather(audio, frames, r, window),
            windows.gather(facial, frames, r, window)) for r in rows]
    del audio, facial
    return out


def train_reference(ctx, device, prec: str = "fp32") -> dict:
    """The reference's readings of the check steps from the seeded weights
    and its own cut of the check's batches, which it keeps (on the host)."""
    import torch

    ref_model.plain_precision()
    cfg = ctx.config
    d = flops.dims(cfg)
    weights = inputs.seeded_weights(d, ctx.seed, device)
    on_device = check_batches(ctx, device)
    seeds = [ref_model.step_seed(ctx.seed, i) for i in range(len(on_device))]
    opt = {"dropout": float(cfg["dropout"]), "delta": float(cfg["delta"]),
           "grad_clip": float(cfg["grad_clip"]),
           "weight_decay": float(cfg["weight_decay"]),
           "lr": lr_at_start(cfg)}
    out = ref_model.train_steps(weights, on_device, seeds, d, opt, prec=prec,
                                rows=int(ctx.params.get("reference_rows",
                                                        64)))
    out["batches"] = [(a.cpu(), b.cpu()) for a, b in on_device]
    del weights, on_device
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _leaf_gap(prog: dict, ref: dict, keep: list[str]) -> float:
    if not keep:
        return math.inf
    med = median(ref[k] for k in keep)
    worst = 0.0
    for k in keep:
        if k not in prog:
            return math.inf
        worst = max(worst, abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30))
    return worst


def kept_leaves(ref: dict) -> list[str]:
    med = median(ref["grad1"].values())
    return [k for k, g in ref["grad1"].items() if g >= SMALL_LEAF * med]


def batch_gap(got: list, want: list) -> float:
    """The largest difference between the batches fed and the windows cut
    (float32 copies, so 0 when sound); inf where they do not pair up."""
    if len(got) != len(want):
        return math.inf
    worst = 0.0
    for pair, ref_pair in zip(got, want):
        for a, b in zip(pair, ref_pair):
            if a.shape != b.shape:
                return math.inf
            gap = float((a.float() - b.float()).abs().max())
            if not math.isfinite(gap):
                return math.inf
            worst = max(worst, gap)
    return worst


def train_readings(prog: dict, ref: dict) -> dict:
    keep = kept_leaves(ref)
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(prog["losses"], ref["losses"]))
    return {"batch_gap": batch_gap(prog["batches"], ref["batches"]),
            "loss_gap": loss_gap,
            "grad_gap": _leaf_gap(prog["m1"], ref["m1"], keep),
            "update_gap": _leaf_gap(prog["delta"], ref["delta"], keep)}


def train_checks(prog: dict, ref: dict, limits: dict) -> list[Check]:
    got = train_readings(prog, ref)
    return [Check(k, float(v), float(limits[k])) for k, v in got.items()]


def frame_gaps(got, want) -> tuple[float, float]:
    """(relative RMS, widest gap over the largest magnitude) of a request's
    frames against the reference's; inf where shapes differ."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        return math.inf, math.inf
    diff = got - want
    scale = max(float(np.sqrt(np.mean(want ** 2))), 1e-30)
    return (float(np.sqrt(np.mean(diff ** 2))) / scale,
            float(np.abs(diff).max()) / max(float(np.abs(want).max()),
                                            1e-30))


def serve_checks(pairs, limits: dict) -> list[Check]:
    """pairs: [(program frames, reference frames)] of the sampled
    requests; the worst request counts."""
    rms, gap = 0.0, 0.0
    for got, want in pairs:
        r, g = frame_gaps(got, want)
        rms, gap = max(rms, r), max(gap, g)
    if not pairs:
        rms = gap = math.inf
    return [Check("frames_rel_rms", rms, float(limits["frames_rel_rms"])),
            Check("frames_max_gap", gap, float(limits["frames_max_gap"]))]

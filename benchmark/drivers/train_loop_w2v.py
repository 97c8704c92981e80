"""Traffic 'train_loop_w2v': the port's training loop on wav2vec 2.0 large,
as a user fine-tunes it on captured face data.

`training/loop.py:train_one_epoch` over a `data/waveform.py:WaveformDataset`
of a seeded corpus (params: `clips` × `clip_frames` frames of 60 fps
targets, `clip_frames` · sr / frame_rate samples of 16 kHz waveform each),
with its shuffled host batches of `batch_size` windows of 128 frames
(34,133 samples), its prefetch thread, its pinned uploads and its
validation every `validation_interval` steps.

The same window, check steps, warm-up, profiled epoch and data-parallel
mechanics as train_loop.py, whose helpers it imports: set-up builds one
training state from the seeded weights (benchmark/reference/wav2vec2.py's
draw) and drives it through `check_steps` steps of an epoch of the loop,
then `warmup_steps` more, timed, to size the window; the window is one
epoch whose max_steps_per_epoch gives about --seconds; with --trace 1 an
epoch of `profile_steps` more runs under the profiler, its kernels given
to the program's spans (common/span_kernels.py) for the per-layer
readers. Then the program's state is freed and the reference follows the
check's steps from the same weights, in row blocks of `reference_rows`,
cutting the batches from the same corpus by the loop's stated order: the
frame windows of reference/windows.py, each taking the samples
[floor(s · sr / frame_rate), + 34,133).
"""

from __future__ import annotations

import numpy as np

from benchmark.common import flops_w2v
from benchmark.common.harness import Outcome, now
from benchmark.common.span_kernels import profiled_spans
from benchmark.drivers.train_loop import (
    _Counting,
    _Ranks,
    _Recorder,
    _Setup,
    program_config,
)
from benchmark.reference import compare, windows
from benchmark.reference import wav2vec2 as ref


def corpus_series(ctx, device):
    """The clips end to end, on the device: waveforms N(0, 1) [clips ·
    samples] and targets U[0, 1) [clips · frames, 61]."""
    import torch

    p, cfg = ctx.params, ctx.config
    frames = int(p["clip_frames"])
    samples = frames * int(cfg["sr"]) // int(cfg["frame_rate"])
    g = ref.generator(ctx.seed, device, 2)
    wave = torch.randn(int(p["clips"]) * samples, generator=g, device=device)
    facial = torch.rand(int(p["clips"]) * frames, int(cfg["output_dim"]),
                        generator=g, device=device)
    return wave, facial, samples


def corpus(ctx, device) -> list[tuple[np.ndarray, np.ndarray]]:
    """corpus_series as the program takes it: host arrays a clip."""
    wave, facial, samples = corpus_series(ctx, device)
    frames, n = int(ctx.params["clip_frames"]), int(ctx.params["clips"])
    wave, facial = wave.cpu().numpy(), facial.cpu().numpy()
    return [(wave[i * samples:(i + 1) * samples],
             facial[i * frames:(i + 1) * frames]) for i in range(n)]


def check_batches(ctx, device) -> list:
    """The check epoch's first `check_steps` global batches, cut from the
    seeded corpus on the device by the loop's stated order."""
    import torch

    cfg, p = ctx.config, ctx.params
    batch = (int(p["batch_size_per_chip"]) * ctx.chips if ctx.chips > 1
             else int(cfg["batch_size"]))
    d = ref.dims(cfg)
    window, n = d["frames"], int(p["clips"])
    frames = [int(p["clip_frames"])] * n
    wave, facial, samples = corpus_series(ctx, device)
    rows = windows.epoch_batches(frames, window, float(cfg["val_split"]),
                                 ctx.seed, 0, batch, int(p["check_steps"]))
    out = []
    for r in rows:
        first = (r[:, 0] * samples + r[:, 1] * int(cfg["sr"])
                 // int(cfg["frame_rate"]))
        idx = torch.as_tensor(first[:, None] + np.arange(d["samples"])[None],
                              device=device)
        out.append((wave[idx], windows.gather(facial, frames, r, window)))
    del wave, facial
    return out


def train_reference(ctx, device, prec: str = "fp32") -> dict:
    """The reference's readings of the check steps from the seeded weights
    and its own cut of the check's batches, which it keeps (on the host)."""
    import torch

    ref.plain_precision()
    cfg = ctx.config
    d = ref.dims(cfg)
    weights = ref.seeded_weights(d, ctx.seed, device)
    on_device = check_batches(ctx, device)
    seeds = [ref.step_seed(ctx.seed, i) for i in range(len(on_device))]
    opt = {"delta": float(cfg["delta"]),
           "grad_clip": float(cfg["grad_clip"]),
           "weight_decay": float(cfg["weight_decay"]),
           "lr": compare.lr_at_start(cfg)}
    out = ref.train_steps(weights, on_device, seeds, d, opt, prec=prec,
                          rows=int(ctx.params.get("reference_rows", 32)))
    out["batches"] = [(a.cpu(), b.cpu()) for a, b in on_device]
    del weights, on_device
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


class _SetupW2v(_Setup):
    """train_loop.py's set-up over the waveform corpus and the wav2vec2
    weights; its epoch(), program_readings() and free() as they are."""

    def __init__(self, ctx):
        from neurosync_trainer_lite_tpu_torch.data.waveform import (
            WaveformDataset)
        from neurosync_trainer_lite_tpu_torch.parallel.mesh import make_mesh
        from neurosync_trainer_lite_tpu_torch.training import loop
        from neurosync_trainer_lite_tpu_torch.training import step as step_mod

        p, seed = ctx.params, ctx.seed
        t = now()
        self.ranks = ranks = _Ranks(ctx)
        self.device = device = ranks.device
        self.cfg = cfg = program_config(ctx)
        self.mesh = make_mesh(cfg) if ranks.on else None
        self.d = d = ref.dims(ctx.config)
        clips = corpus(ctx, device)
        ctx.say(f"corpus drawn in {now() - t:.2f} s")
        ds = WaveformDataset(clips, cfg.micro_batch_size, cfg.sr,
                             cfg.frame_rate)
        train_view, val_view = ds.split(cfg.val_split, cfg.seed)
        steps_per_epoch = len(train_view) // cfg.batch_size
        ctx.say(f"{len(ds)} windows split at {now() - t:.2f} s")
        self.state = step_mod.init_train_state(
            cfg, steps_per_epoch, device=device, mesh=self.mesh,
            state_dict=ref.seeded_weights(d, seed, device))
        total = steps_per_epoch * cfg.n_epochs
        self.eval_step = _Counting(step_mod.make_eval_step(
            cfg, total_steps=total, mesh=self.mesh))
        self.rec = _Recorder(
            step_mod.make_train_step(cfg, total_steps=total, mesh=self.mesh),
            p["check_steps"], lambda: ref.seeded_weights(d, seed, device),
            ranks.rows)
        self.loop, self.views = loop, (train_view, val_view)
        self.batch_step = 0
        ctx.say(f"training state ready at {now() - t:.2f} s")
        self.epoch(0, p["check_steps"])
        ctx.say(f"check steps done at {now() - t:.2f} s")


def readings(ctx, precisions=("fp8",)) -> dict | None:
    """The check's numbers without a window: the program's, and those of
    the reference computed at each of `precisions` in its place (the
    control), each against the float32 reference. Rank 0's; None on the
    others."""
    s = _SetupW2v(ctx)
    prog = s.program_readings()
    s.free()
    if ctx.rank != 0:
        return None
    want = train_reference(ctx, s.device)
    out = {"program": compare.train_readings(prog, want)}
    for prec in precisions:
        low = train_reference(ctx, s.device, prec=prec)
        out[prec] = compare.train_readings(low, want)
    s.ranks.join()
    return out


def run(ctx) -> Outcome | None:
    """The cell's run; on ranks other than 0 their share of it, and None."""
    import torch

    p = ctx.params
    s = _SetupW2v(ctx)
    cfg, d, device = s.cfg, s.d, s.device
    B = cfg.batch_size
    cuda = device.type == "cuda"

    t = now()
    s.epoch(1, p["warmup_steps"])
    step_s = (now() - t) / p["warmup_steps"]
    ctx.say(f"warm-up epoch: {step_s:.4f} s a step")
    n = s.ranks.from_rank0(max(p["min_window_steps"],
                               round(ctx.seconds / step_s)))

    if cuda:
        torch.cuda.synchronize(device)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    s.eval_step.calls = 0
    history: dict = {}
    window_start = now()
    s.epoch(2, n, history)
    window_s = now() - window_start
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    window_peak = int(s.ranks.reduce(window_peak, "max"))
    setup_peak = int(s.ranks.reduce(setup_peak, "max"))
    losses = history.get("train_losses", [])
    failed = sum(1 for x in losses if not abs(x) < float("inf"))
    frames = n * B * cfg.micro_batch_size
    model_flops = (n * B * flops_w2v.train_flops_per_window(d)
                   + s.eval_step.calls * B
                   * flops_w2v.forward_flops_per_window(d))

    profile, busy_us, spans = None, 0.0, {}
    if ctx.trace:
        _, profile, spans = profiled_spans(
            lambda: s.epoch(3, p["profile_steps"]))
        busy_us = s.ranks.reduce(profile.busy_us(), "sum") / ctx.chips

    prog = s.program_readings()
    s.free()
    if ctx.rank != 0:
        return None
    checks = compare.train_checks(prog, train_reference(ctx, device),
                                  ctx.workload["limits"])
    s.ranks.join()
    return Outcome(
        window_start=window_start, window_s=window_s,
        e2e={"train_frames_per_s": frames / window_s,
             "train_peak_mem_gib": window_peak / 2 ** 30},
        attempted=n, failed=failed, checks=checks,
        memory_peak_bytes=max(setup_peak, window_peak), profile=profile,
        extras={"model_flops": model_flops, "window_steps": n,
                "frames": frames, "busy_us": busy_us,
                "span_kernels": {str(k): v for k, v in spans.items()},
                "pos_conv_fwd_flops": flops_w2v.pos_conv_forward_flops(
                    B // ctx.chips, d)})

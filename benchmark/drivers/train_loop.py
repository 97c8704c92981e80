"""Traffic 'train_loop': the port's training loop, as a user trains.

`training/loop.py:train_one_epoch` over a `WindowedDataset` of a seeded
corpus (params: `clips` × `clip_frames` frames), with its shuffled host
batches, its prefetch thread, its pinned uploads and its validation every
`validation_interval` steps.

Set-up builds one training state from the seeded weights and drives it
through `check_steps` steps of an epoch of the loop itself (the check's
steps: their batches, losses, Adam's first moment after step 1 and the
parameters' change after the last are kept), then `warmup_steps` more,
timed, to size the window. The window is one epoch of the loop whose
max_steps_per_epoch gives about --seconds; it ends at the epoch's own
synchronise. With --trace 1 an epoch of `profile_steps` more runs under the
profiler. After all that, the program's state is freed and the reference
follows the check's steps from the same weights, cutting the batches
from the same corpus by the loop's stated order (and the batches the
program was fed are held against them).

On several cards (a cell's `chips` > 1) the loop runs data-parallel, as
users train on up to four: one process a card (this one is rank 0 and
starts the others as `run.py --rank r`), the port's rank mesh over NCCL
(parallel/), `batch_size_per_chip` rows a rank of a global batch of that
many times the cards. The batches fed are the global ones, gathered
from the ranks in rank order, and the reference follows the global batch.
"""

from __future__ import annotations

import gc
import json
import socket
import subprocess
import sys
from pathlib import Path

from benchmark.common import flops, inputs
from benchmark.common.harness import Outcome, now, profiled
from benchmark.reference import compare

RUN = Path(__file__).resolve().parents[1] / "run.py"


class _Recorder:
    """The step the loop calls, keeping what the check needs of the first
    `n` calls: each global batch (before the step), each loss, Adam's first
    moment after the first, and the parameters' change after the n-th."""

    def __init__(self, step, n: int, weights_at_start, gather_rows):
        self.step, self.n, self.calls = step, n, 0
        self.weights_at_start, self.gather_rows = weights_at_start, gather_rows
        self.batches, self.losses, self.m1, self.delta = [], [], {}, {}

    def __call__(self, state, src, trg, generator):
        i = self.calls
        self.calls += 1
        if i < self.n:
            self.batches.append((self.gather_rows(src).cpu(),
                                 self.gather_rows(trg).cpu()))
        state, loss, norm = self.step(state, src, trg, generator)
        if i < self.n:
            self.losses.append(float(loss))
        named = list(state.model.named_parameters())
        if i == 0:
            opt = state.optimizer.state
            self.m1 = {k: float(opt[p]["exp_avg"].norm()) if p in opt
                       else 0.0 for k, p in named}
        if i == self.n - 1:
            start = self.weights_at_start()
            self.delta = {k: float((p.detach() - start[k]).norm())
                          for k, p in named}
            del start
        return state, loss, norm


class _Counting:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def program_config(ctx):
    """The configuration file as the port's Config; on several cards a
    global batch of batch_size_per_chip rows a card over dp = chips."""
    from neurosync_trainer_lite_tpu_torch.config import Config

    cfg = Config.from_dict(ctx.config).replace(seed=ctx.seed)
    if ctx.chips > 1:
        per_chip = int(ctx.params["batch_size_per_chip"])
        cfg = cfg.replace(batch_size=per_chip * ctx.chips, dp=ctx.chips)
    return cfg


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Ranks:
    """The cell's processes, one a card; nothing to coordinate on one."""

    def __init__(self, ctx):
        import torch

        self.ctx, self.children, self.on = ctx, [], ctx.chips > 1
        self.device = torch.device(ctx.device)
        if not self.on:
            return
        from neurosync_trainer_lite_tpu_torch.parallel import distributed

        if ctx.rank == 0:
            ctx.port = _free_port()
            self.children = [subprocess.Popen(
                [sys.executable, str(RUN), "--workload", ctx.cell, "--seed",
                 str(ctx.seed), "--seconds", str(ctx.seconds), "--trace",
                 str(int(ctx.trace)), "--rank", str(r), "--port",
                 str(ctx.port), "--device", ctx.device, "--cell-json",
                 json.dumps({"config": ctx.config, "params": ctx.params,
                             "chips": ctx.chips}),
                 *ctx.child_args],
                stdout=subprocess.DEVNULL) for r in range(1, ctx.chips)]
        cpu = self.device.type == "cpu"
        distributed.initialize_distributed(
            f"127.0.0.1:{ctx.port}", ctx.chips, ctx.rank,
            device="cpu" if cpu else None, timeout_s=900)
        self.device = distributed.rank_device("cpu" if cpu else None)
        self.dist = torch.distributed

    def _backend(self):
        import torch

        return (torch.device("cuda", torch.cuda.current_device())
                if self.dist.get_backend() == "nccl" else
                torch.device("cpu"))

    def rows(self, t):
        """The global batch's rows, gathered in rank order."""
        if not self.on:
            return t
        import torch

        parts = [torch.empty_like(t) for _ in range(self.ctx.chips)]
        self.dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    def reduce(self, value: float, op: str) -> float:
        """value summed ('sum') or maximised ('max') over the ranks."""
        if not self.on:
            return value
        import torch

        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self._backend())
        self.dist.all_reduce(t, getattr(self.dist.ReduceOp, op.upper()))
        return float(t.item())

    def from_rank0(self, value: int) -> int:
        if not self.on:
            return value
        import torch

        t = torch.tensor([int(value)], dtype=torch.int64,
                         device=self._backend())
        self.dist.broadcast(t, 0)
        return int(t.item())

    def leave(self) -> None:
        if self.on:
            from neurosync_trainer_lite_tpu_torch.parallel import distributed

            distributed.destroy()

    def join(self) -> None:
        """Wait for every rank this process started; raise on a failure."""
        codes = [c.wait(timeout=600) for c in self.children]
        if any(codes):
            raise RuntimeError(f"ranks 1..{len(codes)} exited with {codes}")


class _Setup:
    """The training state built from the seed and driven through the
    check's steps, with the loop's views and steps around it."""

    def __init__(self, ctx):
        from neurosync_trainer_lite_tpu_torch.data.windowing import (
            WindowedDataset)
        from neurosync_trainer_lite_tpu_torch.parallel.mesh import make_mesh
        from neurosync_trainer_lite_tpu_torch.training import loop
        from neurosync_trainer_lite_tpu_torch.training import step as step_mod

        p, seed = ctx.params, ctx.seed
        t = now()
        self.ranks = ranks = _Ranks(ctx)
        self.device = device = ranks.device
        self.cfg = cfg = program_config(ctx)
        self.mesh = make_mesh(cfg) if ranks.on else None
        self.d = d = flops.dims(ctx.config)
        clips = inputs.corpus(seed, p["clips"], p["clip_frames"],
                              cfg.input_dim, cfg.output_dim, device)
        ctx.say(f"corpus drawn in {now() - t:.2f} s")
        ds = WindowedDataset(clips, window=cfg.micro_batch_size)
        train_view, val_view = ds.split(cfg.val_split, cfg.seed)
        steps_per_epoch = len(train_view) // cfg.batch_size
        ctx.say(f"{len(ds)} windows split at {now() - t:.2f} s")
        self.state = step_mod.init_train_state(
            cfg, steps_per_epoch, device=device, mesh=self.mesh,
            state_dict=inputs.seeded_weights(d, seed, device))
        total = steps_per_epoch * cfg.n_epochs
        self.eval_step = _Counting(step_mod.make_eval_step(
            cfg, total_steps=total, mesh=self.mesh))
        self.rec = _Recorder(
            step_mod.make_train_step(cfg, total_steps=total, mesh=self.mesh),
            p["check_steps"], lambda: inputs.seeded_weights(d, seed, device),
            ranks.rows)
        self.loop, self.views = loop, (train_view, val_view)
        self.batch_step = 0
        ctx.say(f"training state ready at {now() - t:.2f} s")
        self.epoch(0, p["check_steps"])
        ctx.say(f"check steps done at {now() - t:.2f} s")

    def epoch(self, index: int, steps: int, history=None) -> None:
        """One epoch of the loop, ended after `steps` steps."""
        _, self.batch_step, _ = self.loop.train_one_epoch(
            index, self.state, *self.views,
            self.cfg.replace(max_steps_per_epoch=steps), self.rec,
            self.eval_step, batch_step=self.batch_step, device=self.device,
            mesh=self.mesh, verbose=False, history_out=history)

    def program_readings(self) -> dict:
        rec = self.rec
        return {"batches": rec.batches, "losses": rec.losses, "m1": rec.m1,
                "delta": rec.delta}

    def free(self) -> None:
        """Drop the program's state and leave the process group."""
        import torch

        del self.state, self.eval_step, self.views, self.loop
        self.rec.step = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.ranks.leave()


def readings(ctx, precisions=("fp8",)) -> dict | None:
    """The check's numbers without a window: the program's, and those of
    the reference computed at each of `precisions` in its place (the
    control), each against the float32 reference. Rank 0's; None on the
    others."""
    s = _Setup(ctx)
    prog = s.program_readings()
    s.free()
    if ctx.rank != 0:
        return None
    ref = compare.train_reference(ctx, s.device)
    out = {"program": compare.train_readings(prog, ref)}
    for prec in precisions:
        low = compare.train_reference(ctx, s.device, prec=prec)
        out[prec] = compare.train_readings(low, ref)
    s.ranks.join()
    return out


def run(ctx) -> Outcome | None:
    """The cell's run; on ranks other than 0 their share of it, and None."""
    import torch

    p = ctx.params
    s = _Setup(ctx)
    cfg, d, device = s.cfg, s.d, s.device
    B, T = cfg.batch_size, cfg.micro_batch_size
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
    frames = n * B * T
    model_flops = (frames * flops.train_flops_per_frame(d, T)
                   + s.eval_step.calls * B * T
                   * flops.forward_flops_per_frame(d, T))

    profile, busy_us = None, 0.0
    if ctx.trace:
        _, profile = profiled(lambda: s.epoch(3, p["profile_steps"]))
        busy_us = s.ranks.reduce(profile.busy_us(), "sum") / ctx.chips

    prog = s.program_readings()
    s.free()
    if ctx.rank != 0:
        return None
    checks = compare.train_checks(
        prog, compare.train_reference(ctx, device), ctx.workload["limits"])
    s.ranks.join()
    return Outcome(
        window_start=window_start, window_s=window_s,
        e2e={"train_frames_per_s": frames / window_s,
             "train_peak_mem_gib": window_peak / 2 ** 30},
        attempted=n, failed=failed, checks=checks,
        memory_peak_bytes=max(setup_peak, window_peak), profile=profile,
        extras={"model_flops": model_flops, "window_steps": n,
                "frames": frames, "busy_us": busy_us,
                "k1_bytes": flops.rope_bytes(
                    B // ctx.chips, T, cfg.hidden_dim,
                    2 if cfg.use_amp else 4)})

"""Traffic 'utterances': whole clips sent to the bytes API by one client
in a closed loop, as the Local API behind one Player is called.

Each request is a 16-bit WAV at the configuration's sample rate, sent to
`inference/api.py:generate_facial_data_from_bytes` (the device pipeline:
WAV decode, upload, frontend, chunk gather, one batched forward, download,
host blend). Clip lengths are a fixed ladder: the `rungs` quantiles of a
log-normal with median `median_s` and σ `sigma`, clipped to
[`min_s`, `max_s`], so every seed sends the same mix; the seed draws the
audio of each rung and the order in which the client cycles through them.

Set-up loads the seeded weights and serves every rung once (every shape
the window will use). The window sends requests back to back for about
--seconds and times each from its send to its answer; a request that
raises counts as failed and as missing every limit. With --trace 1,
`profile_requests` more requests run under the profiler. The check reads
a sample of `check_requests` of the window's requests, the first of the
longest clip and a reservoir sample drawn from the seed, kept as the
window runs; after it they are served again by the plain reference.
"""

from __future__ import annotations

import gc

import numpy as np

from benchmark.common import flops, inputs
from benchmark.common.harness import Outcome, now, profiled
from benchmark.reference import compare
from benchmark.reference import serve as ref_serve


def program_config(ctx):
    from neurosync_trainer_lite_tpu_torch.config import Config

    return Config.from_dict(ctx.config).replace(seed=ctx.seed)


class _Setup:
    """The served model, the seeded clips and their order."""

    def __init__(self, ctx):
        import torch

        from neurosync_trainer_lite_tpu_torch.inference import api
        from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq

        p = ctx.params
        self.ctx, self.api = ctx, api
        self.device = device = torch.device(ctx.device)
        self.cfg = cfg = program_config(ctx)
        d = flops.dims(ctx.config)
        model = Seq2Seq(cfg, device)
        model.load_state_dict(inputs.seeded_weights(d, ctx.seed, device),
                              strict=True)
        self.model = model.eval()
        seconds = inputs.ladder(p["rungs"], p["median_s"], p["sigma"],
                                p["min_s"], p["max_s"])
        self.samples = [int(round(s * cfg.sr)) for s in seconds]
        self.wavs = [inputs.wav_bytes(inputs.speech_like(
            ctx.seed, i, n, cfg.sr, device), cfg.sr)
            for i, n in enumerate(self.samples)]
        self.rng = np.random.default_rng(ctx.seed)
        self.queue: list[int] = []
        for i in self.rng.permutation(len(self.wavs)):
            self.serve(int(i))

    def next_rung(self) -> int:
        if not self.queue:
            self.queue = list(self.rng.permutation(len(self.wavs)))
        return int(self.queue.pop())

    def serve(self, rung: int):
        return self.api.generate_facial_data_from_bytes(
            self.wavs[rung], self.model, self.cfg, device=self.device)

    def free(self) -> None:
        import torch

        del self.model, self.api
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _reference(ctx, wavs, device, prec="fp32"):
    """The reference's frames for each WAV, weights drawn from the seed."""
    from benchmark.reference import model as ref_model

    ref_model.plain_precision()
    weights = inputs.seeded_weights(flops.dims(ctx.config), ctx.seed, device)
    return [ref_serve.serve(w, weights, ctx.config, prec=prec, device=device)
            for w in wavs]


def _sample(ctx, rungs: list[int], samples: list[int]) -> list[int]:
    """Request indices to check: the longest request and a seeded draw."""
    k = min(int(ctx.params["check_requests"]), len(rungs))
    longest = max(range(len(rungs)), key=lambda i: samples[rungs[i]])
    rng = np.random.default_rng([ctx.seed, 1])
    others = [int(i) for i in rng.permutation(len(rungs)) if i != longest]
    return [longest] + others[:k - 1]


class _Keep:
    """The answers the check will read, kept as the window runs: the first
    request of the longest clip and a reservoir sample, drawn from the
    seed, of check_requests − 1 others."""

    def __init__(self, ctx, samples: list[int]):
        self.m = int(ctx.params["check_requests"]) - 1
        self.samples, self.rng = samples, np.random.default_rng([ctx.seed, 1])
        self.reservoir: list[int] = []
        self.longest: tuple[int, int] | None = None     # (request, rung)
        self.answers: dict = {}

    def offer(self, i: int, rung: int, answer) -> None:
        self.answers[i] = answer
        if (self.longest is None
                or self.samples[rung] > self.samples[self.longest[1]]):
            self.longest = (i, rung)
        if len(self.reservoir) < self.m:
            self.reservoir.append(i)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.m:
                self.reservoir[j] = i
        live = set(self.picked())
        for k in [k for k in self.answers if k not in live]:
            del self.answers[k]

    def picked(self) -> list[int]:
        first = self.longest[0]
        return [first] + [i for i in self.reservoir if i != first]


def readings(ctx, precisions=("fp8",)) -> dict:
    """The check's numbers without a window: check_requests requests of
    the ladder (drawn from the seed, the longest among them), served by
    the program and by the reference at each of `precisions` in its place,
    each against the float32 reference."""
    s = _Setup(ctx)
    rungs = list(range(len(s.wavs)))
    picked = _sample(ctx, rungs, s.samples)
    wavs = [s.wavs[rungs[i]] for i in picked]
    got = [s.serve(rungs[i]) for i in picked]
    s.free()
    want = _reference(ctx, wavs, s.device)
    limits = ctx.workload["limits"]
    out = {"program": {c.name: c.value for c in compare.serve_checks(
        list(zip(got, want)), limits)}}
    for prec in precisions:
        low = _reference(ctx, wavs, s.device, prec)
        out[prec] = {c.name: c.value for c in compare.serve_checks(
            list(zip(low, want)), limits)}
    return out


def run(ctx) -> Outcome:
    import torch

    p = ctx.params
    s = _Setup(ctx)
    cuda = s.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(s.device)
    setup_peak = torch.cuda.max_memory_allocated(s.device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(s.device)

    keep = _Keep(ctx, s.samples)
    rungs, times = [], []
    failed = 0
    window_start = now()
    while now() - window_start < ctx.seconds:
        rung = s.next_rung()
        t = now()
        try:
            out = s.serve(rung)
        except Exception as e:  # a failed request: missing, every limit
            ctx.say(f"request of rung {rung} failed: {e!r}")
            out, failed = None, failed + 1
        times.append(now() - t if out is not None else float("inf"))
        keep.offer(len(rungs), rung, out)
        rungs.append(rung)
    window_s = now() - window_start
    window_peak = torch.cuda.max_memory_allocated(s.device) if cuda else 0
    ok = [t for t in times if t != float("inf")]

    d = flops.dims(ctx.config)
    chunk_flops = s.cfg.frame_size * flops.forward_flops_per_frame(
        d, s.cfg.frame_size)
    served_flops = sum(ref_serve.chunk_count(s.samples[r], ctx.config)
                       for r, t in zip(rungs, times) if t != float("inf")
                       ) * chunk_flops

    profile = None
    if ctx.trace:
        def stretch():
            for _ in range(int(p["profile_requests"])):
                s.serve(s.next_rung())
        _, profile = profiled(stretch)

    wavs = [s.wavs[rungs[i]] for i in keep.picked()]
    got = [keep.answers[i] for i in keep.picked()]
    samples = s.samples
    s.free()
    ok_ms = sorted(1e3 * t for t in ok)
    if ok_ms:
        ctx.say(f"{len(times)} requests, ms p50 {np.percentile(ok_ms, 50):.3f}"
                f" p95 {np.percentile(ok_ms, 95):.3f} max {ok_ms[-1]:.3f}")
    want = _reference(ctx, wavs, s.device)
    checks = compare.serve_checks(list(zip(got, want)), ctx.workload["limits"])
    return Outcome(
        window_start=window_start, window_s=window_s,
        e2e={"request_p95_ms": 1e3 * float(np.percentile(times, 95))},
        attempted=len(times), failed=failed, checks=checks,
        memory_peak_bytes=max(setup_peak, window_peak), profile=profile,
        extras={"served_flops": served_flops, "request_s": sum(ok),
                "requests": len(times),
                "audio_s": sum(samples[r] for r in rungs) / s.cfg.sr})

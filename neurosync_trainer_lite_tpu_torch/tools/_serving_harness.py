"""Shared harness for the serving probes (serving_knee, serving_soak): the
port's copy of the repo root's tools/_serving_harness.py, less what only
its serving_trace used.

One copy of the preamble (Config, seeded weights, MultiStreamer, forced
warmup, session priming) and of the decode-tick hunt, so that a change to
MultiStreamer's tick or priming semantics is made once and the probes keep
measuring the same thing.

Probe-only code: nothing in the package imports this.
"""

from __future__ import annotations

import time

import numpy as np

_UNSET = object()


def build_streamer(*, max_sessions: int, fused: bool,
                   stall_watchdog_s=_UNSET, decode_bucket_cap=_UNSET,
                   push_seconds=_UNSET, device=None, tiny: bool = False):
    """Config (tiny_config with tiny) → seeded random weights on `device`
    (the CUDA card by default) → MultiStreamer → forced warmup. Returns
    (ms, cfg, n_warmed_runs).

    stall_watchdog_s: leave unset to take MultiStreamer's production
    default (what soak wants); knee passes None so that a stall is
    MEASURED, not auto-recovered. The JAX harness's dropout, warm_fallback,
    verbose and push_formats served its serving_trace tool, which is not
    ported."""
    import torch

    from neurosync_trainer_lite_tpu_torch.config import Config, tiny_config
    from neurosync_trainer_lite_tpu_torch.inference.multi_stream import (
        MultiStreamer,
    )
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq
    from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = (tiny_config if tiny else Config)(dropout=0.0)
    model = init_seq2seq(cfg, torch.Generator(device).manual_seed(0),
                         device=device).eval()
    kw = {}
    if stall_watchdog_s is not _UNSET:
        kw["stall_watchdog_s"] = stall_watchdog_s
    if decode_bucket_cap is not _UNSET:
        kw["decode_bucket_cap"] = decode_bucket_cap
    if push_seconds is not _UNSET:
        kw["push_seconds"] = push_seconds
    ms = MultiStreamer(model, cfg, max_sessions=max_sessions,
                       fused_decode=fused, device=device, **kw)
    t0 = time.perf_counter()
    n_prog = ms.warmup()
    print(f"warmup: {n_prog} programs in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return ms, cfg, n_prog


def window_stride_s(cfg) -> float:
    """Seconds of audio per decode window step (≈1.87 s at the defaults)."""
    return (cfg.frame_size - cfg.overlap) / cfg.frame_rate


def push_noise(ms, sid, rng, n_samples: int) -> None:
    """Push n_samples of int16 noise (random data: all-zero audio NaNs
    downstream consumers and real captures never look like silence)."""
    ms.push_audio(sid, (rng.standard_normal(n_samples) * 8000
                        ).astype(np.int16))


def prime_sessions(ms, cfg, k: int, rng, *, seconds: float = 2.2) -> list:
    """Open k sessions, push each ring past its first window, and drain all
    catch-up ticks, so the caller's subsequent ticks are pure intake until
    it deliberately tops a window up. Returns the session ids."""
    sids = [ms.open() for _ in range(k)]
    for sid in sids:
        push_noise(ms, sid, rng, int(cfg.sr * seconds))
    while ms.tick():
        pass
    return sids


def hunt_decode_tick(ms, sids, rng, cfg, *, top_samples: int,
                     max_ticks: int = 8, top_sids=None):
    """Top sessions up past their next ready window, then tick until the
    tick that actually decodes (yields frames). Returns (dt_seconds,
    n_frames) for that decode tick (its one download synchronises it with
    the card), then drains catch-up ticks so repeated calls stay comparable.

    top_sids: which sessions to top up (default: all of sids); topping a
    subset measures the live-realistic decode tick where only ~K/8
    sessions have a window ready while the rest are mid-window."""
    for sid in (sids if top_sids is None else top_sids):
        push_noise(ms, sid, rng, top_samples)
    for _ in range(max_ticks):
        t1 = time.perf_counter()
        out = ms.tick()
        dt = time.perf_counter() - t1
        frames = sum(out.values())
        if frames > 0:
            while ms.tick():  # drain catch-up
                pass
            return dt, frames
    raise RuntimeError(f"no decode tick within {max_ticks} ticks")

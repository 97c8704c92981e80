"""Measure the NON-device cost of a MultiStreamer tick on the in-process CPU
(the port's counterpart of the repo root's tools/local_dispatch_probe.py).

A serving capacity model needs its host-orchestration term anchored by
measurement, not subtraction: this probe runs the REAL MultiStreamer tick
loop on the CPU with a tiny model, so program compute and transfer are
small and timed apart, and the rest of the tick's wall time IS the per-tick
host cost (Python session bookkeeping, ring-shadow memcpys, argument
staging, eager op dispatch) that a deployment pays on top of the card's
work. The JAX probe forces jax_platforms=cpu; this one, as every entry
point of the port, runs on the CUDA card unless --device names another
device, so its CPU measurement is `--device cpu`. Without a card and
without --device it raises.

Also reports the bare eager-dispatch floor (one trivial op) to split
"session bookkeeping" from "PyTorch dispatch" at each K.

Usage:
  python -m neurosync_trainer_lite_tpu_torch.tools.local_dispatch_probe
      [--sessions 8 32] [--ticks 300] --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bare_dispatch_us(device: torch.device, n: int = 2000) -> float:
    """Median wall time of a minimal eager op (launch and, on a card, its
    completion) on this host."""
    x = torch.zeros(8, device=device)
    _sync(device)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        x + 1.0
        _sync(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e6)


def tick_cost(k: int, ticks: int, push_s: float,
              device: torch.device) -> dict:
    from neurosync_trainer_lite_tpu_torch.config import tiny_config
    from neurosync_trainer_lite_tpu_torch.inference import multi_stream as M
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq

    cfg = tiny_config(hidden_dim=32, n_layers=1, num_heads=2)
    model = init_seq2seq(cfg, torch.Generator(device).manual_seed(0),
                         device=device).eval()
    ms = M.MultiStreamer(model, cfg, max_sessions=k, max_buffer_seconds=8.0,
                         push_seconds=push_s, push_formats=("f32",),
                         device=device)
    # full warmup: the host-term measurement must not include first uses
    ms.warmup(serve_buckets=None)
    sids = [ms.open() for _ in range(k)]
    rng = np.random.default_rng(0)
    chunk_n = int(cfg.sr * push_s)

    # Wrap the tick programs so the time INSIDE them (waited for on a card)
    # is attributed separately: on the CPU the frontend/decode math runs on
    # the SAME cores, so a raw tick wall time would conflate the program's
    # compute with the host orchestration the capacity model needs.
    # host = wall − program.
    prog_t = [0.0]

    def wrap(fn):
        def w(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            _sync(device)
            prog_t[0] += time.perf_counter() - t0
            return r
        return w

    orig = (M._tick_fused, M._tick_ring_only, M._tick_program)
    M._tick_fused = wrap(M._tick_fused)
    M._tick_ring_only = wrap(M._tick_ring_only)
    M._tick_program = wrap(M._tick_program)
    try:
        for _ in range(8):  # settle the steady-state backlog pattern
            for sid in sids:
                ms.push_audio(sid, (rng.standard_normal(chunk_n) * 0.2)
                              .astype(np.float32))
            ms.tick()
            for sid in sids:
                ms.pop_frames(sid)

        intake, decode, dec_prog = [], [], []
        for _ in range(ticks):
            for sid in sids:
                ms.push_audio(sid, (rng.standard_normal(chunk_n) * 0.2)
                              .astype(np.float32))
            prog_t[0] = 0.0
            t0 = time.perf_counter()
            out = ms.tick()
            host = time.perf_counter() - t0 - prog_t[0]
            # decode ticks finalize ≥1 frame; intake-only ticks just ingest:
            # the two run different programs and the capacity model uses
            # separate host terms for them
            if any(out.values()):
                decode.append(host)
                dec_prog.append(prog_t[0])
            else:
                intake.append(host)
            for sid in sids:
                ms.pop_frames(sid)
    finally:
        M._tick_fused, M._tick_ring_only, M._tick_program = orig

    def pct(xs, q):
        return round(float(np.percentile(np.array(xs) * 1e3, q)), 2)

    return {"k": k, "ticks": ticks,
            "intake_ticks": len(intake), "decode_ticks": len(decode),
            "intake_host_ms_p50": pct(intake, 50) if intake else None,
            "intake_host_ms_p95": pct(intake, 95) if intake else None,
            "decode_host_ms_p50": pct(decode, 50) if decode else None,
            "decode_host_ms_p95": pct(decode, 95) if decode else None,
            "decode_cpu_prog_ms_p50": pct(dec_prog, 50) if dec_prog else None}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--push_s", type=float, default=0.5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "without one). The JAX probe's CPU backend is "
                         "--device cpu")
    args = ap.parse_args(argv)

    from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    print(f"backend: {device.type}")
    print(f"bare eager dispatch: {bare_dispatch_us(device):.0f} us median")
    for k in args.sessions:
        r = tick_cost(k, args.ticks, args.push_s, device)
        print(r, flush=True)


if __name__ == "__main__":
    main()

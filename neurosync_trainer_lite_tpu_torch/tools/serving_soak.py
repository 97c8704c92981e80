"""Serving soak: N unpaced MultiStreamer ticks with session churn on the
card; prints latency percentiles and a JSON summary line (the port's
counterpart of the repo root's tools/serving_soak.py).

Makes ≥500-tick runs restartable and comparable. Each live session pushes
0.5 s of int16 audio a tick; sessions churn (one closed, one opened) every
`--churn` ticks, and each closed session's frames are printed. The stall
watchdog (inference/multi_stream.py: a fused tick slower than its budget
flips the streamer to the two-dispatch family) is left at its production
default unless --watchdog overrides it, so a run also shows the fallback
on a real stall.

The JAX tool's --pressure and --pressure-every fill XLA's executable cache
to provoke an eviction and recompile; eager PyTorch has no such cache, so
they are not ported. The record keeps their keys, at 0 and None.

Usage: python -m neurosync_trainer_lite_tpu_torch.tools.serving_soak NAME
           --ticks 500 [--fused 0|1] [--sessions 4] [--churn 60]
           [--watchdog SECONDS|-] [--device cpu] [--tiny]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("name")
    p.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "serving_soak_results.jsonl"))
    p.add_argument("--ticks", type=int, default=500)
    p.add_argument("--fused", type=int, default=1)
    p.add_argument("--sessions", type=int, default=4)
    p.add_argument("--max-sessions", type=int, default=8)
    p.add_argument("--churn", type=int, default=60,
                   help="close one + open one session every N ticks")
    p.add_argument("--push-seconds", type=float, default=0.5)
    p.add_argument("--dcap", type=int, default=-1,
                   help="decode_bucket_cap (-1 = production 'auto' default; "
                        "0 = None, i.e. decode every ready row at once)")
    p.add_argument("--watchdog", default=None,
                   help="stall watchdog seconds; '-' disables; default: "
                        "production default (30)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--tiny", action="store_true",
                   help="config.tiny_config's model (CPU smoke runs)")
    args = p.parse_args(argv)

    import numpy as np

    from neurosync_trainer_lite_tpu_torch.tools._serving_harness import (
        build_streamer,
    )

    kw = {}
    if args.watchdog == "-":
        kw["stall_watchdog_s"] = None
    elif args.watchdog is not None:
        kw["stall_watchdog_s"] = float(args.watchdog)
    if args.dcap != -1:
        kw["decode_bucket_cap"] = args.dcap or None
    ms, cfg, _ = build_streamer(max_sessions=args.max_sessions,
                                fused=bool(args.fused), device=args.device,
                                tiny=args.tiny, **kw)

    rng = np.random.default_rng(0)
    push = int(cfg.sr * args.push_seconds)

    def audio():
        return (rng.standard_normal(push) * 8000).astype(np.int16)

    def close(sid):
        # flush() returns the tail frames it finalized (its internal ticks
        # are not seen by the loop below): count them
        frames[sid] = frames.get(sid, 0) + ms.flush(sid)
        ms.pop_frames(sid)
        ms.close(sid)
        print(f"session {sid} closed after {frames[sid]} frames", flush=True)

    sids = [ms.open() for _ in range(args.sessions)]
    frames = {sid: 0 for sid in sids}
    lat = []
    flipped_at = None
    for t in range(args.ticks):
        if args.churn and t and t % args.churn == 0:
            close(sids.pop(0))
            sids.append(ms.open())
            frames.setdefault(sids[-1], 0)
        for sid in sids:
            ms.push_audio(sid, audio())
        t1 = time.perf_counter()
        out = ms.tick()
        dt = time.perf_counter() - t1
        lat.append(dt)
        for sid, n in out.items():
            frames[sid] = frames.get(sid, 0) + n
        if dt > 5.0:
            print(f"tick {t}: SLOW {dt:.1f} s", flush=True)
        if flipped_at is None and bool(args.fused) and not ms.fused:
            flipped_at = t
            print(f"watchdog flipped to two-dispatch at tick {t} "
                  f"({dt:.1f} s tick)", flush=True)
        if t % 100 == 0:
            print(f"tick {t}: {dt * 1e3:.0f} ms, "
                  f"{sum(frames.values())} frames total", flush=True)
    live_frames = int(sum(frames.values()))  # delivered during ticks:
    # the liveness signal. A decode cap too small for the session count
    # shows up as a growing backlog that only drains in the final flush
    for sid in sids:
        close(sid)

    ms_lat = np.asarray(lat) * 1e3
    rec = {
        "name": args.name, "ticks": args.ticks, "fused": bool(args.fused),
        "sessions": args.sessions, "churn": args.churn,
        "dcap": ms.decode_bucket_cap,
        "p50_ms": round(float(np.percentile(ms_lat, 50)), 1),
        "p95_ms": round(float(np.percentile(ms_lat, 95)), 1),
        "p99_ms": round(float(np.percentile(ms_lat, 99)), 1),
        "max_ms": round(float(ms_lat.max()), 1),
        "stalls_over_30s": int((ms_lat > 30_000).sum()),
        "slow_over_5s": int((ms_lat > 5_000).sum()),
        # the JAX tool's compile-pressure probe, not applicable here
        "pressure": 0, "pressure_every": None,
        "watchdog_flip_tick": flipped_at,
        "total_frames": int(sum(frames.values())),
        "live_frames": live_frames,
    }
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving capacity-knee probe: where does per-tick cost come from as K
grows, intake (upload, ring update, launches) or decode (the batched
228M forward)? The port's counterpart of the repo root's
tools/serving_knee.py.

For a given session count K it measures, separately:
- intake-only ticks (0.25 s pushes, no window ready): upload + ring update
- decode ticks (every session primed with exactly one ready window):
  frontend + cross-session batched decode (+ the feature download in
  two-dispatch mode, --fused 0)

Each is reported as median/p95 over --reps repetitions, one K a process.
A decode tick's wall time includes its one download, which waits for the
card; a fused intake-only tick downloads nothing (as in JAX, whose dispatch
is asynchronous too), so its wall time is the host's part and its device
work lands in the next tick that waits.

Usage: python -m neurosync_trainer_lite_tpu_torch.tools.serving_knee NAME
           --k 12 [--fused 0|1] [--reps 20] [--device cpu] [--tiny]
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
        tempfile.gettempdir(), "serving_knee_results.jsonl"))
    p.add_argument("--k", type=int, default=12)
    p.add_argument("--fused", type=int, default=0)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--ready", type=int, default=0,
                   help="sessions topped up per decode tick (0 = all K). "
                   "Live cadence readies only ~K/8 per tick; the sparse "
                   "fused decode gathers just those rows")
    p.add_argument("--dcap", type=int, default=-1,
                   help="decode_bucket_cap (-1 = production 'auto' default; "
                   "0 = None, i.e. decode every ready row at once)")
    p.add_argument("--push_s", type=float, default=0.0,
                   help="push_seconds intake width (0 = default ≈1.5 s)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--tiny", action="store_true",
                   help="config.tiny_config's model (CPU smoke runs)")
    args = p.parse_args(argv)

    import numpy as np

    from neurosync_trainer_lite_tpu_torch.tools._serving_harness import (
        build_streamer,
        hunt_decode_tick,
        prime_sessions,
        push_noise,
        window_stride_s,
    )

    # watchdog off: a stall here must be MEASURED, not auto-recovered.
    # --dcap -1 leaves decode_bucket_cap unset so probes measure the
    # PRODUCTION default ('auto'); the JSONL records the resolved cap
    # from the streamer itself, never a re-derived copy.
    kw = {}
    if args.dcap != -1:
        kw["decode_bucket_cap"] = args.dcap or None
    ms, cfg, _ = build_streamer(
        max_sessions=args.k, fused=bool(args.fused), stall_watchdog_s=None,
        push_seconds=args.push_s or None, device=args.device, tiny=args.tiny,
        **kw)

    rng = np.random.default_rng(0)
    # prime each ring past the first window so intake ticks are pure intake
    sids = prime_sessions(ms, cfg, args.k, rng)

    intake, decode, frames_per = [], [], []
    small = int(cfg.sr * 0.25)
    for rep in range(args.reps):
        # intake-only tick: push 0.25 s (< a window stride) everywhere
        for sid in sids:
            push_noise(ms, sid, rng, small)
        t1 = time.perf_counter()
        ms.tick()
        intake.append(time.perf_counter() - t1)
        # now top sessions up past the next ready window; measure the tick
        # that actually decodes (the first one yielding frames). --ready
        # rotates which subset gets topped so no session starves.
        top = int(cfg.sr * (window_stride_s(cfg) + 0.3)) - small
        top_sids = None
        if args.ready:
            at = (rep * args.ready) % len(sids)
            top_sids = [sids[(at + j) % len(sids)]
                        for j in range(args.ready)]
        dt, frames = hunt_decode_tick(ms, sids, rng, cfg, top_samples=top,
                                      top_sids=top_sids)
        decode.append(dt)
        frames_per.append(frames)

    for sid in sids:
        ms.flush(sid)
        ms.close(sid)

    im = np.asarray(intake) * 1e3
    dm = np.asarray(decode) * 1e3
    rec = {"name": args.name, "k": args.k, "fused": bool(args.fused),
           "ready": args.ready or args.k,
           "dcap": ms.decode_bucket_cap,
           "push_s": args.push_s or None,
           "intake_p50_ms": round(float(np.percentile(im, 50)), 1),
           "intake_p95_ms": round(float(np.percentile(im, 95)), 1),
           "decode_p50_ms": round(float(np.percentile(dm, 50)), 1),
           "decode_p95_ms": round(float(np.percentile(dm, 95)), 1),
           "frames_per_decode_tick": round(float(np.mean(frames_per)), 1)}
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())

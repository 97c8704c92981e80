"""Measure cold serving warmup: time-to-serve, then a churn soak (the port's
counterpart of the repo root's tools/warmup_probe.py).

One fresh process measures:

  1. warmup(background_fallback=True, serve_buckets=...): wall time until
     it returns is the TIME-TO-SERVE. Eager PyTorch compiles nothing, so
     the port's warmup has nothing to defer: both options are accepted as
     documented (inference/multi_stream.py, MultiStreamer.warmup) and every
     tick family, the two-dispatch fallback included, runs once before it
     returns. What it pays is the CUDA kernels' load (their nvcc build
     when build/torch_kernels/ holds none for these sources) and each
     tick's cuBLAS and allocator first use.
  2. a churn soak (sessions opening and closing under live pushes): a tick
     that pays a first use shows up as a slow tick;
  3. wait_background_warmup(): returns at once (nothing runs in the
     background), so the total equals time-to-serve plus the soak.

Usage:
  python -m neurosync_trainer_lite_tpu_torch.tools.warmup_probe
      [--sessions 32] [--format s16] [--soak-ticks 150] [--live 4]
      [--device cpu] [--tiny]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=32)
    ap.add_argument("--serve-buckets", type=int, default=None,
                    help="progressive warmup: eager rungs ≤ bucket(N) "
                         "(accepted; the port warms every rung)")
    ap.add_argument("--format", default="s16", choices=("s16", "f32", "both"))
    ap.add_argument("--soak-ticks", type=int, default=150)
    ap.add_argument("--live", type=int, default=4,
                    help="live sessions during the churn soak")
    ap.add_argument("--churn-every", type=int, default=30,
                    help="close+reopen one session every N ticks")
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "warmup_probe_results.jsonl"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--tiny", action="store_true",
                    help="config.tiny_config's model (CPU smoke runs)")
    args = ap.parse_args(argv)

    import torch

    from neurosync_trainer_lite_tpu_torch.config import full_config, tiny_config
    from neurosync_trainer_lite_tpu_torch.inference.multi_stream import (
        MultiStreamer,
    )
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq
    from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = (tiny_config if args.tiny else full_config)()
    model = init_seq2seq(cfg, torch.Generator(device).manual_seed(0),
                         device=device).eval()
    fmts = ("f32", "s16") if args.format == "both" else (args.format,)
    ms = MultiStreamer(model, cfg, max_sessions=args.sessions,
                       push_formats=fmts, device=device)

    print(f"cold warmup: max_sessions={args.sessions} formats={fmts} "
          f"decode_cap={ms.decode_bucket_cap} (background fallback"
          + (f", serve_buckets={args.serve_buckets}" if args.serve_buckets
             else "") + ")", flush=True)
    t0 = time.time()
    n_fused = ms.warmup(background_fallback=True,
                        serve_buckets=args.serve_buckets)
    tts = time.time() - t0
    print(f"time-to-serve ({n_fused} eager programs): {tts:.1f} s",
          flush=True)

    # churn soak
    rng = np.random.default_rng(0)
    chunk = int(cfg.sr * 0.5)
    sids = [ms.open() for _ in range(args.live)]
    walls = []
    for t in range(args.soak_ticks):
        if t and t % args.churn_every == 0:
            ms.close(sids.pop(0))
            sids.append(ms.open())
        for sid in sids:
            pcm = (rng.standard_normal(chunk) * 0.2 * 32767).astype(np.int16)
            ms.push_audio(sid, pcm)
        w0 = time.perf_counter()
        ms.tick()
        walls.append(time.perf_counter() - w0)
        for sid in sids:
            ms.pop_frames(sid)
    w = np.array(walls) * 1e3
    soak = {"p50": round(float(np.percentile(w, 50)), 1),
            "p95": round(float(np.percentile(w, 95)), 1),
            "max": round(float(w.max()), 1)}
    print(f"churn soak during background warmup: {soak}", flush=True)

    bg_done = ms.wait_background_warmup(timeout=3600.0)
    total = time.time() - t0
    print(f"fully warmed (fallback family too): {total:.1f} s "
          f"(bg completed: {bg_done})", flush=True)

    rec = {"sessions": args.sessions, "serve_buckets": args.serve_buckets,
           "formats": list(fmts),
           "n_fused_programs": n_fused, "time_to_serve_s": round(tts, 1),
           "total_warm_s": round(total, 1), "soak_tick_ms": soak,
           "bg_completed": bg_done}
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())

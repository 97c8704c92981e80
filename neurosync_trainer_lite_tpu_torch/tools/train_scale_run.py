"""Drive the port's REAL trainer over a dataset at the reference's
advertised scale (the port's counterpart of the repo root's
tools/train_scale_run.py).

data_scale_probe validates ingest→window→gather host-side at the
"8 voices × 30 min" scenario; this tool runs the UNMODIFIED production loop
(training/loop.py:train_model: the auto-remat planner, interleaved
validation, checkpoints, the model.pth export, fixed-wav validation) over
such a dataset, bounded by Config.max_steps_per_epoch:

  - ingest is timed separately (the same load_data call train_model makes)
  - --epochs bounded epochs: the boundaries exercise the real epoch
    machinery at scale (checkpoint writes, the reshuffle of the train view,
    prefetch teardown and restart)
  - a sampler thread records RSS every --rss-interval seconds for the whole
    run (leak detection at scale)

Usage:
  python -m neurosync_trainer_lite_tpu_torch.tools.data_scale_probe --generate DIR
  python -m neurosync_trainer_lite_tpu_torch.tools.train_scale_run --root DIR --steps 250 [--device cpu] [--tiny]

Ends with one line "SUMMARY {json}" (phase timings, the losses, the RSS
series) and leaves artifacts under --out. Run it from the repo root: the
fixed-wav validation reads dataset/test_set.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time


def _current_rss_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1e6
    return 0.0


class RssSampler(threading.Thread):
    def __init__(self, interval: float):
        super().__init__(daemon=True)
        self.interval = interval
        self.samples: list[tuple[float, float]] = []
        self._stop = threading.Event()
        self._t0 = time.perf_counter()

    def run(self):
        while not self._stop.is_set():
            self.samples.append((round(time.perf_counter() - self._t0, 1),
                                 round(_current_rss_gb(), 2)))
            self._stop.wait(self.interval)

    def stop(self):
        self._stop.set()


def main(argv=None) -> int:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True,
                    help="dataset dir (data_scale_probe --generate)")
    ap.add_argument("--steps", type=int, default=250,
                    help="optimizer steps per bounded epoch")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(tmp, "scale_train_run"))
    ap.add_argument("--rss-interval", type=float, default=5.0)
    ap.add_argument("--summary-out",
                    default=os.path.join(tmp, "train_scale_summary.json"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "without one)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny 4-layer model (CPU smoke of the tool; the "
                         "scale measurement uses the flagship default)")
    args = ap.parse_args(argv)

    from neurosync_trainer_lite_tpu_torch.config import full_config, tiny_config
    from neurosync_trainer_lite_tpu_torch.data.processing import load_data
    from neurosync_trainer_lite_tpu_torch.training.loop import train_model
    from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    base = tiny_config if args.tiny else full_config
    cfg = base(
        root_dir=args.root,
        n_epochs=args.epochs,
        max_steps_per_epoch=args.steps,
        checkpoint_path=os.path.join(args.out, "checkpoints/checkpoint"),
        model_path=os.path.join(args.out, "model.pth"),
        plots_dir=os.path.join(args.out, "plots"),
        # the committed golden pair drives the per-epoch fixed-wav validation
        audio_path="dataset/test_set/audio.wav",
        ground_truth_path="dataset/test_set/testset.csv",
    )

    sampler = RssSampler(args.rss_interval)
    sampler.start()
    summary: dict = {"steps_per_bounded_epoch": args.steps,
                     "epochs": args.epochs}

    t0 = time.perf_counter()
    # what train_model would call
    clips = load_data(cfg.root_dir, cfg.sr, ffmpeg_path=cfg.ffmpeg_path,
                      device=device)
    summary["ingest_s"] = round(time.perf_counter() - t0, 1)
    summary["clips"] = len(clips)
    summary["frames"] = int(sum(len(a) for a, _ in clips))
    summary["rss_after_ingest_gb"] = round(_current_rss_gb(), 2)
    print(f"ingest: {summary['clips']} clips / {summary['frames']:,} frames "
          f"in {summary['ingest_s']}s — RSS "
          f"{summary['rss_after_ingest_gb']} GB", flush=True)

    # the epochs are timed by train_one_epoch's own prints (samples/s per
    # epoch) and visible in the RSS series; the whole call is timed here
    history: dict = {}
    t0 = time.perf_counter()
    state, batch_step = train_model(cfg, clips, history_out=history,
                                    device=device)
    summary["train_model_s"] = round(time.perf_counter() - t0, 1)
    summary["optimizer_steps"] = int(batch_step)
    summary["final_train_loss"] = round(history["train_losses"][-1], 5)
    first5 = history["train_losses"][:5]
    last5 = history["train_losses"][-5:]
    summary["loss_first5_mean"] = round(sum(first5) / len(first5), 5)
    summary["loss_last5_mean"] = round(sum(last5) / len(last5), 5)
    nan_steps = sum(1 for x in history["train_losses"] if x != x)
    summary["nan_steps"] = nan_steps

    sampler.stop()
    summary["rss_peak_gb"] = max(r for _, r in sampler.samples)
    summary["rss_final_gb"] = sampler.samples[-1][1]
    # thin the series for the log: keep ~60 points
    step = max(1, len(sampler.samples) // 60)
    summary["rss_series"] = sampler.samples[::step]

    ckpt_dir = os.path.dirname(cfg.checkpoint_path)
    summary["checkpoint_entries"] = sorted(os.listdir(ckpt_dir)) \
        if os.path.isdir(ckpt_dir) else []
    summary["model_pth_mb"] = round(
        os.path.getsize(cfg.model_path) / 1e6, 1) \
        if os.path.exists(cfg.model_path) else None

    print("SUMMARY " + json.dumps(summary), flush=True)
    with open(args.summary_out, "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

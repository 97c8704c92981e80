"""Data path at reference scale: 8 voices × 30 min of capture (the port's
counterpart of the repo root's tools/data_scale_probe.py).

Validates the windowing-memory and gather-throughput behaviour at the
reference's advertised scale, the "8 voices × 30 min ⇒ 256 GB host RAM"
scenario of the reference's README, through the port's REAL ingest path
(load_data cache-hit → collect_features fast-augment + blend →
WindowedDataset → native gather), measuring:

  - ingest wall time (the feature-cache CSV reads + augmentation)
  - peak RSS through ingest, window-table build, and full epoch sweeps of
    batch gathers
  - window-table size (the reference materializes every stride-1 window
    instead: ~128x the clip bytes)
  - gather throughput at the FULL table size
  - epoch-start latency (process start → first training batch ready)

--generate writes the same files as the JAX tool, byte for byte: the
feature caches as pandas' to_csv(index=False, float_format="%.6f") writes
them, and the LiveLink facial CSVs through utils/csv_io.py. Feature values
are synthetic (random); the behaviour under test depends on shapes, not
values, and cache-hit ingest never runs the frontend. --measure reads them
with the port's load_data; --device is where a cache miss would run the
frontend (default: the CUDA card; raises without one).

Usage:
  python -m neurosync_trainer_lite_tpu_torch.tools.data_scale_probe --generate DIR [--voices 8] [--minutes 30]
  python -m neurosync_trainer_lite_tpu_torch.tools.data_scale_probe --measure DIR [--epochs 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time

import numpy as np


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def write_feature_csv(path: str, feats: np.ndarray) -> None:
    """[T, dim] features → CSV as pandas' DataFrame(feats).to_csv(path,
    index=False, float_format="%.6f") writes it: header 0..dim-1, no index
    column, every value "%.6f"."""
    header = ",".join(str(i) for i in range(feats.shape[1]))
    np.savetxt(path, feats, fmt="%.6f", delimiter=",", header=header,
               comments="")


def generate(root: str, voices: int, minutes: int) -> None:
    from neurosync_trainer_lite_tpu_torch.utils.csv_io import (
        save_generated_data_as_csv,
    )

    frames = int(minutes * 60 * 60)  # 60 fps
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for v in range(voices):
        folder = os.path.join(root, f"voice_{v:02d}")
        os.makedirs(folder, exist_ok=True)
        t0 = time.perf_counter()
        feats = rng.standard_normal((frames, 256)).astype(np.float32)
        write_feature_csv(os.path.join(folder, "audio_features.csv"), feats)
        facial = rng.uniform(0, 1, (frames, 61)).astype(np.float32)
        save_generated_data_as_csv(
            facial, os.path.join(folder, f"voice{v}_iPhone_cal.csv"))
        print(f"{folder}: {frames} frames ({minutes} min) written in "
              f"{time.perf_counter() - t0:.0f}s", flush=True)
    total = sum(os.path.getsize(os.path.join(dp, f))
                for dp, _, fs in os.walk(root) for f in fs)
    print(f"dataset on disk: {total / 1e9:.2f} GB across {voices} folders")


def measure(root: str, epochs: int, batch_size: int = 128,
            device=None) -> None:
    from neurosync_trainer_lite_tpu_torch.data.processing import load_data
    from neurosync_trainer_lite_tpu_torch.data.windowing import (
        WindowedDataset,
        prefetch,
    )
    from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    proc_start = time.perf_counter()
    print(f"RSS at start: {rss_gb():.2f} GB")

    t0 = time.perf_counter()
    # cache-hit path: CSV reads + augment
    clips = load_data(root, 88200, device=device)
    t_ingest = time.perf_counter() - t0
    clip_bytes = sum(a.nbytes + f.nbytes for a, f in clips)
    print(f"ingest: {len(clips)} clips, "
          f"{sum(len(a) for a, _ in clips)} augmented frames, "
          f"{clip_bytes / 1e9:.2f} GB of clip arrays (as loaded) "
          f"in {t_ingest:.1f}s — RSS {rss_gb():.2f} GB", flush=True)

    t0 = time.perf_counter()
    ds = WindowedDataset(clips, window=128)
    t_table = time.perf_counter() - t0
    ds_bytes = (sum(a.nbytes for a in ds.audio)
                + sum(f.nbytes for f in ds.facial))
    print(f"window table: {len(ds):,} stride-1 windows in an "
          f"{ds.table.nbytes / 1e6:.1f} MB index table over "
          f"{ds_bytes / 1e9:.2f} GB of float32 clips, built in "
          f"{t_table:.1f}s — RSS {rss_gb():.2f} GB")
    win_bytes = len(ds) * 128 * (256 + 61) * 4
    print(f"  (materialized, reference-style, the same windows would be "
          f"{win_bytes / 1e9:.0f} GB)")
    # the original (float64) clip list stays alive through training in the
    # real loop too (train_model holds it); count it in the honest peak
    train, val = ds.split(0.1, 0)

    # epoch-start latency: first shuffled batch assembled + ready
    t0 = time.perf_counter()
    it = prefetch(train.batches(batch_size, shuffle=True, seed=0,
                                drop_last=True))
    src, trg = next(it)
    print(f"epoch-start latency (first training batch ready): "
          f"{time.perf_counter() - t0:.2f}s "
          f"(process start → first batch: "
          f"{time.perf_counter() - proc_start:.1f}s)")

    batch_gb = (src.nbytes + trg.nbytes) / 1e9
    for ep in range(epochs):
        n = 1 if ep == 0 else 0  # first batch already drawn in epoch 0
        t0 = time.perf_counter()
        for src, trg in it:
            n += 1
        dt = time.perf_counter() - t0
        print(f"epoch {ep + 1}: {n:,} batches of {batch_size} gathered in "
              f"{dt:.1f}s — {n * batch_gb / dt:.1f} GB/s, "
              f"{n * batch_size / dt:,.0f} windows/s — "
              f"RSS {rss_gb():.2f} GB", flush=True)
        if ep + 1 < epochs:
            it = prefetch(train.batches(batch_size, shuffle=True, seed=ep + 1,
                                        drop_last=True))

    print(f"peak RSS: {rss_gb():.2f} GB "
          f"(reference guidance for this dataset: 128-256 GB)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--generate", metavar="DIR")
    ap.add_argument("--measure", metavar="DIR")
    ap.add_argument("--voices", type=int, default=8)
    ap.add_argument("--minutes", type=int, default=30)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="where --measure's ingest runs the frontend on a "
                         "feature-cache miss (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.generate:
        generate(args.generate, args.voices, args.minutes)
    elif args.measure:
        measure(args.measure, args.epochs, device=args.device)
    else:
        ap.error("pass --generate DIR or --measure DIR")
    return 0


if __name__ == "__main__":
    sys.exit(main())

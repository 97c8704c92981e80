"""Offline inference CLI: audio file → LiveLink blendshape CSV, in PyTorch.

    python -m neurosync_trainer_lite_tpu_torch.infer --wav speech.wav \
        --model out/model.pth --out shapes.csv \
        [--ground-truth truth.csv --stats stats.txt] [--smooth] [--device cpu]

Runs on the CUDA card unless --device cpu is given. --model takes a
reference-format model.pth or one of this package's training checkpoint
directories (the JAX package's Orbax directories are not readable here).
The model geometry flags (--hidden_dim, --n_layers, ...) must match the
checkpoint; --tiny starts from the tiny geometry. --ground-truth writes the
comparison statistics against a LiveLink CSV (to --stats, by default
<out>_stats.txt).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from neurosync_trainer_lite_tpu_torch.config import Config, tiny_config

_FLAG_TYPES = {"bool": lambda s: s.lower() in ("1", "true", "yes"),
               "int": int, "float": float}


def _add_config_flags(parser: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(Config):
        parser.add_argument(f"--{f.name}", type=_FLAG_TYPES.get(f.type, str),
                            default=None)


def config_from_args(args: argparse.Namespace) -> Config:
    """The given config flags over the default (or, with --tiny, tiny) config."""
    base = tiny_config().to_dict() if args.tiny else {}
    base.update({f.name: getattr(args, f.name)
                 for f in dataclasses.fields(Config)
                 if getattr(args, f.name, None) is not None})
    return Config.from_dict(base)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="neurosync_trainer_lite_tpu_torch.infer",
        description="audio file → 61-dim ARKit blendshape CSV at 60 fps")
    parser.add_argument("--wav", required=True)
    parser.add_argument("--model", default="out/model.pth",
                        help="reference-format model.pth or a training "
                             "checkpoint directory of this package")
    parser.add_argument("--out", default="generated.csv")
    parser.add_argument("--ground-truth", default=None,
                        help="LiveLink CSV to compare against")
    parser.add_argument("--stats", default=None,
                        help="where to write the comparison statistics "
                             "(needs --ground-truth)")
    parser.add_argument("--smooth", action="store_true",
                        help="pair-average smoothing of the output frames")
    parser.add_argument("--device", default=None, choices=("cuda", "cpu"),
                        help="default: the CUDA card")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny 4-layer model geometry")
    _add_config_flags(parser)
    args = parser.parse_args(argv)

    from neurosync_trainer_lite_tpu_torch.inference.api import (
        generate_facial_data_from_bytes)
    from neurosync_trainer_lite_tpu_torch.training.checkpoint import load_model
    from neurosync_trainer_lite_tpu_torch.utils.csv_io import (
        save_generated_data_as_csv)

    cfg = config_from_args(args)
    model = load_model(args.model, cfg, device=args.device)
    with open(args.wav, "rb") as f:
        frames = generate_facial_data_from_bytes(
            f.read(), model, cfg, use_smoothing=args.smooth, device=args.device)
    if isinstance(frames, tuple):
        print(f"{args.wav}: clip shorter than the frontend minimum "
              f"(9 intermediate frames); writing an empty CSV")
        frames = np.zeros((0, cfg.output_dim))
    save_generated_data_as_csv(frames, args.out)
    print(f"{len(frames)} frames → {args.out}")

    if args.ground_truth:
        from neurosync_trainer_lite_tpu_torch.utils.stats import (
            save_comparison_stats)

        stats_path = args.stats or (args.out.rsplit(".", 1)[0] + "_stats.txt")
        save_comparison_stats(args.out, args.ground_truth, stats_path)


if __name__ == "__main__":
    main()

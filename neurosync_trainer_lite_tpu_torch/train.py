"""Training CLI, in PyTorch (port of neurosync_trainer_lite_tpu/train.py).

    python -m neurosync_trainer_lite_tpu_torch.train [--flag value ...]
    python -m neurosync_trainer_lite_tpu_torch [--flag value ...]

The equivalent of the reference's ``python train.py`` (reference:
train.py:61-104): every Config field is a flag; --tiny starts from the tiny
geometry; --init_from_pth warm-starts from a reference-format model.pth;
--profile DIR writes a torch.profiler chrome trace of one epoch. Runs on the
CUDA card unless --device cpu is given. The multi-process flags
(--distributed, --coordinator, --num_processes, --process_id) raise until
data parallelism is ported.
"""

from __future__ import annotations

import argparse
import os

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.infer import (
    _add_config_flags,
    config_from_args,
)


def parse_config(argv=None) -> tuple[Config, argparse.Namespace]:
    parser = argparse.ArgumentParser(
        prog="neurosync_trainer_lite_tpu_torch.train",
        description="NeuroSync audio→blendshape trainer, PyTorch on a CUDA card")
    _add_config_flags(parser)
    parser.add_argument("--tiny", action="store_true",
                        help="use the CPU-runnable 4-layer tiny config as base")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler chrome trace of one "
                             "epoch to DIR/trace.json")
    parser.add_argument("--device", default=None, choices=("cuda", "cpu"),
                        help="default: the CUDA card")
    parser.add_argument("--init_from_pth", type=str, default=None,
                        metavar="PATH",
                        help="warm-start from a reference-format model.pth "
                             "(weights only; the optimizer starts fresh)")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-process training (not ported yet)")
    parser.add_argument("--coordinator", type=str, default=None,
                        metavar="HOST:PORT", help="not ported yet")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="not ported yet")
    parser.add_argument("--process_id", type=int, default=None,
                        help="not ported yet")
    args = parser.parse_args(argv)
    return config_from_args(args), args


def main(argv=None) -> None:
    cfg, args = parse_config(argv)
    if (args.distributed or args.coordinator is not None
            or args.num_processes is not None or args.process_id is not None):
        raise NotImplementedError("multi-process training is not ported yet")

    import torch

    from neurosync_trainer_lite_tpu_torch.training.loop import train_model
    from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    init_sd = None
    if args.init_from_pth:
        init_sd = torch.load(args.init_from_pth, map_location="cpu",
                             weights_only=True)
        print(f"warm-starting from {args.init_from_pth}")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            train_model(cfg.replace(n_epochs=min(cfg.n_epochs, 1)),
                        init_state_dict=init_sd, device=device)
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"profiler trace written to {trace}")
        return
    train_model(cfg, init_state_dict=init_sd, device=device)


if __name__ == "__main__":
    main()

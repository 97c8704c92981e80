"""Training CLI, in PyTorch (port of neurosync_trainer_lite_tpu/train.py).

    python -m neurosync_trainer_lite_tpu_torch.train [--flag value ...]
    python -m neurosync_trainer_lite_tpu_torch [--flag value ...]

The equivalent of the reference's ``python train.py`` (reference:
train.py:61-104): every Config field is a flag; --tiny starts from the tiny
geometry; --init_from_pth warm-starts from a reference-format model.pth;
--profile DIR writes a torch.profiler chrome trace of one epoch. Runs on the
CUDA card unless --device cpu is given.

Data and tensor parallelism, one process a card (parallel/):

    torchrun --nproc_per_node 4 -m neurosync_trainer_lite_tpu_torch.train --distributed
    torchrun --nproc_per_node 4 -m neurosync_trainer_lite_tpu_torch.train \
        --distributed --dp 2 --tp 2           # a (2, 2) rank mesh
    python -m neurosync_trainer_lite_tpu_torch.train --coordinator HOST:PORT \
        --num_processes N --process_id I      # once per rank

--distributed reads torchrun's environment (env://), where the JAX package
auto-detects a TPU pod; --coordinator is the explicit mode. The world is
dp · tp ranks (dp = -1: the world over tp); any other world refuses to
run. --device cpu runs CPU ranks over gloo. Rank flags without a
coordinator, or beside --distributed, refuse to run rather than train
single-process.
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
                        help="multi-process: auto-detection from torchrun's "
                             "environment (env://)")
    parser.add_argument("--coordinator", type=str, default=None,
                        metavar="HOST:PORT",
                        help="multi-process: rank 0's address (explicit "
                             "mode)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="multi-process: total process count")
    parser.add_argument("--process_id", type=int, default=None,
                        help="multi-process: this process's rank")
    args = parser.parse_args(argv)
    return config_from_args(args), args


def _initialize(args) -> bool:
    """Join the process group the flags ask for (True), or refuse flags
    that would otherwise train single-process."""
    from neurosync_trainer_lite_tpu_torch.parallel import distributed

    rank_flags = (args.num_processes is not None
                  or args.process_id is not None)
    if args.coordinator is not None:
        return distributed.initialize_distributed(
            args.coordinator, args.num_processes, args.process_id,
            device=args.device)
    if args.distributed:
        if rank_flags:
            raise SystemExit(
                "--distributed uses auto-detection (torchrun's environment, "
                "env://) and ignores explicit topology; pass --coordinator "
                "HOST:PORT together with --num_processes/--process_id for "
                "explicit mode")
        return distributed.initialize_distributed(init_method="env://",
                                                  device=args.device)
    if rank_flags:
        raise SystemExit(
            "--num_processes/--process_id need --coordinator HOST:PORT (or "
            "use --distributed for auto-detection from torchrun's "
            "environment); refusing to run silently single-process")
    return False


def main(argv=None) -> None:
    cfg, args = parse_config(argv)
    from neurosync_trainer_lite_tpu_torch.parallel import distributed

    joined = _initialize(args)
    try:
        _train(cfg, args, joined)
    finally:
        if joined:
            distributed.destroy()


def _train(cfg, args, joined: bool) -> None:
    import torch

    from neurosync_trainer_lite_tpu_torch.parallel import distributed
    from neurosync_trainer_lite_tpu_torch.training.loop import train_model
    from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device

    if joined:
        device = distributed.rank_device(args.device)
        print(f"distributed: process {distributed.rank()}/"
              f"{distributed.world_size()}, device {device}", flush=True)
    else:
        device = resolve_device(args.device)
    init_sd = None
    if args.init_from_pth:
        init_sd = torch.load(args.init_from_pth, map_location="cpu",
                             weights_only=True)
        print(f"warm-starting from {args.init_from_pth}")

    if args.profile:
        from neurosync_trainer_lite_tpu_torch.utils.profiling import (
            TRACE_FILE, profile_trace)

        with profile_trace(args.profile):
            train_model(cfg.replace(n_epochs=min(cfg.n_epochs, 1)),
                        init_state_dict=init_sd, device=device)
        print(f"profiler trace written to "
              f"{os.path.join(args.profile, TRACE_FILE)}")
        return
    train_model(cfg, init_state_dict=init_sd, device=device)


if __name__ == "__main__":
    main()

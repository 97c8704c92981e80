"""Faults planted underneath the timed path of the wav2vec2 cell, for the
check to catch, and the readings with one planted.

- 'pos_conv_off': the positional conv embedding left out of the forward
  (models/wav2vec2.py:pos_conv returns zeros): the model without its
  only positional signal;
- 'unchanged', 'half_batch': tools/faults.py's training faults (a step
  that returns the parameters as they were; one that leaves out half of
  the batch), which rebind the step drivers/train_loop_w2v.py builds.

    python3 benchmark/tools/faults_w2v.py --workload train-w2v2l-w128-b128 \\
        --seeds 11 12 --fault pos_conv_off [--out FILE]

prints one JSON line a seed, as tools/readings.py does (whose --fault
looks the cell's kind up in tools/faults.py, which has no wav2vec2
faults).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.common import harness  # noqa: E402
from benchmark.tools import faults  # noqa: E402

FAULTS = ("pos_conv_off", "unchanged", "half_batch")


@contextlib.contextmanager
def _pos_conv_off():
    import torch

    from neurosync_trainer_lite_tpu_torch.models import wav2vec2

    sound = wav2vec2.pos_conv
    wav2vec2.pos_conv = lambda module, x: torch.zeros_like(x)
    try:
        yield
    finally:
        wav2vec2.pos_conv = sound


def plant(fault: str):
    """The context manager of `fault`."""
    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r} for the wav2vec2 cell: "
                         f"{FAULTS}")
    if fault == "pos_conv_off":
        return _pos_conv_off()
    return faults.plant("train", fault)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", required=True, choices=FAULTS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    work = harness.workload(args.workload)
    drv = harness.driver(work["driver"])
    for seed in args.seeds:
        ctx = harness.Context(cell=args.workload, workload=work,
                              config=harness.config(work["config"]),
                              seed=seed, seconds=0.0, trace=False,
                              device=args.device, chips=int(work["chips"]))
        t = harness.now()
        with plant(args.fault):
            got = drv.readings(ctx, ())
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "fault": args.fault,
                           "seconds": harness.now() - t, **got})
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

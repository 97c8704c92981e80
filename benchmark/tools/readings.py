"""The numbers the check compares, without a window, over many seeds in one
process: the program's (sound, or with a planted fault) and the control's,
the plain reference computed in float8 in the program's place. They are
what the limits in benchmark/workloads/<cell>.json were set from.

    python3 benchmark/tools/readings.py --workload train-w128-b128 \\
        --seeds 11 12 13 [--fault half_batch] [--control] [--out FILE]

Prints one JSON line a seed; --out appends them to FILE too.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.common import harness  # noqa: E402
from benchmark.tools import faults  # noqa: E402

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault")
    ap.add_argument("--control", action="store_true",
                    help="also read the float8 reference in the program's "
                         "place")
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
        ctx.child_args = ["--mode", "readings"] + (
            ["--fault", args.fault] if args.fault else [])
        precisions = ("fp8", "fp8mm") if args.control else ()
        t = harness.now()
        if args.fault:
            with faults.plant(faults.KIND[work["driver"]], args.fault):
                got = drv.readings(ctx, precisions)
        else:
            got = drv.readings(ctx, precisions)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "fault": args.fault, "seconds": harness.now() - t,
                           **got})
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (loading, the check's steps or requests, warming every shape the
cell uses) counts as setup_s, from the start of this script to the start
of the window; the window measures for about --seconds; then the output of
the timed path is compared with the plain reference (benchmark/reference/).
With --trace 0 the line carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read from a profiled stretch after the
window by the readers in benchmark/metrics/.

Needs as many CUDA cards as the cell asks for; without them it exits with
code 2 and prints no result.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# Python's compiled bytecode is a build cache like the kernels': kept in
# the checkout, written by its first run and read by the rest, also where
# the environment forbids writing it next to the sources (a venv without
# .pyc files otherwise compiles torch anew in every process)
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / "build" / "pycache")
# libraries that would load JAX on their own accord stay off it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from benchmark.common import harness  # noqa: E402


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the other ranks of a cell on several cards, started by rank 0
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--mode", choices=("run", "readings"), default="run",
                    help=argparse.SUPPRESS)
    ap.add_argument("--fault", help=argparse.SUPPRESS)
    ap.add_argument("--cell-json", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def other_rank(args, work: dict) -> int:
    """A rank other than 0: its share of the run (or of the readings), no
    result line."""
    import contextlib

    from benchmark.tools import faults

    shared = json.loads(args.cell_json)
    work = dict(work, params=shared["params"], chips=shared["chips"])
    ctx = harness.Context(cell=args.workload, workload=work,
                          config=shared["config"],
                          seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=args.device,
                          chips=int(work["chips"]), rank=args.rank,
                          port=args.port)
    drv = harness.driver(work["driver"])
    plant = (faults.plant(faults.KIND[work["driver"]], args.fault)
             if args.fault else contextlib.nullcontext())
    with plant:
        if args.mode == "readings":
            drv.readings(ctx, ())
        else:
            drv.run(ctx)
    return 0


def measure(ctx: harness.Context, spec: dict, start: float):
    """Drive the cell's traffic and build its result line (a dict) from
    the outcome; also returns the outcome."""
    out = harness.driver(ctx.workload["driver"]).run(ctx)
    kind = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    values = dict(out.e2e, setup_s=out.window_start - start)
    for m in harness.cell_metrics(spec, ctx.cell, kind):
        if ctx.trace:
            value = harness.metric_reader(m["name"]).read(ctx, out)
        else:
            value = values.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics}
    return line, out


def main(argv=None) -> int:
    args = _args(argv)
    import torch

    spec = harness.benchmark_spec()
    work = harness.workload(args.workload)
    if args.rank > 0:
        return other_rank(args, work)
    chips = int(work["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s), "
              f"found {have}; no result", file=sys.stderr)
        return 2
    ctx = harness.Context(cell=args.workload, workload=work,
                          config=harness.config(work["config"]),
                          seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda", chips=chips)
    ctx.say(f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
            f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{time.perf_counter() - _START:.2f} s after start")
    line, out = measure(ctx, spec, _START)
    ctx.say(f"window started {out.window_start - _START:.2f} s after start")
    line["device"] = harness.device_line(chips, out.memory_peak_bytes)
    if ctx.trace:
        if out.profile is None or out.profile.busy_us() <= 0:
            print("benchmark: the profiled stretch shows no device time; "
                  "no result", file=sys.stderr)
            return 3
        line["device"]["busy_s"] = out.extras.get(
            "busy_us", out.profile.busy_us()) / 1e6
        line["device"]["window_s"] = out.profile.window_us / 1e6
        line["breakdown"] = out.profile.breakdown(skip="bench_profiled")
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package is loaded: {found}; "
              "no result", file=sys.stderr)
        return 4
    line["limits"] = harness.limits_text(out.checks)
    for c in out.checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

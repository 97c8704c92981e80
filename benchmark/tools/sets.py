"""Run a cell several times, one process a run, and keep every result line.

    python3 benchmark/tools/sets.py --workload <cell> --seeds 1 2 3 \\
        [--trace 1] [--seconds S] [--tag set1] --out FILE

Each run is `benchmark/run.py` as the check runs it (seconds default:
BENCHMARK.json's run_seconds). FILE gets one JSON object a run: the tag,
the seed, the exit code, the result line (null when none) and the end of
standard error. Then `tools/spread.py FILE` gives the spreads.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seconds = args.seconds or json.loads(
        (ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    bad = 0
    for seed in args.seeds:
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", args.workload,
             "--seed", str(seed), "--seconds", str(seconds), "--trace",
             str(args.trace)], cwd=ROOT, capture_output=True, text=True,
            timeout=1500)
        lines = r.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        rec = {"tag": args.tag, "workload": args.workload, "seed": seed,
               "trace": args.trace, "rc": r.returncode,
               "wall_s": time.perf_counter() - t, "result": result,
               "stderr": r.stderr[-3000:]}
        bad += r.returncode != 0 or not (result or {}).get("correct")
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        brief = {k: v["value"] for k, v in
                 (result or {}).get("metrics", {}).items()}
        print(json.dumps({"seed": seed, "rc": r.returncode,
                          "correct": (result or {}).get("correct"),
                          "wall_s": round(rec["wall_s"], 1), **brief,
                          "limits": (result or {}).get("limits")}),
              flush=True)
        if r.returncode != 0:
            print(r.stderr[-3000:], file=sys.stderr, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

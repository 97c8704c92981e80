"""Spreads of a cell's runs, as the bounds are set from them.

    python3 benchmark/tools/spread.py FILE [FILE ...]

For each (workload, tag, trace) group of the result lines that tools/sets.py
wrote, and each metric: the median, and the spread, the distance between
the first and the third quartile (statistics.quantiles(values, n=4)) as a
share of the median.
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict


def spread(values: list[float]) -> tuple[float, float]:
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med) if med else float("inf")


def main(paths) -> int:
    groups: dict = defaultdict(lambda: defaultdict(list))
    for path in paths:
        for line in open(path):
            rec = json.loads(line)
            res = rec.get("result") or {}
            key = (rec["workload"], rec.get("tag", ""), rec["trace"])
            for name, m in res.get("metrics", {}).items():
                groups[key][name].append(m["value"])
            groups[key]["correct"].append(float(bool(res.get("correct"))))
    for key, metrics in sorted(groups.items()):
        print(" ".join(map(str, key)))
        for name, values in sorted(metrics.items()):
            if name == "correct":
                print(f"  correct {int(sum(values))}/{len(values)}")
            elif len(values) >= 2:
                med, s = spread(values)
                print(f"  {name}: n={len(values)} median={med!r} "
                      f"spread={100 * s:.3f}% values={values}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

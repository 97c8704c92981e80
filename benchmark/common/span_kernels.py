"""Device kernels attributed to the program's spans, through the trace's
correlation ids.

torch.profiler's Chrome trace gives every kernel (`"cat": "kernel"`) and
the host call that launched it (`cuda_runtime` or `cuda_driver`, e.g.
cudaLaunchKernel) the same `args.correlation`. The program's spans
(`utils/profiling.py:span`, `record_function` ranges named `nsync.*`) are
host ranges (`user_annotation`) on the thread that opened them, on the
same clock. A kernel belongs to the innermost (shortest) `nsync.*` span
that was open on its launching thread when it was launched; where none
was, to None. This reaches what a span around the host code cannot see
from the device's side: a kernel runs later than its launch, often after
the span has closed. A span opened inside an autograd Function's backward
is on autograd's device thread, and so are its launches.

profiled_spans(fn) runs fn under the profiler as harness.profiled does
and returns the attribution with the Profile.
"""

from __future__ import annotations

import bisect
import os
from collections import defaultdict

LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
SPAN_CAT = "user_annotation"


def _correlation(event: dict):
    return (event.get("args") or {}).get("correlation")


def attribute(events: list[dict], window: tuple[float, float] | None = None,
              prefix: str = "nsync.") -> dict:
    """{span name or None: {"us": summed kernel µs, "launches": kernels,
    "instances": the span's occurrences}} over the kernels that start
    inside `window` (µs; default: all), and the spans that start there."""
    lo, hi = window or (float("-inf"), float("inf"))
    spans = defaultdict(list)        # thread → [(start, end, name)]
    instances: dict = defaultdict(int)
    launches = {}
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        cat, ts = e.get("cat"), float(e["ts"])
        thread = (e.get("pid"), e.get("tid"))
        if cat == SPAN_CAT and str(e.get("name", "")).startswith(prefix):
            spans[thread].append((ts, ts + float(e.get("dur", 0.0)),
                                  e["name"]))
            if lo <= ts <= hi:
                instances[e["name"]] += 1
        elif cat in LAUNCH_CATS and _correlation(e) is not None:
            launches[_correlation(e)] = (thread, ts)
    starts = {}
    for thread, rows in spans.items():
        rows.sort()
        starts[thread] = [a for a, _, _ in rows]
    out: dict = defaultdict(lambda: {"us": 0.0, "launches": 0,
                                     "instances": 0})
    for e in events:
        if (e.get("ph") != "X" or e.get("cat") != "kernel"
                or not lo <= float(e.get("ts", lo - 1)) <= hi):
            continue
        owner = None
        launch = launches.get(_correlation(e))
        if launch is not None:
            thread, t = launch
            rows = spans.get(thread, [])
            best = None
            for a, b, name in rows[:bisect.bisect_right(
                    starts.get(thread, []), t)]:
                if a <= t <= b and (best is None or b - a < best[0]):
                    best = (b - a, name)
            owner = best[1] if best else None
        out[owner]["us"] += float(e.get("dur", 0.0))
        out[owner]["launches"] += 1
    for name, n in instances.items():
        out[name]["instances"] = n
    return dict(out)


def profiled_spans(fn, label: str = "bench_profiled"):
    """Run fn() as harness.profiled does and return (fn's result, the
    Profile of the stretch, attribute() over its window)."""
    import json
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.common.profile import Profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities):     # the profiler's own start-up
        sync()
        torch.ones(1, device="cuda" if cuda else "cpu").add_(1)
        sync()
    with profile(activities=activities) as prof:
        with record_function(label):
            sync()
            result = fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        profile_ = Profile.from_file(path, window_name=label)
        with open(path) as f:
            events = json.load(f)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return result, profile_, attribute(events, profile_.window)
    finally:
        os.unlink(path)

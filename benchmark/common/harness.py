"""What every cell shares: finding its pieces by name, the profiled stretch,
the checks that decide `correct`, and the result line.

The pieces are files found by the names in BENCHMARK.json, never listed
here, so that a later change adds a configuration, a cell, a traffic driver
or a per-layer metric as new files only:

    benchmark/configs/<config>.json      the configuration, as it is run
    benchmark/workloads/<cell>.json      config, chips, driver, its params
    benchmark/drivers/<driver>.py        run(ctx) -> Outcome
    benchmark/metrics/<metric>.py        read(ctx, outcome) -> float | None
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

#: top-level module names that no process of the benchmark may hold: the
#: JAX package this port was made from, JAX and its libraries
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax",
                       "neurosync_trainer_lite_tpu"})


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark_spec(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def workload(name: str, bench: Path = BENCH) -> dict:
    return read_json(bench / "workloads" / f"{name}.json")


def config(name: str, bench: Path = BENCH) -> dict:
    return read_json(bench / "configs" / f"{name}.json")


def _load(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str, bench: Path = BENCH):
    return _load(bench / "drivers" / f"{name}.py", f"bench_driver_{name}")


def metric_reader(name: str, bench: Path = BENCH):
    return _load(bench / "metrics" / f"{name}.py",
                 "bench_metric_" + name.replace(".", "_"))


def forbidden_modules(modules=None) -> list[str]:
    """Names in sys.modules whose top-level name (before the first dot),
    compared whole, is forbidden: the port's name begins with the JAX
    package's, so a prefix test would flag the port itself."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def cell_metrics(spec: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of `kind` ('end_to_end' or 'per_layer') that list this
    cell under "workloads". Every per-layer metric lists its cells; an
    end-to-end metric with no list (setup_s) is every cell's."""
    if kind == "per_layer":
        return [m for m in spec[kind] if cell in m["workloads"]]
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


@dataclass
class Check:
    """One number the comparison with the reference reads, and its limit;
    a number that is not finite fails."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back. e2e: the end-to-end metrics it measured
    (setup_s is run.py's); extras: whatever its per-layer readers read."""
    window_start: float
    window_s: float
    e2e: dict
    attempted: int
    failed: int
    checks: list = field(default_factory=list)
    memory_peak_bytes: int = 0
    profile: object = None
    extras: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(
            c.ok for c in self.checks)


@dataclass
class Context:
    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    chips: int = 1
    #: this process's rank among the cell's `chips` processes, and the
    #: port of rank 0's rendezvous (cells on several cards)
    rank: int = 0
    port: int = 0
    #: further arguments for the other ranks' run.py (their mode and fault)
    child_args: list = field(default_factory=list)
    log: object = sys.stderr

    @property
    def params(self) -> dict:
        return self.workload["params"]

    def say(self, *parts) -> None:
        rank = f" {self.rank}" if self.rank else ""
        print(f"[{self.cell}{rank}]", *parts, file=self.log, flush=True)


def profiled(fn, label: str = "bench_profiled"):
    """Run fn() under torch.profiler (CPU and, with a card, CUDA
    activities) inside a record_function(label) that ends after a
    synchronise, and return (fn's result, Profile of that stretch). The
    trace goes through a file in TMPDIR, deleted once read."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.common.profile import Profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    # the profiler's first session in a process pays a start-up of its
    # own inside the stretch (a gap of ~0.16 s seen on the H100): a short
    # session first keeps it out
    with profile(activities=activities):
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
        return result, Profile.from_file(path, window_name=label)
    finally:
        os.unlink(path)


def device_line(chips: int, memory_peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(memory_peak_bytes)}


def limits_text(checks) -> dict:
    return {c.name: {"value": c.value, "limit": c.limit} for c in checks}


def now() -> float:
    return time.perf_counter()

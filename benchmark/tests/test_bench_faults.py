"""The check catches what it exists to catch, at a tiny size on the CPU:
whole runs (set-up, window, trace, reference) skip the harness's look for a
card and come out correct when sound, and not correct with the timed path
broken underneath, once for each fault the cell can have; the control, the
reference in float8 in the program's place, reads above a limit. The
training cell also runs data-parallel over four CPU ranks (gloo), as a
cell on four cards would."""

import pytest
import torch

from benchmark import run as bench_run
from benchmark.common import harness
from benchmark.drivers import train_loop, utterances
from benchmark.tests.tiny import context
from benchmark.tools import faults

#: cell → (kind of cell, driver)
CASES = {"train-w128-b128": ("train", train_loop),
         "serve-utterances": ("serve", utterances),
         "train-dp4-w128-b128": ("train", train_loop)}


def _faults(cell):
    """The faults a cell can have: the exchange between cards only where
    there are several."""
    chips = harness.workload(cell)["chips"]
    return [f for f in faults.FAULTS[CASES[cell][0]]
            if chips > 1 or f != "no_exchange"]


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


#: the metrics of a cell held out of BENCHMARK.json (PERF.md, Open
#: questions) as its entries would list them, so that its driver and its
#: readers stay tested until it is measured
HELD = {"serve-utterances": {
    "end_to_end": [{"name": "request_p95_ms", "unit": "ms"}],
    "per_layer": [{"name": "request_mfu", "unit": "%"},
                  {"name": "device_idle_pct.serve", "unit": "%"}]}}


def _spec(cell):
    spec = harness.benchmark_spec()
    for kind, metrics in HELD.get(cell, {}).items():
        spec[kind] = spec[kind] + [dict(m, workloads=[cell])
                                   for m in metrics]
    return spec


def _measure(ctx):
    return bench_run.measure(ctx, _spec(ctx.cell), harness.now())


@pytest.mark.parametrize("cell", sorted(CASES))
def test_sound_run_is_correct(cell):
    ctx = context(cell, 2 ** 31 + 21, trace=True, use_amp=False)
    line, out = _measure(ctx)
    assert line["correct"], out.checks
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["metrics"], line


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CASES)
                                        for f in _faults(c)])
def test_planted_fault_is_caught(cell, fault):
    ctx = context(cell, 2 ** 31 + 22)
    ctx.child_args = ["--fault", fault]     # the other ranks' share of it
    with faults.plant(CASES[cell][0], fault):
        line, out = _measure(ctx)
    assert not line["correct"], (fault, out.checks)


@pytest.mark.parametrize("cell", sorted(CASES))
def test_control_is_not_correct(cell):
    ctx = context(cell, 2 ** 31 + 23)
    ctx.child_args = ["--mode", "readings"]
    got = CASES[cell][1].readings(ctx, ("fp8",))["fp8"]
    limits = ctx.workload["limits"]
    assert any(v > limits[k] for k, v in got.items()), (got, limits)

"""The port's spans and the training loop's counters (utils/profiling.py:
span; training/loop.py, training/step.py, data/windowing.py): which spans
an epoch records under torch.profiler and how they nest, the shared no-op
without a profiler, the data-parallel step's all-reduce span on two gloo
ranks, and the per-epoch batch_wait_seconds and gather_seconds.

This file doubles as its worker (`python tests/test_torch_tracing.py
worker SPEC RANK`), spawned by tests/test_torch_parallel.py:spawn with a
timeout; the process group's own timeout bounds a hang.
"""

import json
import math
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

from neurosync_trainer_lite_tpu_torch.config import Config  # noqa: E402
from neurosync_trainer_lite_tpu_torch.data.windowing import (  # noqa: E402
    WindowedDataset,
)
from neurosync_trainer_lite_tpu_torch.training import loop  # noqa: E402
from neurosync_trainer_lite_tpu_torch.training.step import (  # noqa: E402
    init_train_state,
    make_eval_step,
    make_train_step,
)
from neurosync_trainer_lite_tpu_torch.utils import profiling  # noqa: E402

#: fp32, dropout 0; 2 clips of 45 frames give 62 windows of 16: 56 for
#: training (7 steps of 8), 6 for validation
GEOM = dict(hidden_dim=32, n_layers=2, num_heads=2, input_dim=16,
            output_dim=5, dropout=0.0, use_amp=False, batch_size=8,
            micro_batch_size=16, n_epochs=2, validation_interval=2,
            learning_rate=1e-3)

#: each span's parent on the main thread
PARENT = {
    "nsync.loop.batch_wait": "nsync.loop.epoch",
    "nsync.loop.upload": "nsync.loop.epoch",
    "nsync.loop.validation": "nsync.loop.epoch",
    "nsync.loop.epoch_sync": "nsync.loop.epoch",
    "nsync.step": "nsync.loop.epoch",
    "nsync.step.forward": "nsync.step",
    "nsync.step.backward": "nsync.step",
    "nsync.step.all_reduce": "nsync.step",
    "nsync.optim.zero_grad": "nsync.step",
    "nsync.optim.clip": "nsync.step",
    "nsync.optim.adam": "nsync.step",
}
#: a data-parallel step's spans inside nsync.step, in the order they open
DP_STEP = ["nsync.optim.zero_grad", "nsync.step.forward",
           "nsync.step.backward", "nsync.step.all_reduce",
           "nsync.optim.clip", "nsync.optim.adam"]


def clips(cfg) -> list:
    rng = np.random.default_rng(3)
    return [(rng.standard_normal((45, cfg.input_dim)).astype(np.float32),
             rng.random((45, cfg.output_dim)).astype(np.float32))
            for _ in range(2)]


class Run:
    """A training state, its views and steps: epochs of train_one_epoch."""

    def __init__(self, cfg, mesh=None, state_dict=None):
        ds = WindowedDataset(clips(cfg), window=cfg.micro_batch_size)
        self.views = ds.split(cfg.val_split, cfg.seed)
        self.steps_per_epoch = len(self.views[0]) // cfg.batch_size
        gen = None if state_dict else torch.Generator().manual_seed(0)
        self.state = init_train_state(cfg, self.steps_per_epoch,
                                      generator=gen, state_dict=state_dict,
                                      device="cpu", mesh=mesh)
        self.cfg, self.mesh, self.batch_step = cfg, mesh, 0
        self.train_step = make_train_step(cfg, mesh=mesh)
        self.eval_step = make_eval_step(cfg, mesh=mesh)

    def epoch(self, index: int, max_steps: int = 0) -> None:
        self.state, self.batch_step, _ = loop.train_one_epoch(
            index, self.state, *self.views,
            self.cfg.replace(max_steps_per_epoch=max_steps),
            self.train_step, self.eval_step, batch_step=self.batch_step,
            device="cpu", mesh=self.mesh, verbose=False)


def traced(fn, path: Path) -> list[dict]:
    """fn() under the CPU profiler: the trace's nsync spans, in start
    order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith("nsync.")),
                  key=lambda e: e["ts"])


def interval(e) -> tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def parent_of(e, spans) -> dict:
    """The one span of e's parent's name, on e's thread, around e."""
    a, b = interval(e)
    around = [p for p in spans if p["name"] == PARENT[e["name"]]
              and p["tid"] == e["tid"] and interval(p)[0] <= a
              and b <= interval(p)[1]]
    assert len(around) == 1, (e["name"], len(around))
    return around[0]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("max_steps", [0, 3], ids=["whole", "bounded"])
def test_epochs_record_each_span(tmp_path, max_steps):
    """Two epochs (whole: 7 steps each; bounded: 3) under the profiler.
    nsync.loop.batch_wait comes once a step, plus once more where the
    epoch runs to the queue's end (the next() that finds it); validation
    after each step of an even batch index, but for the step that ends a
    bounded epoch; forward and backward once a step (no accumulation),
    no all-reduce without a mesh. Every span lies inside its parent; the
    main thread's waits, uploads and steps follow one another without
    overlap, wait, upload, step, so the k-th of each is the k-th step's."""
    run = Run(Config(**GEOM))
    spans = traced(lambda: [run.epoch(i, max_steps) for i in range(2)],
                   tmp_path / "trace.json")
    n = max_steps or run.steps_per_epoch
    assert run.batch_step == 2 * n
    last = n - 1 if max_steps else None
    validations = sum(1 for i in range(n) if i % 2 == 0 and i != last)
    main = {e["tid"] for e in spans if e["name"] == "nsync.loop.epoch"}
    assert len(main) == 1
    per_epoch = {"nsync.loop.epoch": 1, "nsync.loop.epoch_sync": 1,
                 "nsync.loop.batch_wait": n + (0 if max_steps else 1),
                 "nsync.loop.upload": n, "nsync.loop.validation": validations,
                 "nsync.step": n, "nsync.step.forward": n,
                 "nsync.step.backward": n, "nsync.optim.zero_grad": n,
                 "nsync.optim.clip": n, "nsync.optim.adam": n}
    counts = Counter(e["name"] for e in spans if e["tid"] in main)
    assert counts == {k: 2 * v for k, v in per_epoch.items()}
    for e in spans:
        if e["tid"] in main and e["name"] in PARENT:
            parent_of(e, spans)
    chain = [e for e in spans if e["tid"] in main and e["name"] in (
        "nsync.loop.batch_wait", "nsync.loop.upload", "nsync.step")]
    one_epoch = (["nsync.loop.batch_wait", "nsync.loop.upload", "nsync.step"]
                 * n + ([] if max_steps else ["nsync.loop.batch_wait"]))
    assert [e["name"] for e in chain] == 2 * one_epoch
    assert all(interval(e)[1] <= interval(f)[0]
               for e, f in zip(chain, chain[1:]))


def test_accumulation_records_each_micro_batch(tmp_path):
    """With two micro-batches a step, forward and backward twice a step."""
    run = Run(Config(**dict(GEOM, grad_accum_steps=2)))
    spans = traced(lambda: run.epoch(0, 2), tmp_path / "trace.json")
    counts = Counter(e["name"] for e in spans)
    assert counts["nsync.step"] == 2
    assert counts["nsync.step.forward"] == counts["nsync.step.backward"] == 4


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    """No profiler running: span() returns NO_SPAN and never reaches
    record_function (patched to raise), also through an epoch."""
    def boom(*a, **kw):
        raise AssertionError("a span was recorded without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert profiling.span("nsync.step") is profiling.NO_SPAN
    assert profiling.span("nsync.loop.epoch") is profiling.NO_SPAN
    with profiling.span("nsync.step"):
        pass
    run = Run(Config(**GEOM))
    run.epoch(0, 2)
    assert run.batch_step == 2


def test_span_under_a_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = profiling.span("nsync.optim.adam")
        assert s is not profiling.NO_SPAN
        with s:
            torch.ones(2).sum()
    assert "nsync.optim.adam" in {e.key for e in prof.key_averages()}


def test_counters_one_entry_an_epoch(monkeypatch, capsys):
    """train_model's history: batch_wait_seconds and gather_seconds once an
    epoch, finite and non-negative, some gather time in each; the verbose
    epoch line prints both. epoch_seconds comes from perf_counter, not
    the wall clock (here stopped)."""
    monkeypatch.setattr(loop.time, "time", lambda: 0.0)
    history = {}
    loop.train_model(Config(**GEOM), clips(Config(**GEOM)), verbose=True,
                     save_artifacts=False, device="cpu",
                     history_out=history)
    for key in ("batch_wait_seconds", "gather_seconds", "epoch_seconds"):
        assert len(history[key]) == 2, key
        assert all(math.isfinite(x) and x >= 0 for x in history[key]), key
    assert all(x > 0 for x in history["gather_seconds"])
    assert all(x > 0 for x in history["epoch_seconds"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Epoch [")]
    assert len(lines) == 2
    assert all("samples/s; batch wait " in ln and " s, gather " in ln
               for ln in lines)


def test_host_batches_add_their_gather_time():
    cfg = Config(**GEOM)
    ds = WindowedDataset(clips(cfg), window=cfg.micro_batch_size)
    busy = [0.0]
    from neurosync_trainer_lite_tpu_torch.data.windowing import host_batches

    n = sum(1 for _ in host_batches(ds, 8, pin_memory=False, busy=busy))
    assert n == math.ceil(len(ds) / 8) and busy[0] > 0


# ---------------------------------------------------------------------------
# two ranks


def worker(spec_path: str, rank: int) -> None:
    from neurosync_trainer_lite_tpu_torch.parallel import distributed
    from neurosync_trainer_lite_tpu_torch.parallel.mesh import make_mesh
    from tests.test_torch_parallel import GROUP_TIMEOUT

    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    init = {k: torch.from_numpy(v) for k, v in np.load(spec["init"]).items()}
    distributed.initialize_distributed(
        init_method=f"file://{spec['store']}", num_processes=spec["world"],
        process_id=rank, device="cpu", timeout_s=GROUP_TIMEOUT)
    try:
        cfg = Config(**GEOM)
        run = Run(cfg, make_mesh(cfg), init)
        out = Path(spec["out"])
        spans = traced(lambda: run.epoch(0, spec["steps"]),
                       out / f"trace_r{rank}.json")
        inside = [parent_of(e, spans)["name"] for e in spans
                  if e["name"] == "nsync.step.all_reduce"]
        steps = [interval(e) for e in spans if e["name"] == "nsync.step"]
        (out / f"spans_r{rank}.json").write_text(json.dumps({
            "counts": Counter(e["name"] for e in spans),
            "all_reduce_in": inside,
            "order": [[e["name"] for e in spans if e["name"] in PARENT
                       and PARENT[e["name"]] == "nsync.step"
                       and a <= interval(e)[0] < b] for a, b in steps]}))
    finally:
        distributed.destroy()


def test_dp_step_records_its_all_reduce(tmp_path):
    """train_one_epoch of 3 steps on 2 gloo ranks, each under its own
    profiler: nsync.step.all_reduce once a step, inside nsync.step, after
    the backward and before the clip, on both ranks."""
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq
    from tests.test_torch_parallel import spawn

    cfg = Config(**GEOM)
    init = init_seq2seq(cfg, torch.Generator().manual_seed(2),
                        "cpu").state_dict()
    spawn(Path(__file__), tmp_path, 2, [], init, {"steps": 3})
    for rank in range(2):
        got = json.loads((tmp_path / f"spans_r{rank}.json").read_text())
        assert got["counts"]["nsync.step"] == 3
        assert got["counts"]["nsync.step.all_reduce"] == 3
        assert got["all_reduce_in"] == ["nsync.step"] * 3
        assert got["order"] == [DP_STEP] * 3


if __name__ == "__main__":
    if sys.argv[1:2] != ["worker"]:
        sys.exit("usage: test_torch_tracing.py worker SPEC RANK")
    worker(sys.argv[2], int(sys.argv[3]))

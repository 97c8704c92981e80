"""The assignment of the card's idle time to the program's spans
(common/spans.py) and its three readers, on a hand-written Chrome trace:
the innermost span wins, idle time outside every group is unattributed,
the window's edges cut the gaps, and spans of no group claim nothing."""

from types import SimpleNamespace

import pytest

from benchmark.common import harness, spans
from benchmark.common.profile import Profile

READERS = {"loop": "loop_idle_pct.train", "step": "step_idle_pct.train",
           "optim": "optim_idle_pct.train"}


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _span(name, a, b, tid=1):
    return _ev("user_annotation", name, a, b - a, tid)


def _kernel(a, b):
    return _ev("kernel", "void at::native::elementwise_kernel", a, b - a,
               tid=7)


EVENTS = [
    _span("bench_profiled", 0, 200),
    _span("nsync.loop.epoch", 10, 190),
    _span("nsync.loop.batch_wait", 10, 40),
    _span("nsync.step", 50, 150),
    _span("nsync.step.forward", 50, 80),
    _span("nsync.step.backward", 80, 110),
    _span("nsync.optim.adam", 120, 150),
    _span("nsync.loop.epoch_sync", 160, 185),
    _ev("cpu_op", "aten::add_", 125, 3),
    # another thread's span of no group, over the whole window, and the
    # device's mirror of a span: neither claims idle time
    _span("nsync.data.other", 0, 200, tid=2),
    _ev("gpu_user_annotation", "nsync.optim.adam", 0, 200, tid=7),
    _kernel(-10, 5),          # starts before the window
    _kernel(20, 30),
    _kernel(60, 75),
    _kernel(80, 105),
    _kernel(125, 140),
    _kernel(165, 170),
    _kernel(195, 210),        # ends after it
]


def _profile(window=None):
    if window is None:
        marks = [e for e in EVENTS if e["name"] == "bench_profiled"]
        window = (marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"])
    return Profile(EVENTS, window)


def test_innermost_span_wins_and_the_rest_is_unattributed():
    p = _profile()
    # busy [0, 5] [20, 30] [60, 75] [80, 105] [125, 140] [165, 170]
    # [195, 200]: 80 of 200
    assert p.idle_pct() == 60.0
    got = spans.idle_us(p)
    # loop: [10, 20] [30, 40] in the wait, [40, 50] [150, 160] [185, 190]
    # in the epoch, [160, 165] [170, 185] in the sync; step: [50, 60]
    # [75, 80] in the forward, [105, 110] in the backward, [110, 120] in
    # the step; optim: [120, 125] [140, 150]; none: [5, 10] [190, 195]
    assert got == {"loop": 65.0, "step": 30.0, "optim": 15.0,
                   "unattributed": 10.0}


def test_the_window_cuts_the_gaps():
    p = _profile((15.0, 180.0))
    got = spans.idle_us(p)
    assert got == {"loop": 50.0, "step": 30.0, "optim": 15.0,
                   "unattributed": 0.0}
    assert sum(got.values()) == p.window_us - p.busy_us()


@pytest.mark.parametrize("window", [None, (15.0, 180.0), (0.0, 55.0),
                                    (52.5, 123.25)])
def test_shares_add_up_to_the_idle_share(window):
    p = _profile(window)
    shares = [spans.idle_pct(p, g) for g in spans.GROUPS]
    rest = 100.0 * spans.idle_us(p)["unattributed"] / p.window_us
    assert sum(shares) + rest == pytest.approx(p.idle_pct(), abs=1e-9)


def test_groups_by_name():
    assert [spans.group_of(n) for n in (
        "nsync.loop.epoch", "nsync.step", "nsync.step.all_reduce",
        "nsync.optim.zero_grad", "nsync.data.other", "nsync.stepper",
        "aten::mm")] == ["loop", "step", "step", "optim", None, None, None]


def test_readers():
    out = SimpleNamespace(profile=_profile())
    for group, name in READERS.items():
        value = harness.metric_reader(name).read(None, out)
        assert value == pytest.approx(spans.idle_pct(out.profile, group))
    assert harness.metric_reader(READERS["loop"]).read(
        None, out) == pytest.approx(32.5)


def test_nothing_to_read_without_spans():
    """The parent commit's trace (no nsync span), no profile, or no device
    operation: every reader returns None."""
    bare = Profile([e for e in EVENTS if not e["name"].startswith("nsync.")
                    or e["cat"] != "user_annotation"], (0.0, 200.0))
    assert spans.idle_us(bare) is None
    no_group = Profile([_span("nsync.data.other", 0, 50, tid=2),
                        _kernel(10, 20)], (0.0, 50.0))
    assert spans.idle_us(no_group) is None
    no_device = Profile([_span("nsync.step", 0, 50)], (0.0, 50.0))
    assert spans.idle_us(no_device) is None
    for name in READERS.values():
        reader = harness.metric_reader(name)
        assert reader.read(None, SimpleNamespace(profile=bare)) is None
        assert reader.read(None, SimpleNamespace(profile=None)) is None

"""ln_roofline_pct.train on a hand-written trace: the least bytes count the
forward and the backward launches apart, the rows a card come from the
cell (its windows a card on several cards, the config's batch on one), the
finishing pass's time is in the denominator, and a trace without the
kernels (the parent program's) reads nothing."""

from types import SimpleNamespace

import pytest

from benchmark.common import harness
from benchmark.common.peaks import HBM_BYTES_PER_S
from benchmark.common.profile import Profile

NAME = "ln_roofline_pct.train"
FWD = ("void (anonymous namespace)::nsync_ln_fwd<8, 4>(__nv_bfloat16 "
       "const*, float const*, float const*, __nv_bfloat16*, float*, float*, "
       "int, int)")
BWD = ("void (anonymous namespace)::nsync_ln_bwd<8, 4>(__nv_bfloat16 "
       "const*, __nv_bfloat16 const*, float const*, float const*, float "
       "const*, __nv_bfloat16*, float*, int, int)")
PARAMS = ("(anonymous namespace)::nsync_ln_bwd_params(float const*, int, "
          "int, float*, float*)")
CONFIG = {"batch_size": 128, "micro_batch_size": 128, "hidden_dim": 1024}


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def _ctx(chips):
    params = {"batch_size_per_chip": 128} if chips > 1 else {}
    config = dict(CONFIG, batch_size=128 * chips if chips > 1 else 128)
    return SimpleNamespace(params=params, config=config)


EVENTS = [
    _kernel(FWD, 0, 30), _kernel(FWD, 40, 30), _kernel(FWD, 80, 30),
    _kernel(BWD, 120, 40), _kernel(PARAMS, 160, 5),
    _kernel(BWD, 170, 40), _kernel(PARAMS, 210, 5),
    _kernel("void at::native::vectorized_elementwise_kernel<4>", 220, 50),
]


def _read(ctx, events):
    return harness.metric_reader(NAME).read(
        ctx, SimpleNamespace(profile=Profile(events)))


@pytest.mark.parametrize("chips", [1, 4])
def test_bytes_launches_and_time(chips):
    """3 forwards, 2 backwards at 128 x 128 rows of 1,024 on each card:
    (4 * 3 + 6 * 2) * 16,384 * 1,024 bytes over 3.35 TB/s, against the 180
    µs of every nsync_ln_ kernel (the finishing passes' 10 among them)."""
    least_us = (4 * 3 + 6 * 2) * 16384 * 1024 / HBM_BYTES_PER_S * 1e6
    got = _read(_ctx(chips), EVENTS)
    assert got == pytest.approx(100.0 * least_us / 180.0)
    assert got < 100.0


def test_rows_a_card_on_four_cards_are_not_the_global_batch():
    """On four cards the config's batch is the global one (512): the reader
    counts batch_size_per_chip, so the reading equals one card's."""
    ctx = _ctx(4)
    assert ctx.config["batch_size"] == 512
    assert _read(ctx, EVENTS) == pytest.approx(_read(_ctx(1), EVENTS))


def test_nothing_without_the_kernels():
    other = [e for e in EVENTS if "nsync_ln_" not in e["name"]]
    assert _read(_ctx(1), other) is None
    assert harness.metric_reader(NAME).read(
        _ctx(1), SimpleNamespace(profile=None)) is None


def test_mangled_names_are_counted_alike():
    """A tracer that leaves the names mangled: the backward is still told
    from its finishing pass."""
    mangled = [dict(e, name=e["name"]
                    .replace("nsync_ln_bwd_params", "_Z19nsync_ln_bwd_paramsPKfiiPfS1_")
                    .replace("nsync_ln_bwd<8, 4>", "_Z12nsync_ln_bwdILi8ELi4EEvPK")
                    .replace("nsync_ln_fwd<8, 4>", "_Z12nsync_ln_fwdILi8ELi4EEvPK"))
               for e in EVENTS]
    assert _read(_ctx(1), mangled) == pytest.approx(_read(_ctx(1), EVENTS))

"""ffn_epi_roofline_pct.train on a hand-written trace: the least bytes count
the forward and backward launches apart and leave the dropout bits out, the db1 finishing pass counts as time and not as a launch, the rows a
card come from the cell, mangled names count alike, a trace without the
kernels (the parent program's) reads nothing, and a kernel timed at its
bound reads 100."""

from types import SimpleNamespace

import pytest

from benchmark.common import harness
from benchmark.common.peaks import HBM_BYTES_PER_S
from benchmark.common.profile import Profile, classify

NAME = "ffn_epi_roofline_pct.train"
FWD = ("void (anonymous namespace)::nsync_ffn_fwd<1, true>(float const*, "
       "float const*, unsigned char const*, long long, int, float, "
       "__nv_bfloat16*, __nv_bfloat16*, int, int)")
BWD = ("void (anonymous namespace)::nsync_ffn_bwd<1, true>(float const*, "
       "__nv_bfloat16 const*, unsigned char const*, long long, int, float, "
       "__nv_bfloat16*, __nv_bfloat16*, float*, int, int)")
DB1 = ("(anonymous namespace)::nsync_ffn_db1(float const*, int, int, "
       "float*)")
MANGLED = {FWD: "_ZN12_GLOBAL__N_113nsync_ffn_fwdILi1ELb1EEEvPKfS2_PKhxifP13"
                "__nv_bfloat16S6_ii",
           BWD: "_ZN12_GLOBAL__N_113nsync_ffn_bwdILi1ELb1EEEvPKfPK13"
                "__nv_bfloat16PKhxifPS3_S8_Pfii",
           DB1: "_ZN12_GLOBAL__N_113nsync_ffn_db1EPKfiiPf"}
CONFIG = {"batch_size": 128, "micro_batch_size": 128, "hidden_dim": 1024}
#: a launch's least bytes over 128 windows of 128 frames of the 4,096-wide
#: FFN: 6 an element forward, 8 backward; the bits and the GELU's second
#: writes none
ELEMENTS = 128 * 128 * 4096
FWD_BYTES, BWD_BYTES = 6 * ELEMENTS, 8 * ELEMENTS


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def _ctx(chips):
    params = {"batch_size_per_chip": 128} if chips > 1 else {}
    return SimpleNamespace(params=params,
                           config=dict(CONFIG, batch_size=128 * chips))


EVENTS = [
    _kernel(FWD, 0, 250), _kernel(BWD, 550, 330),
    _kernel(DB1, 900, 20), _kernel(FWD, 1000, 250),
    _kernel("void at::native::vectorized_elementwise_kernel<4>", 1300, 50),
]


def _read(ctx, events):
    return harness.metric_reader(NAME).read(
        ctx, SimpleNamespace(profile=Profile(events)))


@pytest.mark.parametrize("chips", [1, 4])
def test_bytes_per_launch_counted_apart(chips):
    """2 forwards and a backward (its finishing pass timed with it) over
    128 x 128 rows of 4,096 on each card, against the 850 µs of the four
    kernels."""
    least_us = (2 * FWD_BYTES + BWD_BYTES) / HBM_BYTES_PER_S * 1e6
    got = _read(_ctx(chips), EVENTS)
    assert got == pytest.approx(100.0 * least_us / 850.0)
    assert got < 100.0


def test_each_kind_is_counted_at_its_own_bytes():
    """One launch of each kind alone, at the same time, reads in the ratio
    of its bytes: 6 : 8; the bits, which each of them may read, in none."""
    reads = [_read(_ctx(1), [_kernel(k, 0, 100)]) for k in (FWD, BWD)]
    assert reads[0] / reads[1] == pytest.approx(6 / 8)
    assert reads[1] == pytest.approx(
        100.0 * BWD_BYTES / HBM_BYTES_PER_S * 1e6 / 100)


def test_the_ffn_width_follows_the_hidden_width():
    ctx = SimpleNamespace(params={}, config=dict(CONFIG, hidden_dim=512))
    assert _read(ctx, EVENTS) == pytest.approx(_read(_ctx(1), EVENTS) / 2)


def test_rows_a_card_on_four_cards_are_not_the_global_batch():
    ctx = _ctx(4)
    assert ctx.config["batch_size"] == 512
    assert _read(ctx, EVENTS) == pytest.approx(_read(_ctx(1), EVENTS))


def test_mangled_names_are_counted_alike():
    mangled = [dict(e, name=MANGLED.get(e["name"], e["name"]))
               for e in EVENTS]
    assert _read(_ctx(1), mangled) == pytest.approx(_read(_ctx(1), EVENTS))


def test_the_kernels_count_as_non_gemm():
    """No class of common/profile.py claims them, in either form (K2's
    `ffn_bwd_*kernel` is a product; these are not): they count as non-GEMM
    device time, as the LayerNorm kernels do."""
    for name in (FWD, BWD, DB1, *MANGLED.values()):
        assert classify(name) == "unclassified", name


def test_nothing_without_the_kernels():
    """The parent program's trace: K2 and PyTorch's elementwise kernels,
    none of these."""
    k2 = _kernel("void (anonymous namespace)::ffn_bwd_wgmma_kernel<128>()",
                 0, 300)
    other = [k2] + [e for e in EVENTS if "nsync_ffn_" not in e["name"]]
    assert _read(_ctx(1), other) is None
    assert _read(_ctx(1), [_kernel(DB1, 0, 20)]) is None
    assert harness.metric_reader(NAME).read(
        _ctx(1), SimpleNamespace(profile=None)) is None


def test_a_kernel_at_its_bound_reads_100():
    events = [_kernel(FWD, 0, FWD_BYTES / HBM_BYTES_PER_S * 1e6),
              _kernel(BWD, 1000, BWD_BYTES / HBM_BYTES_PER_S * 1e6)]
    assert _read(_ctx(1), events) == pytest.approx(100.0)

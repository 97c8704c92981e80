"""lattn_roofline_pct.train on a hand-written trace: the least bytes and
products count the forward and the backward launches apart and leave the
dropout bits out, the windows a card come from the cell, mangled names
count alike, a trace without the kernels (the parent program's) reads
nothing, and a kernel timed at its bound reads 100."""

from types import SimpleNamespace

import pytest

from benchmark.common import harness
from benchmark.common.peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S
from benchmark.common.profile import Profile, classify

NAME = "lattn_roofline_pct.train"
FWD = ("void (anonymous namespace)::nsync_lattn_fwd<64>((anonymous "
       "namespace)::Operand, (anonymous namespace)::Operand, (anonymous "
       "namespace)::Operand, (anonymous namespace)::Operand, "
       "__nv_bfloat16*, int, int, int, float, int, float, int)")
BWD = ("void (anonymous namespace)::nsync_lattn_bwd<64>((anonymous "
       "namespace)::Operand, (anonymous namespace)::Operand, (anonymous "
       "namespace)::Operand, (anonymous namespace)::Operand, (anonymous "
       "namespace)::Operand, __nv_bfloat16*, __nv_bfloat16*, "
       "__nv_bfloat16*, int, int, int, float, int, float, int)")
MANGLED = {FWD: "_ZN12_GLOBAL__N_115nsync_lattn_fwdILi64EEEvNS_7OperandES1_"
                "S1_S1_P13__nv_bfloat16iiifif",
           BWD: "_ZN12_GLOBAL__N_115nsync_lattn_bwdILi64EEEvNS_7OperandES1_"
                "S1_S1_S1_P13__nv_bfloat16S3_S3_iiifif"}
CONFIG = {"batch_size": 128, "micro_batch_size": 128, "hidden_dim": 1024}
#: a launch's least bytes at 128 windows of 128 frames of 1,024: the four
#: [B, T, H] bf16 tensors of a forward, the seven of a backward
ELEMENTS = 128 * 128 * 1024
FWD_BYTES, BWD_BYTES = 4 * 2 * ELEMENTS, 7 * 2 * ELEMENTS
FWD_FLOPS, BWD_FLOPS = 4 * ELEMENTS * 128, 8 * ELEMENTS * 128


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def _ctx(chips):
    params = {"batch_size_per_chip": 128} if chips > 1 else {}
    config = dict(CONFIG, batch_size=128 * chips)
    return SimpleNamespace(params=params, config=config)


EVENTS = [
    _kernel(FWD, 0, 60), _kernel(FWD, 70, 60), _kernel(BWD, 140, 100),
    _kernel("void at::native::vectorized_elementwise_kernel<4>", 250, 50),
]


def _read(ctx, events):
    return harness.metric_reader(NAME).read(
        ctx, SimpleNamespace(profile=Profile(events)))


@pytest.mark.parametrize("chips", [1, 4])
def test_bytes_and_products_per_launch(chips):
    """2 forwards and a backward at 128 x 128 rows of 1,024 on each card,
    bound by their bytes (the mask's none of them), against the 220 µs of
    the three."""
    assert FWD_BYTES / HBM_BYTES_PER_S > FWD_FLOPS / BF16_FLOP_PER_S
    assert BWD_BYTES / HBM_BYTES_PER_S > BWD_FLOPS / BF16_FLOP_PER_S
    least_us = (2 * FWD_BYTES + BWD_BYTES) / HBM_BYTES_PER_S * 1e6
    got = _read(_ctx(chips), EVENTS)
    assert got == pytest.approx(100.0 * least_us / 220.0)
    assert got < 100.0


def test_the_products_bound_a_narrow_width():
    """Where the products' time passes the bytes' (a long window), the
    bound is the products'."""
    ctx = SimpleNamespace(params={}, config=dict(CONFIG,
                                                 micro_batch_size=4096))
    elements = 128 * 4096 * 1024
    by_ops = (2 * 4 + 8) * elements * 4096 / BF16_FLOP_PER_S * 1e6
    assert by_ops > (2 * 4 + 7) * 2 * elements / HBM_BYTES_PER_S * 1e6
    assert _read(ctx, EVENTS) == pytest.approx(100.0 * by_ops / 220.0)


def test_windows_a_card_on_four_cards_are_not_the_global_batch():
    ctx = _ctx(4)
    assert ctx.config["batch_size"] == 512
    assert _read(ctx, EVENTS) == pytest.approx(_read(_ctx(1), EVENTS))


def test_mangled_names_are_counted_alike():
    mangled = [dict(e, name=MANGLED.get(e["name"], e["name"]))
               for e in EVENTS]
    assert _read(_ctx(1), mangled) == pytest.approx(_read(_ctx(1), EVENTS))


def test_the_kernels_count_as_non_gemm():
    """No class of common/profile.py claims them, in either form: they
    count as non-GEMM device time, as the LayerNorm kernels do."""
    for name in (FWD, BWD, *MANGLED.values()):
        assert classify(name) == "unclassified", name


def test_nothing_without_the_kernels():
    other = [e for e in EVENTS if "nsync_lattn_" not in e["name"]]
    assert _read(_ctx(1), other) is None
    assert harness.metric_reader(NAME).read(
        _ctx(1), SimpleNamespace(profile=None)) is None


def test_a_kernel_at_its_bound_reads_100():
    fwd_us = FWD_BYTES / HBM_BYTES_PER_S * 1e6
    bwd_us = BWD_BYTES / HBM_BYTES_PER_S * 1e6
    events = [_kernel(FWD, 0, fwd_us), _kernel(BWD, 100, bwd_us)]
    assert _read(_ctx(1), events) == pytest.approx(100.0)

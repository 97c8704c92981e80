"""The wav2vec2 cell at a tiny size on the CPU: a whole run (set-up,
window, trace, reference) is correct when sound and not correct with a
fault planted under the timed path; the float8 control reads above a
limit; the span attribution gives each kernel of a hand-written trace to
the right span; the FLOP counter counts the published model's parameters
and the positional conv's work by hand."""

import copy
import json

import pytest
import torch

from benchmark import run as bench_run
from benchmark.common import flops_w2v, harness
from benchmark.common.span_kernels import attribute
from benchmark.drivers import train_loop_w2v
from benchmark.tools import faults_w2v

CELL = "train-w2v2l-w128-b128"
#: the cell's files with the widths, depth, batch and corpus cut, fp32
TINY_CONFIG = dict(hidden_dim=64, n_layers=2, num_heads=4,
                   conv_dim=[32] * 7, micro_batch_size=8, batch_size=4,
                   use_amp=False)
TINY_PARAMS = dict(clips=2, clip_frames=300, profile_steps=2,
                   reference_rows=2)


def context(seed: int, *, trace: bool = False) -> harness.Context:
    work = copy.deepcopy(harness.workload(CELL))
    cfg = harness.config(work["config"])
    cfg.update(TINY_CONFIG)
    work["params"].update(TINY_PARAMS)
    return harness.Context(cell=CELL, workload=work, config=cfg, seed=seed,
                           seconds=0.5, trace=trace, device="cpu", chips=1)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _measure(ctx):
    return bench_run.measure(ctx, harness.benchmark_spec(), harness.now())


def test_sound_run_is_correct():
    line, out = _measure(context(2 ** 31 + 31, trace=True))
    assert line["correct"], out.checks
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "train_mfu" in line["metrics"], line
    # on the CPU the profiler sees no kernels: the span readers find nothing
    assert "w2v_frontend_pct.train" not in line["metrics"]
    assert "posconv_roofline_pct.train" not in line["metrics"]


@pytest.mark.parametrize("fault", faults_w2v.FAULTS)
def test_planted_fault_is_caught(fault):
    with faults_w2v.plant(fault):
        line, out = _measure(context(2 ** 31 + 32))
    assert not line["correct"], (fault, out.checks)


def test_control_is_not_correct():
    ctx = context(2 ** 31 + 33)
    got = train_loop_w2v.readings(ctx, ("fp8",))
    limits = ctx.workload["limits"]
    assert all(v <= limits[k] for k, v in got["program"].items()), got
    assert any(v > limits[k] for k, v in got["fp8"].items()), (got, limits)


def test_batches_fed_are_the_windows_cut_in_samples():
    """The reference's cut of the check's first batch (frame windows of
    reference/windows.py, samples from floor(s · 16000 / 60)) against the
    program's WaveformDataset over the same corpus."""
    from neurosync_trainer_lite_tpu_torch.data.waveform import WaveformDataset

    ctx = context(2 ** 31 + 34)
    device = torch.device("cpu")
    (src, trg), *_ = train_loop_w2v.check_batches(ctx, device)
    ds = WaveformDataset(train_loop_w2v.corpus(ctx, device), 8, 16000, 60)
    train, _ = ds.split(0.1, ctx.seed)
    first = next(train.index_batches(4, shuffle=True, seed=ctx.seed))
    want_src, want_trg = ds.gather(first)
    assert src.shape == (4, 2133)
    assert torch.equal(src, torch.from_numpy(want_src))
    assert torch.equal(trg, torch.from_numpy(want_trg))


def _event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_span_attribution_follows_correlation_ids():
    """Kernels run after their launches, some after the span has closed;
    each goes to the innermost nsync span open on its launching thread, a
    launch on another thread (autograd's) to that thread's span."""
    events = [
        _event("user_annotation", "nsync.step", 0, 100),
        _event("user_annotation", "nsync.w2v.frontend", 10, 20),
        _event("user_annotation", "nsync.w2v.pos_conv", 40, 5),
        _event("user_annotation", "other", 41, 2),
        _event("user_annotation", "nsync.w2v.pos_conv_bwd", 60, 10, tid=2),
        _event("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _event("cuda_runtime", "cudaLaunchKernel", 41.5, 1, corr=2),
        _event("cuda_driver", "cuLaunchKernel", 61, 1, tid=2, corr=3),
        _event("cuda_runtime", "cudaLaunchKernel", 80, 1, corr=4),
        _event("cuda_runtime", "cudaLaunchKernel", 62, 1, corr=5),
        _event("cuda_runtime", "cudaLaunchKernel", 200, 1, corr=6),
        _event("kernel", "conv_a", 50, 7, tid=7, corr=1),
        _event("kernel", "conv_b", 58, 3, tid=7, corr=2),
        _event("kernel", "dgrad", 90, 11, tid=7, corr=3),
        _event("kernel", "gemm", 101, 2, tid=7, corr=4),
        _event("kernel", "add", 103, 1, tid=7, corr=5),
        _event("kernel", "late", 201, 4, tid=7, corr=6),
        _event("kernel", "orphan", 205, 1, tid=7, corr=99),
    ]
    got = attribute(events)
    assert got["nsync.w2v.frontend"]["us"] == 7
    assert got["nsync.w2v.pos_conv"] == {"us": 3, "launches": 1,
                                         "instances": 1}
    assert got["nsync.w2v.pos_conv_bwd"]["us"] == 11
    # corr 5 was launched by tid 1 inside nsync.step, not the bwd span
    assert got["nsync.step"] == {"us": 3, "launches": 2, "instances": 1}
    assert got[None] == {"us": 5, "launches": 2, "instances": 0}
    windowed = attribute(events, window=(0, 150))
    assert None not in windowed
    assert json.dumps({str(k): v for k, v in got.items()})


def test_flops_count_the_published_model():
    d = flops_w2v.dims(harness.config("wav2vec2-large-lv60-train"))
    assert flops_w2v.parameter_count(d) == 315_500_221
    assert (flops_w2v.parameter_count(d) - flops_w2v.frozen_count(d)
            == 311_290_045)
    assert flops_w2v.encoder_frames(d)[-1] == 106
    # the positional conv over 128 windows of 128 frames: each output of
    # 1,024 channels sums 64 input channels × 128 taps
    assert flops_w2v.pos_conv_forward_flops(128, d) == (
        2 * 128 * 128 * 1024 * 64 * 128)
    by_hand = 128 * (2 * 6825 * 512 * 10 + 2 * (3412 + 1705 + 852 + 425)
                     * 512 * 512 * 3 + 2 * (212 + 106) * 512 * 512 * 2)
    assert 128 * flops_w2v.frontend_flops_per_window(d) == by_hand
    step = 128 * flops_w2v.train_flops_per_window(d)
    assert 32.4e12 < step < 32.6e12


def test_metric_readers_read_the_span_table():
    reader = harness.metric_reader("posconv_roofline_pct.train")
    w2v = harness.metric_reader("w2v_frontend_pct.train")

    class Prof:
        def class_us(self):
            from collections import Counter

            return Counter({"gemm": 600.0, "elementwise": 400.0,
                            "collective": 50.0})

    class Out:
        profile = Prof()
        extras = {"pos_conv_fwd_flops": 989e6,
                  "span_kernels": {
                      "nsync.w2v.frontend": {"us": 250.0, "launches": 9,
                                             "instances": 1},
                      "nsync.w2v.pos_conv": {"us": 2.0, "launches": 3,
                                             "instances": 2},
                      "nsync.w2v.pos_conv_bwd": {"us": 8.0, "launches": 2,
                                                 "instances": 1}}}
    # 4 forwards' work of 1 µs each at the peak, in 10 µs
    assert reader.read(None, Out()) == pytest.approx(40.0)
    assert w2v.read(None, Out()) == pytest.approx(25.0)
    Out.extras = {}
    assert reader.read(None, Out()) is None and w2v.read(None, Out()) is None


def test_layer_norm_reader_counts_each_launch_at_its_rows_and_width():
    """One profiled step of the published cell: the frontend's 7 channel
    LayerNorms at width 512 over each conv's frames, the projection's
    forward and backward at 512 and 49 of each at 1,024 over the batch's
    16,384 frames, each kernel 50 µs; the bytes counted by hand."""
    from benchmark.common.profile import Profile

    reader = harness.metric_reader("w2v_ln_roofline_pct.train")
    sig = "(__nv_bfloat16 const*, float const*)"
    names = ([f"void (anonymous namespace)::nsync_ln_fwd<8, 2>{sig}"] * 8
             + [f"void (anonymous namespace)::nsync_ln_fwd<8, 4>{sig}"] * 49
             + [f"void (anonymous namespace)::nsync_ln_bwd<8, 2>{sig}"]
             + [f"void (anonymous namespace)::nsync_ln_bwd<8, 4>{sig}"] * 49
             + ["void (anonymous namespace)::nsync_ln_bwd_params(float*)"]
             * 50 + ["ampere_bf16_gemm"] * 3)
    events = [_event("kernel", n, 100 * i, 50) for i, n in enumerate(names)]

    class Ctx:
        config = harness.config("wav2vec2-large-lv60-train")
        params = harness.workload(CELL)["params"]

    class Out:
        profile = Profile(events)
        extras = {"span_kernels": {"nsync.w2v.frontend": {
            "us": 400.0, "launches": 20, "instances": 1}}}

    frontend_rows = 128 * (6825 + 3412 + 1705 + 852 + 425 + 212 + 106)
    rows = 128 * 128
    nbytes = (4 * (frontend_rows * 512 + rows * 512 + 49 * rows * 1024)
              + 6 * (rows * 512 + 49 * rows * 1024))
    us = 50 * (8 + 49 + 1 + 49 + 50)
    assert reader.read(Ctx(), Out()) == pytest.approx(
        100 * nbytes / 3.35e12 / (us * 1e-6))
    Out.extras = {"span_kernels": {"nsync.step": {"us": 1.0, "launches": 1,
                                                  "instances": 1}}}
    assert reader.read(Ctx(), Out()) is None


def test_reference_and_its_test_copy_import_nothing_of_the_port():
    """Both copies of the plain reference are the same file and load with
    torch and numpy alone: no port, no JAX."""
    import subprocess
    import sys

    root = harness.ROOT
    bench = (root / "benchmark" / "reference" / "wav2vec2.py").read_text()
    assert (root / "tests" / "plain_wav2vec2.py").read_text() == bench
    code = (f"import sys; sys.path.insert(0, {str(root)!r})\n"
            "from benchmark.reference import wav2vec2  # noqa: F401\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    tops = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "neurosync_trainer_lite_tpu_torch" not in tops
    assert not tops & harness.FORBIDDEN

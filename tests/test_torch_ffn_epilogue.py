"""The FFN core's hidden-width epilogues (ops/ffn_epilogue.py,
csrc/ffn_epilogue.cu).

On the CPU: the plain versions, which the core now calls, against a frozen
copy of the core's composed ops they were moved from (bitwise: forward and
every gradient); the route (the card's tensors take the kernels) and what
the kernels' entry points refuse; and the routing, with the CUDA entry
points stood in for by the plain versions: one launch each way a site,
none under K2's backward or in a validation forward.

On the card (marker `cuda`): the kernels against the plain versions at the
training shape [16,384 x 4,096], a tensor-parallel rank's column block of
the bits and ragged rows; full-width bf16 steps of both architectures
against the same steps on the composed ops, and their launch counts. This
file imports no JAX, so the card tests run with --noconftest.
"""

from __future__ import annotations

import json
import math
import shutil
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.models import layers, seq2seq
from neurosync_trainer_lite_tpu_torch.ops import attention as tattn
from neurosync_trainer_lite_tpu_torch.ops import ffn_epilogue as fe
from neurosync_trainer_lite_tpu_torch.ops import kernels

BF16 = torch.bfloat16
ROOT = Path(__file__).resolve().parents[1]


# -- a frozen copy of the core's composed ops the plain versions replaced ---


_FROZEN_ACT = {"relu": torch.relu, "gelu": F.gelu}


def _frozen_gelu_grad(h):
    return (0.5 * (1.0 + torch.erf(h * math.sqrt(0.5)))
            + h * torch.exp(-0.5 * h * h) / math.sqrt(2.0 * math.pi))


def _frozen_keep(seed, q, shape, width, device):
    if q <= 0:
        return None
    return tattn.dropout_keep(seed, (*shape[:-1], width), q, device,
                              split_dim=-1).reshape(-1, width)


class _FrozenCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, seed, q, activation):
        x2 = x.reshape(-1, x.shape[-1])
        w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
        h1 = (tattn._mm_f32(x2, w1c.t()) + b1.float()).to(x.dtype)
        a = _FROZEN_ACT[activation](h1)
        keep = _frozen_keep(seed, q, x.shape, a.shape[-1], x.device)
        if keep is not None:
            a = tattn._drop(a, keep, q)
        y = tattn._mm_f32(a, w2c.t())
        y = (y + b2.float()).to(x.dtype)
        ctx.save_for_backward(x2, a if activation == "relu" else h1, w1c, w2c)
        ctx.seed, ctx.q, ctx.activation, ctx.shape = seed, q, activation, \
            x.shape
        return y.reshape(*x.shape[:-1], w2.shape[0])

    @staticmethod
    def backward(ctx, dy):
        x2, r, w1c, w2c = ctx.saved_tensors
        dy2 = dy.reshape(-1, dy.shape[-1])
        q, scale = ctx.q, 256.0 / (256 - ctx.q)
        db2 = dy2.float().sum(0)
        if ctx.activation == "relu":
            dw2 = tattn._mm_f32(dy2.t(), r)
            da = tattn._mm_f32(dy2, w2c).to(dy.dtype)
            dh1 = torch.where(r > 0, da * tattn._bf16_value(scale), 0)
        else:
            keep = _frozen_keep(ctx.seed, q, ctx.shape, r.shape[-1], r.device)
            a = F.gelu(r)
            dw2 = tattn._mm_f32(dy2.t(), a if keep is None else
                                tattn._drop(a, keep, q))
            da = tattn._mm_f32(dy2, w2c).to(dy.dtype)
            if keep is not None:
                da = tattn._drop(da, keep, q)
            dh1 = (da.float() * _frozen_gelu_grad(r.float())).to(dy.dtype)
        db1 = dh1.float().sum(0)
        dw1 = tattn._mm_f32(dh1.t(), x2)
        dx = tattn._mm_f32(dh1, w1c)
        return (dx.to(dy.dtype).reshape(ctx.shape), dw1, db1, dw2, db2, None,
                None, None)


def _core_inputs(seed=2, width=64, ffn=256):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, 8, width, generator=g).to(BF16)
    w1 = torch.randn(ffn, width, generator=g) * 0.1
    b1 = torch.randn(ffn, generator=g) * 0.1
    w2 = torch.randn(width, ffn, generator=g) * 0.1
    b2 = torch.randn(width, generator=g) * 0.1
    dy = torch.randn(3, 8, width, generator=g).to(BF16)
    return [x, w1, b1, w2, b2], dy


def _run(core, params, dy, *args):
    leaves = [p.clone().requires_grad_(True) for p in params]
    y = core(*leaves, *args)
    y.backward(dy)
    return [y.detach()] + [p.grad for p in leaves]


CASES = [("relu", 77), ("relu", 0), ("gelu", 26), ("gelu", 0)]


@pytest.mark.parametrize("act,q", CASES)
def test_the_core_on_the_plain_versions_is_the_parents_core(act, q):
    """The core, now on ops/ffn_epilogue.py's plain versions, against the
    frozen composed core: y and all five gradients bitwise."""
    params, dy = _core_inputs()
    got = _run(layers._FfnCore.apply, params, dy, 1234, q, act, None, False)
    want = _run(_FrozenCore.apply, params, dy, 1234, q, act)
    for name, a, b in zip(("y", "dx", "dw1", "db1", "dw2", "db2"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("act,q", CASES)
def test_the_plain_versions_are_the_composed_ops(act, q):
    """Each plain version alone against the frozen composition of its
    piece, on a tensor-parallel rank's strided bits."""
    g = torch.Generator().manual_seed(5)
    n, f = 40, 48
    p32 = torch.randn(n, f, generator=g) * 2
    b1 = torch.randn(f, generator=g)
    da32 = torch.randn(n, f, generator=g)
    with tattn.dropout_rows(1, 0, 2, 1):
        keep = _frozen_keep(9, q, (n, f), f, "cpu")
        bits = layers._ffn_bits(9, q, (n, f), f, "cpu")
    assert (keep is None) == (bits is None) == (q == 0)
    if bits is not None:
        assert bits.stride() == (2 * f, 1) and torch.equal(bits >= q, keep)
    h1 = (p32 + b1).to(BF16)
    a = _FROZEN_ACT[act](h1)
    if keep is not None:
        a = tattn._drop(a, keep, q)
    got_a, got_h1 = fe.ffn_epi_fwd_plain(p32, b1, bits, q, act)
    assert torch.equal(got_a, a)
    assert got_h1 is None if act == "relu" else torch.equal(got_h1, h1)
    if act == "relu":
        dh1 = torch.where(a > 0, da32.to(BF16) * tattn._bf16_value(
            256.0 / (256 - q)), 0)
        got = fe.ffn_epi_bwd_plain(da32, a, None, q, act)
    else:
        da = da32.to(BF16)
        if keep is not None:
            da = tattn._drop(da, keep, q)
        dh1 = (da.float() * _frozen_gelu_grad(h1.float())).to(BF16)
        got = fe.ffn_epi_bwd_plain(da32, h1, bits, q, act)
    assert torch.equal(got[0], dh1)
    assert torch.equal(got[1], dh1.float().sum(0))
    assert got[2] is None if act == "relu" else torch.equal(got[2], a)


def test_gelu_grad_is_the_derivative():
    h = torch.linspace(-6, 6, 2001, dtype=torch.float64, requires_grad=True)
    F.gelu(h).sum().backward()
    torch.testing.assert_close(fe.gelu_grad(h.detach()), h.grad)


# -- the gate ----------------------------------------------------------------


class _Like:
    """What takes_kernel reads of a tensor, settable."""

    def __init__(self, shape=(64, 256), dtype=torch.float32, cuda=True,
                 contiguous=True, ptr=1 << 20, stride=None):
        self.shape, self.dtype, self.is_cuda = torch.Size(shape), dtype, cuda
        self.device = torch.device("cuda" if cuda else "cpu")
        self._contiguous, self._ptr = contiguous, ptr
        self._stride = stride or (shape[-1], 1)

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self._contiguous

    def data_ptr(self):
        return self._ptr

    def stride(self, i=None):
        return self._stride if i is None else self._stride[i]


@pytest.mark.parametrize("case,want", [
    ({}, True),
    ({"cuda": False}, False),
])
def test_takes_kernel(case, want):
    """The card's tensors take the kernels, the CPU's the plain versions."""
    assert fe.takes_kernel(_Like(**case)) is want


@pytest.mark.parametrize("case,want", [
    ({}, True),
    ({"cuda": False}, False),
    ({"hidden": torch.float32}, False),
    ({"hidden": torch.float16}, False),
    ({"shape": (64, 260)}, False),
    ({"shape": (64, 4100)}, False),
    ({"shape": (64, 4096)}, True),
    ({"shape": (1, 8)}, True),
    ({"contiguous": False}, False),
    ({"ptr": (1 << 20) + 8}, False),
    ({"bits": {"dtype": torch.uint8}}, True),
    ({"bits": {"dtype": torch.uint8, "stride": (512, 1)}}, True),
    ({"bits": {"dtype": torch.uint8, "stride": (260, 1)}}, False),
    ({"bits": {"dtype": torch.uint8, "stride": (512, 2)}}, False),
    ({"bits": {"dtype": torch.uint8, "ptr": (1 << 20) + 4}}, False),
    ({"bits": {"dtype": torch.uint8, "shape": (64, 128)}}, False),
    ({"bits": {"dtype": torch.bool}}, False),
])
def test_the_entry_points_check(case, want):
    """The kernels take bf16 hidden values over contiguous, 16-byte aligned
    [N, F] CUDA tensors with F a multiple of 8, and bits they can read 8 at
    a time; their entry points raise on anything else, which then never
    runs the plain versions on the card."""
    case = dict(case)
    hidden = case.pop("hidden", BF16)
    bits = case.pop("bits", None)
    t = _Like(**case, dtype=hidden)
    b = None if bits is None else _Like(**{"shape": t.shape, **bits})

    def check():
        fe._check(t, BF16, "t")
        fe._bits_args(b, 26, t)

    if want:
        check()
    else:
        with pytest.raises(ValueError):
            check()


def test_cpu_tensors_take_the_plain_versions():
    p32, b1 = torch.randn(16, 64), torch.randn(64)
    assert not fe.takes_kernel(p32)
    kernels.reset_launches()
    a, h1 = fe.ffn_epi_fwd(p32, b1, None, 0, "gelu")
    fe.ffn_epi_bwd(torch.randn(16, 64), h1, None, 0, "gelu")
    assert not kernels.LAUNCHES


def test_the_cuda_entry_points_refuse_cpu_tensors():
    x = torch.randn(16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fe.ffn_epi_fwd_cuda(x, torch.randn(64), None, 0, "relu")
    with pytest.raises(ValueError, match="CUDA"):
        fe.ffn_epi_bwd_cuda(x, x.to(BF16), None, 0, "relu")


# -- the routing, the CUDA entry points stood in for -------------------------


@pytest.fixture
def routed(monkeypatch):
    """takes_kernel true everywhere and each CUDA entry point replaced by
    its plain version, counted: a CPU run then takes the kernels' route."""
    calls = []

    def stand_in(name, plain):
        def fn(*args):
            calls.append((name, args))
            return plain(*args)
        return fn

    monkeypatch.setattr(fe, "takes_kernel", lambda *a, **k: True)
    monkeypatch.setattr(fe, "ffn_epi_fwd_cuda",
                        stand_in("fwd", fe.ffn_epi_fwd_plain))
    monkeypatch.setattr(fe, "ffn_epi_bwd_cuda",
                        stand_in("bwd", fe.ffn_epi_bwd_plain))
    return calls


def _counts(calls):
    out = {}
    for name, _ in calls:
        out[name] = out.get(name, 0) + 1
    return out


@pytest.mark.parametrize("act,q", CASES)
def test_the_core_routes_one_launch_each_way(routed, act, q):
    """A core's forward launches the forward kernel once with the drawn
    bits; its backward the backward kernel once, with the forward's bits
    redrawn for the GELU; ReLU's backward reads no bits. The results are
    the plain route's, bitwise."""
    params, dy = _core_inputs()
    got = _run(layers._FfnCore.apply, params, dy, 77, q, act, None, False)
    want = _run(_FrozenCore.apply, params, dy, 77, q, act)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [c[0] for c in routed] == ["fwd", "bwd"]
    fwd_bits = routed[0][1][2]
    assert (fwd_bits is None) == (q == 0)
    if act == "gelu" and q:
        assert torch.equal(routed[1][1][2], fwd_bits)
    if act == "relu":
        assert routed[1][1][2] is None


def test_k2_takes_the_forward_kernel_alone(routed):
    params, dy = _core_inputs()
    _run(layers._FfnCore.apply, params, dy, 77, 77, "relu", None, True)
    assert _counts(routed) == {"fwd": 1}


def _tiny_seq2seq(**kw):
    return Config(hidden_dim=64, n_layers=2, num_heads=4, input_dim=32,
                  output_dim=7, dropout=0.3, use_amp=True, **kw)


def _tiny_step(cfg, src, trg, weights=None):
    from neurosync_trainer_lite_tpu_torch.training.step import (
        init_train_state, make_train_step)
    state = init_train_state(cfg, 5, device="cpu", state_dict=weights,
                             generator=torch.Generator().manual_seed(0))
    _, loss, norm = make_train_step(cfg)(state, src, trg,
                                         torch.Generator().manual_seed(1))
    return float(loss), float(norm), state


def test_a_seq2seq_step_launches_once_each_way_a_site(routed):
    """A bf16 step at 2 + 2 layers: 4 FFN sites, a forward and a backward
    kernel each, the same loss and norm as the plain route; an eval
    forward launches none."""
    cfg = _tiny_seq2seq()
    g = torch.Generator().manual_seed(3)
    src, trg = torch.randn(4, 16, 32, generator=g), torch.rand(4, 16, 7,
                                                               generator=g)
    got = _tiny_step(cfg, src, trg)
    assert _counts(routed) == {"fwd": 4, "bwd": 4}
    routed.clear()
    with torch.no_grad():
        got[2].model.eval()(src)
    assert routed == []


def test_the_k2_route_launches_the_forward_kernel_alone(routed, monkeypatch):
    monkeypatch.setattr(seq2seq, "_ffn", layers.ffn_fused)
    cfg = _tiny_seq2seq()
    g = torch.Generator().manual_seed(3)
    _tiny_step(cfg, torch.randn(4, 16, 32, generator=g),
               torch.rand(4, 16, 7, generator=g))
    assert _counts(routed) == {"fwd": 4}


def test_a_wav2vec2_step_launches_each_kernel_once_a_layer(routed):
    cfg = Config(architecture="wav2vec2", sr=16000, hidden_dim=64,
                 n_layers=2, num_heads=4, conv_dim=(32,) * 7,
                 micro_batch_size=8, batch_size=4, use_amp=True, seed=5,
                 dropout=0.1)
    g = torch.Generator().manual_seed(3)
    src = torch.randn(4, cfg.window_samples, generator=g)
    trg = torch.rand(4, 8, 61, generator=g)
    _tiny_step(cfg, src, trg)
    assert _counts(routed) == {"fwd": 2, "bwd": 2}


# -- on the card -------------------------------------------------------------


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if shutil.which("nvcc") is None and not Path(
            "/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("needs nvcc to build the kernels")
    return torch.Generator(device="cuda").manual_seed(0)


def _assert_bf16_near(got, want, what, share=1e-3):
    """got bitwise want, or one bf16 rounding from it (of want's size) in
    at most `share` of the elements (erf and exp of the card's library
    against PyTorch's, one fp32 ulp away, can flip a rounding)."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        w.abs().clamp_min(2.0 ** -126))) - 7)
    diff = (g - w).abs()
    assert bool((diff <= ulp).all()), (what, (diff / ulp).max().item())
    off = (got != want).float().mean().item()
    assert off <= share, (what, off)
    return off


#: rows, F, activation, q, bits drawn at twice the width (a tp = 2 rank's
#: column block, rows 2F apart)
CARD_SHAPES = [
    (16384, 4096, "relu", 77, False),
    (16384, 4096, "relu", 0, False),
    (16384, 4096, "gelu", 26, False),
    (16384, 4096, "gelu", 0, False),
    (16384, 2048, "gelu", 26, True),
    (16384, 2048, "relu", 77, True),
    (1000, 4096, "gelu", 26, False),
    (257, 264, "relu", 77, False),
    (1, 8, "gelu", 26, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,f,act,q,tp", CARD_SHAPES)
def test_kernels_match_the_plain_versions(gen, rows, f, act, q, tp):
    p32 = torch.randn(rows, f, device="cuda", generator=gen) * 2
    b1 = torch.randn(f, device="cuda", generator=gen) * 0.5
    da32 = torch.randn(rows, f, device="cuda", generator=gen)
    with tattn.dropout_rows(1, 0, 2 if tp else 1, 1 if tp else 0):
        bits = layers._ffn_bits(31, q, (rows, f), f, "cuda")
    if tp:
        assert bits.stride() == (2 * f, 1)
    assert fe.takes_kernel(p32)
    kernels.reset_launches()
    a, h1 = fe.ffn_epi_fwd_cuda(p32, b1, bits, q, act)
    want_a, want_h1 = fe.ffn_epi_fwd_plain(p32, b1, bits, q, act)
    r = want_a if act == "relu" else want_h1
    if act == "relu":
        assert h1 is None and torch.equal(a, want_a)
    else:
        assert torch.equal(h1, want_h1)
        _assert_bf16_near(a, want_a, "a")
    dh1, db1, a2 = fe.ffn_epi_bwd_cuda(da32, r, bits, q, act)
    want_dh1, want_db1, want_a2 = fe.ffn_epi_bwd_plain(da32, r, bits, q, act)
    if act == "relu":
        assert torch.equal(dh1, want_dh1) and a2 is None
    else:
        _assert_bf16_near(dh1, want_dh1, "dh1")
        _assert_bf16_near(a2, want_a2, "dw2 operand")
        assert torch.equal(a2, a)
    scale = want_db1.abs().max().clamp_min(1e-30)
    assert float((db1 - want_db1).abs().max() / scale) <= 1e-5
    again = fe.ffn_epi_bwd_cuda(da32, r, bits, q, act)
    assert torch.equal(again[0], dh1) and torch.equal(again[1], db1)
    assert again[2] is None if act == "relu" else torch.equal(again[2], a2)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"ffn_epi_fwd": 1, "ffn_epi_bwd": 2}


@pytest.mark.cuda
def test_the_kernels_run_the_nsync_ffn_symbols(gen):
    """By the profiler's kernel names, which ffn_epi_roofline_pct.train
    reads: the forward, the backward and its finishing pass, from two
    traced calls (the tracer can miss the first launch of a window) after
    one untraced call that builds and loads."""
    from torch.profiler import ProfilerActivity, profile

    p32 = torch.randn(256, 4096, device="cuda", generator=gen)
    b1 = torch.randn(4096, device="cuda", generator=gen)
    bits = layers._ffn_bits(3, 26, (256, 4096), 4096, "cuda")

    def run():
        _, h1 = fe.ffn_epi_fwd_cuda(p32, b1, bits, 26, "gelu")
        fe.ffn_epi_bwd_cuda(p32, h1, bits, 26, "gelu")
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        run()
    names = [e.key for e in prof.key_averages()]
    for kernel in ("nsync_ffn_fwd", "nsync_ffn_bwd", "nsync_ffn_db1"):
        assert any(kernel in n for n in names), (kernel, names)


@pytest.mark.cuda
def test_the_cuda_entry_points_refuse_what_they_do_not_take(gen):
    """On the card the routes take the kernels, whose entry points raise on
    what they do not take: nothing falls back to the plain versions."""
    p32 = torch.randn(8, 20, device="cuda", generator=gen)
    for fwd in (fe.ffn_epi_fwd_cuda, fe.ffn_epi_fwd):
        with pytest.raises(ValueError, match="multiple of 8"):
            fwd(p32, torch.zeros(20, device="cuda"), None, 0, "relu")
    wide = torch.randn(8, 32, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="contiguous"):
        fe.ffn_epi_fwd(wide[:, :16], torch.zeros(16, device="cuda"), None, 0,
                       "relu")
    bits = torch.zeros(8, 20, dtype=torch.uint8, device="cuda")[:, :16]
    with pytest.raises(ValueError, match="bits"):
        fe.ffn_epi_fwd(wide[:, :16].contiguous(),
                       torch.zeros(16, device="cuda"), bits, 26, "gelu")
    with pytest.raises(ValueError):
        fe.ffn_epi_bwd(torch.randn(8, 16, device="cuda"),
                       torch.zeros(8, 16, device="cuda"), None, 0, "gelu")
    with pytest.raises(ValueError, match="shape"):
        fe.ffn_epi_bwd_cuda(torch.randn(8, 16, device="cuda"),
                            torch.zeros(8, 24, dtype=BF16, device="cuda"),
                            None, 0, "relu")


def _grad_gap(got: dict, want: dict) -> float:
    """The worst leaf's |got − want| norm over max(its norm, the median
    leaf's): the benchmark's grad_gap, of the difference itself."""
    norms = {k: float(v.float().norm()) for k, v in want.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return max(float((got[k].float() - v.float()).norm()) / max(norms[k], med)
               for k, v in want.items())


def _card_step(cfg, weights, src, trg, kernel: bool, monkeypatch):
    from neurosync_trainer_lite_tpu_torch.training.step import (
        init_train_state, make_train_step)
    with monkeypatch.context() as m:
        if not kernel:
            m.setattr(fe, "takes_kernel", lambda *a, **k: False)
        state = init_train_state(cfg, 1000, device="cuda",
                                 state_dict=weights)
        kernels.reset_launches()
        _, loss, _ = make_train_step(cfg)(state, src, trg,
                                          torch.Generator().manual_seed(4))
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    grads = {k: p.grad.detach().clone() for k, p in
             state.model.named_parameters() if p.grad is not None}
    return float(loss), grads, launches, state


def _ffn_counts(launches):
    return {k: v for k, v in launches.items() if k.startswith("ffn_")}


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["default", "k2"])
def test_a_full_width_seq2seq_step_on_the_kernels(gen, monkeypatch, route):
    """The published Seq2Seq (dropout 0.3, bf16) at 32 windows of 128: one
    step on the kernels against the same step on the composed ops, loss
    within 6e-4 relative and every gradient within 0.035 (the cell's
    correct limits); 16 forward and 16 backward launches (K2's route: the
    16 forwards alone, K2 16), K1, LN and LA unchanged; a validation
    forward launches none."""
    if route == "k2":
        monkeypatch.setattr(seq2seq, "_ffn", layers.ffn_fused)
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq
    cfg = Config(batch_size=32)
    weights = init_seq2seq(cfg, gen, device="cuda").state_dict()
    src = torch.randn(32, 128, cfg.input_dim, device="cuda", generator=gen)
    trg = torch.rand(32, 128, cfg.output_dim, device="cuda", generator=gen)
    loss, grads, launches, state = _card_step(cfg, weights, src, trg, True,
                                              monkeypatch)
    ref_loss, ref_grads, ref_launches, _ = _card_step(
        cfg, weights, src, trg, False, monkeypatch)
    assert abs(loss - ref_loss) <= 6e-4 * abs(ref_loss)
    assert grads.keys() == ref_grads.keys()
    assert _grad_gap(grads, ref_grads) <= 0.035
    want = ({"ffn_epi_fwd": 16, "ffn_bwd_dh1": 16} if route == "k2" else
            {"ffn_epi_fwd": 16, "ffn_epi_bwd": 16})
    assert _ffn_counts(launches) == want
    rest = {k: v for k, v in launches.items() if not k.startswith("ffn_epi")}
    assert rest == {k: v for k, v in ref_launches.items()
                    if not k.startswith("ffn_epi")}
    assert rest["rope_rotate"] == 100 and rest["layer_norm_fwd"] == 42 \
        and rest["lean_attention_fwd"] == 24
    kernels.reset_launches()
    with torch.no_grad():
        state.model.eval()(src)
    torch.cuda.synchronize()
    assert not _ffn_counts(dict(kernels.LAUNCHES))


@pytest.mark.cuda
def test_a_full_width_wav2vec2_step_on_the_kernels(gen, monkeypatch):
    """wav2vec2-large at its published widths, 8 windows of 128 frames:
    loss within 1.5e-3 relative and every gradient within 0.008 of the
    composed ops' step; 24 launches each way, LN and LA unchanged."""
    from neurosync_trainer_lite_tpu_torch.models.architectures import (
        architecture)

    spec = json.loads((ROOT / "benchmark" / "configs" /
                       "wav2vec2-large-lv60-train.json").read_text())
    cfg = Config.from_dict(spec).replace(batch_size=8)
    weights = architecture(cfg.architecture).init(cfg, gen,
                                                   "cuda").state_dict()
    src = torch.randn(8, cfg.window_samples, device="cuda", generator=gen)
    trg = torch.rand(8, 128, 61, device="cuda", generator=gen)
    loss, grads, launches, _ = _card_step(cfg, weights, src, trg, True,
                                          monkeypatch)
    ref_loss, ref_grads, ref_launches, _ = _card_step(
        cfg, weights, src, trg, False, monkeypatch)
    assert abs(loss - ref_loss) <= 1.5e-3 * abs(ref_loss)
    assert _grad_gap(grads, ref_grads) <= 0.008
    assert _ffn_counts(launches) == {"ffn_epi_fwd": 24, "ffn_epi_bwd": 24}
    assert not _ffn_counts(ref_launches)
    assert {k: v for k, v in launches.items() if not k.startswith("ffn_")} \
        == ref_launches

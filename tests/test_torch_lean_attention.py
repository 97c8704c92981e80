"""The lean bf16 training attention core (ops/attention.py:_SdpaLeanCore,
its kernels' gate in ops/lean_attention.py) on the CPU: its plain pair
against a frozen copy of the core it replaced, the dropout bits split out
of dropout_keep, the routing between the kernels and the plain pair, and
what the autograd Function keeps for its backward. The kernels themselves
run on the card (tests/test_torch_cuda_kernels.py)."""

from types import SimpleNamespace

import pytest
import torch

from neurosync_trainer_lite_tpu_torch.ops import attention as tattn
from neurosync_trainer_lite_tpu_torch.ops import flash_attention as fa
from neurosync_trainer_lite_tpu_torch.ops import lean_attention as la

BF16 = torch.bfloat16


# -- frozen copies of the code the plain pair replaced ----------------------


def _frozen_dropout_keep(seed, shape, q, device, split_dim=None):
    n, i, nw, j = tattn._BLOCKS
    full = [*shape]
    full[0] *= n
    if split_dim is not None:
        full[split_dim] *= nw
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    bits = torch.empty(full, dtype=torch.uint8, device=device)
    bits.random_(generator=g)
    bits = bits.narrow(0, i * shape[0], shape[0])
    if split_dim is not None:
        bits = bits.narrow(split_dim, j * shape[split_dim], shape[split_dim])
    return bits >= q


def _frozen_lean_weights(q, k, seed, scale, qthresh):
    s = tattn._matmul_round_once(q, k.transpose(-1, -2)) * \
        tattn._bf16_value(scale)
    w = torch.softmax(s.float(), dim=-1).to(torch.bfloat16)
    if qthresh == 0:
        return w, w, None
    keep = _frozen_dropout_keep(seed, w.shape, qthresh, w.device, split_dim=1)
    return w, tattn._drop(w, keep, qthresh), keep


def _frozen_fwd(q, k, v, seed, scale, qthresh):
    _, wd, _ = _frozen_lean_weights(q, k, seed, scale, qthresh)
    return tattn._matmul_round_once(wd, v)


def _frozen_bwd(dout, q, k, v, seed, scale, qthresh):
    w, wd, keep = _frozen_lean_weights(q, k, seed, scale, qthresh)
    dv = tattn._matmul_round_once(wd.transpose(-1, -2), dout)
    dw = tattn._matmul_round_once(dout, v.transpose(-1, -2))
    if keep is not None:
        dw = tattn._drop(dw, keep, qthresh)
    wf, dwf = w.float(), dw.float()
    ds = (wf * (dwf - (dwf * wf).sum(-1, keepdim=True))).to(torch.bfloat16)
    ds = ds * tattn._bf16_value(scale)
    dq = tattn._matmul_round_once(ds, k)
    dk = tattn._matmul_round_once(ds.transpose(-1, -2), q)
    return dq, dk, dv


# -----------------------------------------------------------------------------


def _operands(seed, B, n, tq, tk, h):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, n, tq, h, generator=g).to(BF16)
    k, v = (torch.randn(B, n, tk, h, generator=g).to(BF16) for _ in range(2))
    dout = torch.randn(B, n, tq, h, generator=g).to(BF16)
    return q, k, v, dout


SHAPES = [  # B, n, Tq, Tk, h
    (2, 4, 8, 8, 16),
    (2, 4, 7, 13, 64),       # Tq != Tk, neither a multiple of 16
    (3, 2, 1, 1, 80),        # T = 1; a width past 64
    (1, 2, 20, 1, 16),       # one key
    (2, 2, 33, 17, 64),
]


@pytest.mark.parametrize("qthresh", [0, 26, 77])
@pytest.mark.parametrize("B,n,tq,tk,h", SHAPES)
def test_plain_pair_is_bitwise_the_core_it_replaced(B, n, tq, tk, h, qthresh):
    q, k, v, dout = _operands(tq * 31 + tk, B, n, tq, tk, h)
    seed, scale = 1234, h ** -0.5
    bits = tattn.draw_bits(seed, q, k, qthresh)
    assert (bits is None) == (qthresh == 0)
    assert torch.equal(tattn.lean_attention_plain_fwd(q, k, v, bits, scale,
                                                   qthresh),
                       _frozen_fwd(q, k, v, seed, scale, qthresh))
    got = tattn.lean_attention_plain_bwd(dout, q, k, v, bits, scale, qthresh)
    want = _frozen_bwd(dout, q, k, v, seed, scale, qthresh)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("qthresh", [0, 26, 77])
def test_the_function_on_the_cpu_is_the_core_it_replaced(qthresh):
    """Through autograd: the same output and dq, dk, dv bit for bit."""
    q, k, v, dout = _operands(5, 2, 4, 12, 10, 64)
    seed, scale = 99, 64 ** -0.5
    args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    y = tattn._SdpaLeanCore.apply(*args, seed, scale, qthresh)
    y.backward(dout)
    assert torch.equal(y, _frozen_fwd(q, k, v, seed, scale, qthresh))
    want = _frozen_bwd(dout, q, k, v, seed, scale, qthresh)
    for name, a, b in zip(("dq", "dk", "dv"), args, want):
        assert torch.equal(a.grad, b), name


BLOCKS = [None, (4, 0), (4, 3), (2, 1, 2, 0), (2, 0, 2, 1)]


@pytest.mark.parametrize("split_dim", [None, 1])
@pytest.mark.parametrize("blocks", BLOCKS)
def test_dropout_keep_is_unchanged_by_the_bits_split(blocks, split_dim):
    """dropout_keep = dropout_bits >= q, bitwise the draw it was, plain and
    under a DP rank's rows and a TP rank's heads (split_dim = 1)."""
    shape = (3, 4, 9, 11)
    ctx = (tattn.dropout_rows(*blocks) if blocks
           else tattn.dropout_rows(1, 0))
    with ctx:
        for q in (26, 77, 128):
            got = tattn.dropout_keep(7, shape, q, "cpu", split_dim)
            want = _frozen_dropout_keep(7, shape, q, "cpu", split_dim)
            assert got.shape == shape and torch.equal(got, want)
        bits = tattn.dropout_bits(7, shape, "cpu", split_dim)
    assert bits.dtype == torch.uint8 and bits.stride(-1) == 1


def test_dropout_bits_under_a_tp_rank_are_a_strided_block():
    """A TP rank's heads of the global draw: not contiguous, which is why
    the kernels take the bits' strides."""
    shape = (2, 4, 8, 16)
    with tattn.dropout_rows(2, 1, 2, 1):
        bits = tattn.dropout_bits(3, shape, "cpu", split_dim=1)
    whole = tattn.dropout_bits(3, (4, 8, 8, 16), "cpu", split_dim=1)
    assert torch.equal(bits, whole[2:, 4:])
    assert not bits.is_contiguous() and bits.stride(1) == 8 * 16


def _like(cuda=True, dtype=BF16, tq=128, tk=128, h=64):
    return (SimpleNamespace(is_cuda=cuda, dtype=dtype, shape=(2, 4, tq, h)),
            SimpleNamespace(is_cuda=cuda, dtype=dtype, shape=(2, 4, tk, h)))


@pytest.mark.parametrize("case,want", [
    ({}, True),
    ({"cuda": False}, False),
    ({"dtype": torch.float32}, False),
    ({"dtype": torch.float16}, False),
    ({"tq": 129}, False),
    ({"tk": 129}, False),
    ({"tq": 1, "tk": 1}, True),
    ({"tq": 7, "tk": 100}, True),
    ({"h": 24}, False),
    ({"h": 144}, False),
    ({"h": 16}, True),
    ({"h": 128}, True),
])
def test_routing_by_device_dtype_lengths_and_width(case, want):
    assert la.takes_kernel(*_like(**case)) is want


def test_supports_is_the_shape_gate():
    assert all(la.supports(1, t, h) for t in (1, 64, 128)
               for h in fa.HEAD_DIMS)
    assert not any(la.supports(tq, tk, 64)
                   for tq, tk in ((0, 8), (8, 0), (129, 8), (8, 129)))
    assert not any(la.supports(8, 8, h) for h in (8, 20, 24, 40, 136, 256))


def test_the_function_dispatches_on_takes_kernel(monkeypatch):
    """Where takes_kernel holds, the Function hands the CUDA pair the
    operands as they lie (the head split's views), the drawn bits and the
    scale; elsewhere the plain pair runs and the CUDA pair is never
    called."""
    q, k, v, dout = _operands(3, 2, 4, 8, 8, 16)
    calls = []

    def fake_fwd(*args):
        calls.append(("fwd", args))
        return tattn.lean_attention_plain_fwd(*args)

    def fake_bwd(*args):
        calls.append(("bwd", args))
        return tattn.lean_attention_plain_bwd(*args)

    monkeypatch.setattr(la, "lean_attention_fwd_cuda", fake_fwd)
    monkeypatch.setattr(la, "lean_attention_bwd_cuda", fake_bwd)
    args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tattn._SdpaLeanCore.apply(*args, 5, 0.25, 77).backward(dout)
    assert not calls
    monkeypatch.setattr(la, "takes_kernel", lambda q, k: True)
    y = tattn._SdpaLeanCore.apply(*args, 5, 0.25, 77)
    y.backward(dout)
    assert [c[0] for c in calls] == ["fwd", "bwd"]
    fwd_bits = calls[0][1][3]
    assert torch.equal(fwd_bits, tattn.draw_bits(5, q, k, 77))
    assert torch.equal(calls[1][1][4], fwd_bits)
    assert calls[0][1][4:] == (0.25, 77)


def test_saved_tensors_are_q_k_v_and_nothing_of_size_t_by_t():
    T = 12
    q, k, v, _ = _operands(4, 2, 4, T, T, 16)
    args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = tattn._SdpaLeanCore.apply(*args, 8, 0.25, 77)
    assert shapes == [tuple(t.shape) for t in args]
    saved = y.grad_fn.saved_tensors
    assert [t.data_ptr() for t in saved] == [t.data_ptr() for t in args]
    assert not any(s[-2:] == (T, T) for s in shapes)


def test_rate_near_one_takes_the_composed_zeros(monkeypatch):
    """q = round(rate · 256) = 256 drops everything: sdpa returns the
    composed path's zeros, and the lean core is not called."""
    def refuse(*_):
        raise AssertionError("the lean core ran")

    monkeypatch.setattr(tattn._SdpaLeanCore, "apply", refuse)
    q, k, v, _ = _operands(6, 2, 4, 8, 8, 16)
    out = tattn.sdpa(q, k, v, dropout_rate=0.999, seed=3, train=True)
    assert out.dtype == BF16 and not out.float().abs().max()


def test_bf16_training_sdpa_takes_the_lean_core(monkeypatch):
    ran = []
    real = tattn._SdpaLeanCore.apply
    monkeypatch.setattr(tattn._SdpaLeanCore, "apply",
                        lambda *a: ran.append(a[3:]) or real(*a))
    q, k, v, _ = _operands(6, 2, 4, 8, 8, 16)
    tattn.sdpa(q, k, v, dropout_rate=0.3, seed=3, train=True)
    tattn.sdpa(q, k, v, dropout_rate=0.0, seed=3, train=True)
    tattn.sdpa(q, k, v, dropout_rate=0.3, seed=3, train=False)
    assert ran == [(3, 0.25, 77), (3, 0.25, 0)]


def test_kernel_view_keeps_the_head_split_and_copies_the_rest():
    x = torch.randn(2, 16, 4 * 64).to(BF16)
    heads = x.reshape(2, 16, 4, 64).transpose(1, 2)
    assert la.kernel_view(heads) is heads
    strided = torch.randn(2, 4, 16, 128).to(BF16)[..., ::2]
    copied = la.kernel_view(strided)
    assert copied.is_contiguous() and torch.equal(copied, strided)
    flat = torch.zeros(2 * 4 * 16 * 64 + 1, dtype=BF16)
    off = flat[1:].view(2, 4, 16, 64)
    assert off.data_ptr() % 16
    moved = la.kernel_view(off)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, off)


@pytest.mark.parametrize("fn", ["fwd", "bwd"])
def test_the_cuda_pair_refuses_what_the_kernels_do_not_take(fn):
    """On this machine every tensor is a CPU one: the wrappers refuse them
    before anything launches, and refuse fp32 by its type first."""
    q, k, v, dout = _operands(2, 1, 2, 8, 8, 16)

    def call(*ops, bits=None, qthresh=0):
        if fn == "fwd":
            return la.lean_attention_fwd_cuda(*ops[:3], bits, 0.25, qthresh)
        return la.lean_attention_bwd_cuda(ops[3], *ops[:3], bits, 0.25,
                                          qthresh)

    with pytest.raises(TypeError, match="bf16"):
        call(*(t.float() for t in (q, k, v, dout)))
    with pytest.raises(ValueError, match="CUDA"):
        call(q, k, v, dout)

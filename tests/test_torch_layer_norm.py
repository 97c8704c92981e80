"""The bf16 LayerNorm's routing and its plain contract, on the CPU.

ops/layer_norm_kernel.py holds the contract of csrc/layer_norm.cu's kernels
(layer_norm_plain_fwd and layer_norm_plain_bwd) and the wrappers that launch
them. On the CPU the model's bf16 LayerNorm takes the plain version, which
must be bitwise the autograd Function the model had before the kernels
(kept below as _EagerLayerNormBf16), so that every CPU test holding the port
against JAX sees the same numbers. The kernels themselves are held against
the plain version on the card (tests/test_torch_cuda_kernels.py).
"""

from types import SimpleNamespace

import pytest
import torch

from neurosync_trainer_lite_tpu_torch.models import layers, seq2seq
from neurosync_trainer_lite_tpu_torch.ops import kernels
from neurosync_trainer_lite_tpu_torch.ops import layer_norm_kernel as lnk


class _EagerLayerNormBf16(torch.autograd.Function):
    """The model's bf16 LayerNorm as it was composed of PyTorch ops."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
        r = torch.rsqrt(var + 1e-5)
        ctx.save_for_backward(x, mean, r, weight)
        return ((xf - mean) * r * weight + bias).to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        x, mean, r, weight = ctx.saved_tensors
        y = (x.float() - mean) * r
        df = dout.float()
        width = df.shape[-1]
        dweight = (df * y).reshape(-1, width).sum(0)
        dbias = df.reshape(-1, width).sum(0)
        dy = df * weight
        m1 = dy.mean(dim=-1, keepdim=True)
        m2 = (dy * y).mean(dim=-1, keepdim=True)
        return (r * (dy - m1 - y * m2)).to(x.dtype), dweight, dbias


def _inputs(shape, seed):
    g = torch.Generator().manual_seed(seed)
    width = shape[-1]
    x = (torch.randn(*shape, generator=g) * 2.0 + 0.5).bfloat16()
    w = torch.rand(width, generator=g) + 0.5
    b = torch.randn(width, generator=g)
    dout = torch.randn(*shape, generator=g).bfloat16()
    return x, w, b, dout


def _grads(fn, x, w, b, dout):
    xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
    out = fn(xs, ws, bs)
    out.backward(dout)
    return out.detach(), xs.grad, ws.grad, bs.grad


SHAPES = [(3, 7, 32), (2, 5, 20), (4, 1000), (1, 1024), (2, 3, 2100)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_contract_is_bitwise_the_eager_function(shape):
    """layer_norm_plain_fwd and layer_norm_plain_bwd give bitwise the eager
    Function's output, saved statistics and gradients."""
    x, w, b, dout = _inputs(shape, 3)
    want = _grads(_EagerLayerNormBf16.apply, x, w, b, dout)
    out, mean, r = lnk.layer_norm_plain_fwd(x, w, b)
    assert torch.equal(out, want[0])
    assert mean.shape == r.shape == (*shape[:-1], 1)
    got = lnk.layer_norm_plain_bwd(dout, x, mean, r, w)
    for a, e in zip(got, want[1:]):
        assert a.dtype == e.dtype and torch.equal(a, e)


@pytest.mark.parametrize("shape", SHAPES)
def test_model_layer_norm_on_the_cpu_is_bitwise_unchanged(shape):
    """The model's layer_norm in bf16 on the CPU: the Function over the
    plain contract, bitwise the eager Function, and no kernel launched."""
    x, w, b, dout = _inputs(shape, 4)
    want = _grads(_EagerLayerNormBf16.apply, x, w, b, dout)
    kernels.reset_launches()
    got = _grads(seq2seq.layer_norm, x, w, b, dout)
    assert not kernels.LAUNCHES
    for a, e in zip(got, want):
        assert torch.equal(a, e)


def test_fp32_keeps_the_plain_composition(monkeypatch):
    """fp32 x never reaches the bf16 Function (the JAX fp32 path)."""
    def refuse(*_):
        raise AssertionError("fp32 LayerNorm took the bf16 Function")

    monkeypatch.setattr(layers._LayerNormBf16, "apply", refuse)
    x, w, b, _ = _inputs((3, 7, 32), 5)
    xf = x.float()
    out = seq2seq.layer_norm(xf, w, b)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    want = (xf - mean) * torch.rsqrt(var + 1e-5) * w + b
    assert out.dtype == torch.float32 and torch.equal(out, want)


def _like(device, width):
    return SimpleNamespace(device=torch.device(device), shape=(4, width))


def test_routing_by_device_and_width():
    """The device alone picks the route: a CUDA tensor of any width goes to
    the kernels, whose wrappers refuse a row wider than MAX_WIDTH."""
    assert lnk.takes_kernel(_like("cuda", 1024))
    assert lnk.takes_kernel(_like("cuda", lnk.MAX_WIDTH))
    assert lnk.takes_kernel(_like("cuda", lnk.MAX_WIDTH + 1))
    assert not lnk.takes_kernel(_like("cpu", 1024))
    assert not lnk.takes_kernel(_like("cpu", lnk.MAX_WIDTH + 1))
    assert not lnk.takes_kernel(torch.zeros(2, 8, dtype=torch.bfloat16))


@pytest.mark.parametrize("kernel", [True, False])
def test_function_calls_the_wrappers_the_routing_picks(monkeypatch, kernel):
    """With the routing forced, the model's Function calls the CUDA wrappers
    (here stood in by the plain version, recording each call) or the plain
    version, and keeps the residuals (x, mean, r, weight) either way."""
    calls = []

    def record(name, fn):
        def inner(*args):
            calls.append(name)
            return fn(*args)
        return inner

    monkeypatch.setattr(lnk, "takes_kernel", lambda x: kernel)
    monkeypatch.setattr(lnk, "layer_norm_fwd_cuda",
                        record("fwd_cuda", lnk.layer_norm_plain_fwd))
    monkeypatch.setattr(lnk, "layer_norm_bwd_cuda",
                        record("bwd_cuda", lnk.layer_norm_plain_bwd))
    monkeypatch.setattr(lnk, "layer_norm_plain_fwd",
                        record("fwd_plain", lnk.layer_norm_plain_fwd))
    monkeypatch.setattr(lnk, "layer_norm_plain_bwd",
                        record("bwd_plain", lnk.layer_norm_plain_bwd))
    x, w, b, dout = _inputs((2, 3, 16), 6)
    xs = x.clone().requires_grad_(True)
    out = seq2seq.layer_norm(xs, w, b)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 4
    assert saved[0].data_ptr() == xs.data_ptr() and torch.equal(saved[3], w)
    assert saved[1].shape == saved[2].shape == (2, 3, 1)
    out.backward(dout)
    assert calls == (["fwd_cuda", "bwd_cuda"] if kernel else
                     ["fwd_plain", "bwd_plain"])


def test_cuda_wrappers_refuse_wrong_dtypes_widths_and_cpu_tensors():
    x, w, b, dout = _inputs((2, 16), 7)
    mean, r = torch.zeros(2, 1), torch.ones(2, 1)
    with pytest.raises(TypeError, match="bf16"):
        lnk.layer_norm_fwd_cuda(x.float(), w, b)
    with pytest.raises(TypeError, match="bf16"):
        lnk.layer_norm_bwd_cuda(dout.half(), x, mean, r, w)
    with pytest.raises(ValueError, match="width"):
        lnk.layer_norm_fwd_cuda(torch.zeros(2, lnk.MAX_WIDTH + 1,
                                            dtype=torch.bfloat16), w, b)
    with pytest.raises(ValueError, match="CUDA"):
        lnk.layer_norm_fwd_cuda(x, w, b)
    with pytest.raises(ValueError, match="CUDA"):
        lnk.layer_norm_bwd_cuda(dout, x, mean, r, w)

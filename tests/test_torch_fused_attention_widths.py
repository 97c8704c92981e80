"""Kernel K4 at every head width it takes, against the JAX package.

The port's K4 (ops/fused_attention.py) takes every multiple of 16 up to 128
(HEAD_DIMS); other widths take the composed path, where the JAX kernel
runs its Pallas body at any even width (the stated dispatch difference,
fits_smem). Here, on the CPU: multi_head_attention at impl='pallas' against
the JAX one at h = 48 and 128, in bf16 and fp32; which path the dispatch
takes at h = 48 and 128 (K4) and 24 and 40 (composed); the plain K4 forward
and backward against the JAX kernels (interpret mode) at h = 48 and 128.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neurosync_trainer_lite_tpu.ops import attention as jattn
from neurosync_trainer_lite_tpu.ops import fused_attention as jfua
from neurosync_trainer_lite_tpu_torch.models.seq2seq import MultiHeadAttention
from neurosync_trainer_lite_tpu_torch.ops import fused_attention as tfua

# the tolerances of test_torch_attention.py: fp32 the same math in another
# order; bf16 a few bf16 ulps of the O(0.1) outputs, the two packages
# rounding q, k, v and the output at the same points
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-3, rtol=0)}
# head width -> (hidden, heads)
WIDTHS = {48: (96, 2), 128: (256, 2), 24: (48, 2), 40: (80, 2)}


def _mha(h, dtype, impl, monkeypatch):
    """(the port's output, the JAX output, calls of the port's K4) of
    multi_head_attention at eval, hidden 2h with 2 heads, Tq = Tk = 16:
    the inputs of test_torch_attention.py:test_multi_head_attention_matches_jax
    at this width."""
    H, n = WIDTHS[h]
    rng = np.random.default_rng(2)
    params = {name: (rng.standard_normal((H, H)).astype(np.float32) * 0.05,
                     rng.standard_normal(H).astype(np.float32) * 0.01)
              for name in ("q", "k", "v", "out")}
    xq = rng.standard_normal((2, 16, H)).astype(np.float32)
    xkv = rng.standard_normal((2, 16, H)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = {name: {"w": jnp.asarray(w), "b": jnp.asarray(b)}
          for name, (w, b) in params.items()}
    theirs = jattn.multi_head_attention(
        jp, jnp.asarray(xq, jdt), jnp.asarray(xkv, jdt),
        jnp.asarray(xkv, jdt), num_heads=n, train=False, impl=impl)
    m = MultiHeadAttention(H, n, impl, "cpu")
    with torch.no_grad():
        for name, lin in (("q", m.q_linear), ("k", m.k_linear),
                          ("v", m.v_linear), ("out", m.out_linear)):
            lin.weight.copy_(torch.from_numpy(params[name][0].T.copy()))
            lin.bias.copy_(torch.from_numpy(params[name][1]))
        tq, tkv = (torch.from_numpy(a).to(dtype) for a in (xq, xkv))
        calls = []
        fused = tfua.fused_rope_attention

        def counted(*args):
            calls.append(args[0].shape)
            return fused(*args)

        monkeypatch.setattr(tfua, "fused_rope_attention", counted)
        ours = m(tq, tkv, tkv)
    assert ours.dtype == dtype
    return ours.float().numpy(), np.asarray(theirs, np.float32), calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [48, 128])
def test_multi_head_attention_at_pallas_matches_jax_at_wide_heads(
        h, dtype, monkeypatch):
    """Both packages run K4 at these widths. bf16 at h = 128 took the
    composed path before the widths were instantiated: 3.9e-3 from JAX,
    over half the elements a bf16 ulp apart; now each output is one rounding
    of nearly the same fp32 value, so few differ (under 5%)."""
    ours, theirs, calls = _mha(h, dtype, "pallas", monkeypatch)
    assert len(calls) == 1
    np.testing.assert_allclose(ours, theirs, **TOL[dtype])
    if dtype == torch.bfloat16:
        assert (ours != theirs).mean() < 0.05


@pytest.mark.parametrize("h,takes_k4", [(48, True), (128, True),
                                        (24, False), (40, False)])
def test_dispatch_takes_k4_at_every_multiple_of_16(h, takes_k4, monkeypatch):
    """fits_smem decides: K4 at multiples of 16 up to 128, the composed path
    at the other widths (the stated difference: JAX runs its kernel at any
    even width). In fp32 both agree with the JAX kernel within fp32 TOL."""
    assert tfua.fits_smem(16, 16, h, 4) == takes_k4
    ours, theirs, calls = _mha(h, torch.float32, "pallas", monkeypatch)
    assert calls == ([torch.Size([2, 16, 2 * h])] if takes_k4 else [])
    np.testing.assert_allclose(ours, theirs, **TOL[torch.float32])


def _inputs(seed, B, T, H):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("h", [48, 128])
def test_plain_forward_matches_jax_kernel_at_wide_heads(h):
    """fp32 throughout: atol/rtol 2e-5, as test_torch_attention.py."""
    H, n = WIDTHS[h]
    q, k, v, _ = _inputs(h, 2, 16, H)
    ours = tfua.fused_rope_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)),
        tfua.make_tables(16, 16, h, n, "cpu"), n, h ** -0.5)
    theirs = jfua.fused_rope_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jfua.make_tables(16, 16, h, n),
        n, h ** -0.5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("h", [48, 128])
def test_plain_backward_matches_jax_kernel_at_wide_heads(h):
    """jax.vjp through the JAX kernel's custom VJP (the Pallas backward in
    interpret mode); fp32, atol/rtol 2e-5 as test_torch_fused_attention_bwd.py."""
    H, n = WIDTHS[h]
    q, k, v, do = _inputs(h + 1, 2, 16, H)
    _, vjp = jax.vjp(lambda a, b, c: jfua.fused_rope_attention(
        a, b, c, jfua.make_tables(16, 16, h, n), n, h ** -0.5),
        *(jnp.asarray(a) for a in (q, k, v)))
    theirs = vjp(jnp.asarray(do))
    ours = tfua.fused_rope_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, do)),
        tfua.make_tables(16, 16, h, n, "cpu"), n, h ** -0.5)
    for name, a, b in zip("qkv", ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=2e-5, err_msg=f"d{name}")

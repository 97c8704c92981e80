"""Kernel K4's backward in the port against the JAX package.

The port's plain backward (fused_rope_attention_bwd_plain) and its autograd
Function are held against jax.vjp of the JAX fused_rope_attention, whose
custom VJP runs the Pallas backward kernel in interpret mode on the CPU,
and against torch autograd of the port's own plain forward. The CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
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

SHAPES = [(2, 16, 16, 64, 4), (1, 24, 24, 96, 6), (2, 16, 24, 64, 4)]


def _inputs(seed, B, Tq, Tk, H, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, H)).astype(dtype)
    k = rng.standard_normal((B, Tk, H)).astype(dtype)
    v = rng.standard_normal((B, Tk, H)).astype(dtype)
    do = rng.standard_normal((B, Tq, H)).astype(dtype)
    return q, k, v, do


def _jax_vjp(q, k, v, do, tables, n, scale, jdt=jnp.float32):
    args = [jnp.asarray(a, jdt) for a in (q, k, v)]
    _, vjp = jax.vjp(lambda q, k, v: jfua.fused_rope_attention(
        q, k, v, tables, n, scale), *args)
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, jdt))]


@pytest.mark.parametrize("B,Tq,Tk,H,n", SHAPES)
def test_plain_backward_matches_jax_kernel(B, Tq, Tk, H, n):
    """fp32 throughout, the same fp32 math in another order: atol/rtol 2e-5,
    the bound of the forward's comparison."""
    q, k, v, do = _inputs(0, B, Tq, Tk, H)
    hd = H // n
    theirs = _jax_vjp(q, k, v, do, jfua.make_tables(Tq, Tk, hd, n), n,
                      hd ** -0.5)
    ours = tfua.fused_rope_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, do)),
        tfua.make_tables(Tq, Tk, hd, n, "cpu"), n, hd ** -0.5)
    for name, a, b in zip("qkv", ours, theirs):
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5, rtol=2e-5,
                                   err_msg=f"d{name}")


def test_plain_backward_with_arbitrary_tables():
    """The transpose rotation wraps around the full H row, as _rot_t does,
    for tables that are not RoPE's too (same fp32 bound)."""
    B, T, H, n = 2, 8, 32, 2
    q, k, v, do = _inputs(1, B, T, T, H)
    rng = np.random.default_rng(2)
    tables = [rng.standard_normal((T, H)).astype(np.float32) for _ in range(6)]
    theirs = _jax_vjp(q, k, v, do, tuple(jnp.asarray(t) for t in tables), n,
                      0.25)
    ours = tfua.fused_rope_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, do)),
        tuple(torch.from_numpy(t) for t in tables), n, 0.25)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,Tq,Tk,H,n", SHAPES[:1] + SHAPES[2:])
def test_autograd_function_is_the_plain_backward(B, Tq, Tk, H, n):
    """On CPU tensors the Function's backward is the plain backward (equal),
    and both agree with torch autograd through the plain forward (fp32,
    1e-5: the same products summed in another order)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, B, Tq, Tk, H))
    hd = H // n
    tables = tfua.make_tables(Tq, Tk, hd, n, "cpu")
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    tfua.fused_rope_attention(qa, ka, va, tables, n, hd ** -0.5).backward(do)
    plain = tfua.fused_rope_attention_bwd_plain(q, k, v, do, tables, n,
                                                hd ** -0.5)
    for got, want in zip((qa.grad, ka.grad, va.grad), plain):
        assert torch.equal(got, want)
    qb, kb, vb = (t.clone().requires_grad_(True) for t in (q, k, v))
    tfua.fused_rope_attention_plain(qb, kb, vb, tables, n,
                                    hd ** -0.5).backward(do)
    for got, want in zip(plain, (qb.grad, kb.grad, vb.grad)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_bf16_backward_matches_jax_kernel():
    """bf16 in and out, fp32 inside on both sides: each output is one bf16
    rounding of nearly the same fp32 value, so they agree within one bf16
    ulp of the largest gradient (at most 2^-7 · max|g|)."""
    B, T, H, n = 2, 16, 64, 4
    q, k, v, do = _inputs(4, B, T, T, H)
    hd = H // n
    theirs = _jax_vjp(q, k, v, do, jfua.make_tables(T, T, hd, n), n,
                      hd ** -0.5, jnp.bfloat16)
    ours = tfua.fused_rope_attention_bwd_plain(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v, do)),
        tfua.make_tables(T, T, hd, n, "cpu"), n, hd ** -0.5)
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                   atol=2 ** -7 * np.abs(b).max())


def test_training_attention_at_pallas_matches_jax_grads():
    """multi_head_attention at 'pallas', train=True, dropout 0: K4 forward
    and backward on both sides, gradients of the inputs and all weights
    within 2e-5 (fp32)."""
    rng = np.random.default_rng(5)
    B, T, H, n = 2, 16, 64, 4
    params = {name: (rng.standard_normal((H, H)).astype(np.float32) * 0.05,
                     rng.standard_normal(H).astype(np.float32) * 0.01)
              for name in ("q", "k", "v", "out")}
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    dy = rng.standard_normal((B, T, H)).astype(np.float32)
    jp = {name: {"w": jnp.asarray(w), "b": jnp.asarray(b)}
          for name, (w, b) in params.items()}

    def f(p, x):
        return jattn.multi_head_attention(
            p, x, x, x, num_heads=n, dropout_rate=0.0,
            rng=jax.random.PRNGKey(0), train=True, impl="pallas")

    _, vjp = jax.vjp(f, jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))

    m = MultiHeadAttention(H, n, "pallas", "cpu")
    with torch.no_grad():
        for name, lin in (("q", m.q_linear), ("k", m.k_linear),
                          ("v", m.v_linear), ("out", m.out_linear)):
            lin.weight.copy_(torch.from_numpy(params[name][0].T.copy()))
            lin.bias.copy_(torch.from_numpy(params[name][1]))
    xt = torch.from_numpy(x).requires_grad_(True)
    m(xt, xt, xt, seed=0).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=2e-5,
                               rtol=2e-5)
    for name, lin in (("q", m.q_linear), ("k", m.k_linear),
                      ("v", m.v_linear), ("out", m.out_linear)):
        np.testing.assert_allclose(lin.weight.grad.numpy().T,
                                   np.asarray(jgp[name]["w"]), atol=2e-5,
                                   rtol=2e-5, err_msg=name)
        np.testing.assert_allclose(lin.bias.grad.numpy(),
                                   np.asarray(jgp[name]["b"]), atol=2e-5,
                                   rtol=2e-5, err_msg=name)

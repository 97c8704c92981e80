"""Kernel K4's backward in the port against the JAX package.

The port's plain backward (fused_rope_attention_bwd_plain) and its autograd
Function are held against jax.vjp of the JAX fused_rope_attention, whose
custom VJP runs the Pallas backward kernel in interpret mode on the CPU,
and against torch autograd of the port's own plain forward. The CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py); the bf16 kernel's
arithmetic (split-bf16 products on the tensor cores) is emulated here and
held against the JAX kernel within the card's bound.
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
from neurosync_trainer_lite_tpu_torch.ops.rope_kernel import rope_rotate_plain

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


# ---------------------------------------------------------------------------
# the arithmetic of the bf16 tensor-core backward (csrc/fused_attention.cu,
# attn_bwd_mma_kernel), emulated here, against the JAX kernel: what the card
# computes meets the card checks' bound before any card is involved

LOG2E = np.float32(1.4426950408889634)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _mm3(a, b):
    """a·b with both fp32 operands split once into bf16 hi + lo: three
    products of bf16 values (hi·hi + hi·lo + lo·hi) into one fp32 sum."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return ah @ bh + ah @ bl + al @ bh


def _mm2(a, b):
    """a·b with the fp32 operand a split, b exact in bf16: two products."""
    ah, al = _split(a)
    return ah @ b + al @ b


def _card_backward(q, k, v, do, tables, n, scale):
    """The kernel's rounding points: q and k rotated in fp32, split; q·kᵀ
    split (three products), dO·vᵀ one; exp2(fma(s, c, −m)) with c =
    scale·log2(e) in fp32 and m = c·max s; D from the unrounded p and dp;
    ds·k and dsᵀ·q split on both sides, pᵀ·dO on p's; then the transpose
    rotation in fp32 and one bf16 rounding (the wrapper's K1)."""
    qf = tfua._rot(q.float(), *tables[:3])
    kf = tfua._rot(k.float(), *tables[3:])
    vf, dof = v.float(), do.float()
    hd = q.shape[-1] // n
    c = float(np.float32(scale) * LOG2E)
    dq, dk, dv = (torch.empty_like(t) for t in (qf, kf, vf))
    for h in range(n):
        sl = slice(h * hd, (h + 1) * hd)
        s = _mm3(qf[..., sl], kf[..., sl].transpose(-1, -2))
        m = s.amax(-1, keepdim=True) * c
        e = torch.exp2((s.double() * c - m.double()).float())
        inv = 1.0 / e.sum(-1, keepdim=True)
        dp = dof[..., sl] @ vf[..., sl].transpose(-1, -2)
        p = e * inv
        ds = p * (dp - (e * dp).sum(-1, keepdim=True) * inv)
        dq[..., sl] = _mm3(ds, kf[..., sl]) * scale
        dk[..., sl] = _mm3(ds.transpose(-1, -2), qf[..., sl]) * scale
        dv[..., sl] = _mm2(p.transpose(-1, -2), dof[..., sl])
    dq = rope_rotate_plain(dq, *tables[:3], transpose=True)
    dk = rope_rotate_plain(dk, *tables[3:], transpose=True)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


# (B, T, H, heads, cancelling): the training head width 64 and the
# fixture's 16 at T = 128; cancelling: dO = the output + 1% noise, so the
# sums over ds cancel
CARD_CASES = [(2, 128, 128, 2, False), (2, 128, 128, 8, False),
              (2, 128, 128, 2, True)]


@pytest.mark.parametrize("B,T,H,n,cancelling", CARD_CASES)
def test_card_backward_meets_the_card_limit_against_jax(B, T, H, n,
                                                        cancelling):
    """The emulated kernel against the JAX backward in bf16 (interpret
    mode) within the card checks' bound (chip_smoke.py k4_backward,
    tests/test_torch_cuda_kernels.py bwd_limit): one bf16 ulp of each
    element (2^-7 of it) plus 1e-4 of the largest gradient."""
    q, k, v, _ = _inputs(7, B, T, T, H)
    hd = H // n
    scale = hd ** -0.5
    jtables = jfua.make_tables(T, T, hd, n)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    out, vjp = jax.vjp(lambda a, b, c: jfua.fused_rope_attention(
        a, b, c, jtables, n, scale), jq, jk, jv)
    noise = np.random.default_rng(8).standard_normal(out.shape)
    do = (np.asarray(out, np.float32) + 0.01 * noise if cancelling
          else noise).astype(np.float32)
    theirs = vjp(jnp.asarray(do, jnp.bfloat16))
    ours = _card_backward(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)),
        tfua.make_tables(T, T, hd, n, "cpu"), n, scale)
    for name, a, b in zip(("dq", "dk", "dv"), ours, theirs):
        ref = torch.from_numpy(np.asarray(b, np.float32))
        diff = (a.float() - ref).abs()
        limit = 2.0 ** -7 * ref.abs() + 1e-4 * ref.abs().max()
        assert bool((diff <= limit).all()), (name, diff.max().item(),
                                             ref.abs().max().item())

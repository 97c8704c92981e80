"""Attention and kernel K4 (forward) of the port against the JAX package.

The port's plain K4 is compared with the JAX Pallas kernel
fused_rope_attention, run in interpret mode on the CPU; the port's
multi_head_attention with the JAX one at eval (train=False).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neurosync_trainer_lite_tpu.ops import attention as jattn
from neurosync_trainer_lite_tpu.ops import fused_attention as jfua
from neurosync_trainer_lite_tpu_torch.models.seq2seq import MultiHeadAttention
from neurosync_trainer_lite_tpu_torch.ops import attention as tattn
from neurosync_trainer_lite_tpu_torch.ops import fused_attention as tfua

SHAPES = [(2, 16, 16, 64, 4), (1, 24, 24, 96, 6), (3, 8, 8, 32, 2),
          (2, 16, 24, 64, 4)]  # B, Tq, Tk, H, heads; the last is cross-length


@pytest.mark.parametrize("B,Tq,Tk,H,n", SHAPES)
def test_plain_fused_forward_matches_jax_kernel(B, Tq, Tk, H, n):
    """fp32 throughout: atol/rtol 2e-5, as the JAX kernel's own test."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, Tq, H)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H)).astype(np.float32)
    hd = H // n
    ours = tfua.fused_rope_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tfua.make_tables(Tq, Tk, hd, n, "cpu"), n, hd ** -0.5)
    theirs = jfua.fused_rope_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jfua.make_tables(Tq, Tk, hd, n), n, hd ** -0.5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5,
                               rtol=2e-5)


def test_plain_fused_forward_with_arbitrary_tables():
    """The rotation wraps around the full H row, as the Pallas _rot does,
    so it agrees for tables that are not RoPE's too."""
    rng = np.random.default_rng(1)
    B, T, H, n = 2, 8, 32, 2
    q, k, v = (rng.standard_normal((B, T, H)).astype(np.float32)
               for _ in range(3))
    tables = [rng.standard_normal((T, H)).astype(np.float32) for _ in range(6)]
    ours = tfua.fused_rope_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tuple(torch.from_numpy(t) for t in tables), n, 0.25)
    theirs = jfua.fused_rope_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        tuple(jnp.asarray(t) for t in tables), n, 0.25)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5,
                               rtol=2e-5)


def _params(rng, H):
    return {name: (rng.standard_normal((H, H)).astype(np.float32) * 0.05,
                   rng.standard_normal(H).astype(np.float32) * 0.01)
            for name in ("q", "k", "v", "out")}


def _port_mha(params, H, n, impl):
    m = MultiHeadAttention(H, n, impl, "cpu")
    with torch.no_grad():
        for name, lin in (("q", m.q_linear), ("k", m.k_linear),
                          ("v", m.v_linear), ("out", m.out_linear)):
            lin.weight.copy_(torch.from_numpy(params[name][0].T.copy()))
            lin.bias.copy_(torch.from_numpy(params[name][1]))
    return m


# bf16: both sides round q/k/v, the scores, the weights and the output to
# bf16, but at different places (the JAX CPU RoPE rounds its tables and
# products; 'pallas' keeps fp32 inside the fused kernel on both sides), so
# they agree to a few bf16 ulps of the O(0.1) outputs (one ulp is 2^-11
# there): atol 2e-3.
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-3, rtol=0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("Tk", [16, 24])
def test_multi_head_attention_matches_jax(dtype, impl, Tk):
    rng = np.random.default_rng(2)
    H, n, Tq = 64, 4, 16
    params = _params(rng, H)
    xq = rng.standard_normal((2, Tq, H)).astype(np.float32)
    xkv = rng.standard_normal((2, Tk, H)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = {name: {"w": jnp.asarray(w), "b": jnp.asarray(b)}
          for name, (w, b) in params.items()}
    theirs = jattn.multi_head_attention(
        jp, jnp.asarray(xq, jdt), jnp.asarray(xkv, jdt), jnp.asarray(xkv, jdt),
        num_heads=n, train=False, impl=impl)
    m = _port_mha(params, H, n, impl)
    with torch.no_grad():
        tq = torch.from_numpy(xq).to(dtype)
        tkv = torch.from_numpy(xkv).to(dtype)
        ours = m(tq, tkv, tkv)
    assert ours.dtype == dtype
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(theirs, np.float32), **TOL[dtype])


def test_linear_rounds_once_after_the_fp32_bias():
    """_linear: fp32 accumulation, fp32 bias add, one bf16 rounding — the
    JAX _linear exactly, since bf16 products are exact in fp32."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    theirs = jattn._linear(jnp.asarray(x, jnp.bfloat16),
                           {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    ours = tattn._linear(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=2 ** -8, atol=1e-6)


def test_shared_memory_gate():
    """The serving and training geometry (T=128, head_dim=64) fits in bf16
    and fp32. At T=128 in bf16 every multiple of 16 up to 128 is taken and
    every other width declined (it takes the composed path), as K3's
    supports(head_dim=...). Lengths the kernels cannot hold are refused
    before dispatch. The gate is the backward's budget, as the JAX
    fits_vmem: T=400 fits the forward alone but not the backward, and the
    fp32 backward at h=128, T=128 needs 263,680 B."""
    assert tfua.HEAD_DIMS == tuple(range(16, 129, 16))
    for h in range(1, 200):
        assert tfua.fits_smem(128, 128, h, 2) == (h % 16 == 0 and h <= 128), h
    assert tfua.fits_smem(128, 128, 64, 4)
    assert tfua.fwd_smem_bytes(400, 64, 2) <= tfua.SMEM_BUDGET
    assert tfua.fwd_smem_bytes(400, 64, 4) <= tfua.SMEM_BUDGET
    assert not tfua.fits_smem(400, 400, 64, 2)
    assert not tfua.fits_smem(2048, 2048, 64, 2)
    assert tfua.bwd_smem_bytes(128, 128, 128, 4) == 263_680
    assert not tfua.fits_smem(128, 128, 128, 4)
    assert not tfua.fits_smem(128, 128, 8, 2)


# ---------------------------------------------------------------------------
# the arithmetic of the bf16 tensor-core forward (csrc/fused_attention.cu,
# attn_fwd_mma_kernel), emulated here, against the JAX kernel: what the card
# computes meets the card checks' bound (fua.fwd_limit) before any card is
# involved

LOG2E = np.float32(1.4426950408889634)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _card_forward(q, k, v, tables, n, scale):
    """The kernel's rounding points: q and k rotated in fp32 and split into
    bf16 hi + lo; q·kᵀ as hi·hi + hi·lo + lo·hi; exp2(fma(s, c, −m)) with
    c = scale·log2(e) in fp32 and m = c·max s; p·v with p split and v
    exact; the sum of exp divided out last; one bf16 rounding."""
    qf = tfua._rot(q.float(), *tables[:3])
    kf = tfua._rot(k.float(), *tables[3:])
    vf = v.float()
    hd = q.shape[-1] // n
    c = float(np.float32(scale) * LOG2E)
    out = torch.empty_like(qf)
    for h in range(n):
        sl = slice(h * hd, (h + 1) * hd)
        (qh, ql), (kh, kl) = _split(qf[..., sl]), _split(kf[..., sl])
        kh, kl = kh.transpose(-1, -2), kl.transpose(-1, -2)
        s = qh @ kh + qh @ kl + ql @ kh
        m = s.amax(-1, keepdim=True) * c
        e = torch.exp2((s.double() * c - m.double()).float())
        eh, el = _split(e)
        out[..., sl] = (eh @ vf[..., sl] + el @ vf[..., sl]) / e.sum(
            -1, keepdim=True)
    return out.to(torch.bfloat16)


# (B, T, H, heads): the serving and training head width 64, and 48 and 128
@pytest.mark.parametrize("B,T,H,n", [(2, 128, 128, 2), (2, 128, 96, 2),
                                     (2, 128, 256, 2)])
def test_card_forward_meets_the_card_limit_against_jax(B, T, H, n):
    """The emulated kernel against the JAX forward in bf16 (interpret mode)
    within fua.fwd_limit, the card checks' bound: one bf16 ulp of each
    element (2^-7 of it) plus 1e-4 of the largest output."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((B, T, H)).astype(np.float32)
               for _ in range(3))
    hd = H // n
    theirs = jfua.fused_rope_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jfua.make_tables(T, T, hd, n), n, hd ** -0.5)
    ours = _card_forward(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                         tfua.make_tables(T, T, hd, n, "cpu"), n, hd ** -0.5)
    ref = torch.from_numpy(np.asarray(theirs, np.float32))
    diff = (ours.float() - ref).abs()
    assert bool((diff <= tfua.fwd_limit(ref, torch.bfloat16)).all()), (
        diff.max().item(), ref.abs().max().item())

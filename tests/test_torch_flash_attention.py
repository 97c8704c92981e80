"""Kernel K3 (flash attention) of the port against the JAX package.

The port's flash_attention takes its plain versions on the CPU; the JAX one
runs its Pallas kernels in interpret mode, as the JAX package's own tests
do. The same numpy inputs go to both. Then the dispatch that reaches K3
(sdpa, multi_head_attention), a training step at a 512-frame window and the
bytes API at frame_size=512, each against the JAX package.
"""

import io
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neurosync_trainer_lite_tpu.config import Config as JConfig
from neurosync_trainer_lite_tpu.inference import api as japi
from neurosync_trainer_lite_tpu.models import seq2seq as jmodel
from neurosync_trainer_lite_tpu.ops import attention as jattn
from neurosync_trainer_lite_tpu.ops import flash_attention as jfa
from neurosync_trainer_lite_tpu.training import step as jstep
from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.inference import api as tapi
from neurosync_trainer_lite_tpu_torch.models.seq2seq import (
    MultiHeadAttention,
    Seq2Seq,
)
from neurosync_trainer_lite_tpu_torch.ops import attention as tattn
from neurosync_trainer_lite_tpu_torch.ops import flash_attention as tfa
from neurosync_trainer_lite_tpu_torch.ops import fused_attention as tfua
from neurosync_trainer_lite_tpu_torch.training import step as tstep
from neurosync_trainer_lite_tpu_torch.utils.weights import params_from_jax

BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value

# (B, N, Tq, Tk, h): the shapes of tests/test_flash_attention.py (96 rows is
# a ragged query tile), its cross-attention lengths, kv_len 512 at the
# fixture's head width, and at widths off the powers of two that K3 takes
# (48, 96: every multiple of 16 up to 128)
SHAPES = [(2, 4, 128, 128, 64), (1, 2, 96, 96, 32), (2, 1, 256, 256, 64),
          (2, 2, 128, 192, 64), (1, 2, 512, 512, 16), (1, 1, 512, 512, 48),
          (1, 1, 512, 512, 96)]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _f32(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _assert_close(ours, theirs, dtype, what=""):
    """fp32: 2e-5 (the fp32 rule). bf16: the same fp32 math rounded at the
    same points, summed in another order, so an element may round to the
    neighbouring bf16 value: one bf16 ulp of the largest magnitude."""
    a, b = _f32(ours), _f32(theirs)
    if dtype == torch.float32:
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5, err_msg=what)
    else:
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=BF16_ULP * np.abs(b).max(),
                                   err_msg=what)


def _qkv(shape, seed=0):
    B, N, Tq, Tk, h = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N, Tq, h)).astype(np.float32),
            rng.standard_normal((B, N, Tk, h)).astype(np.float32),
            rng.standard_normal((B, N, Tk, h)).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_matches_jax(shape, dtype):
    """Forward, and the gradients of sum(sin(out)) through both VJPs. In
    bf16 both sides get the same cotangent (cos of the JAX output, rounded
    to bf16), so the check reads the kernels' VJPs alone."""
    q, k, v = _qkv(shape)
    jq, jk, jv = (jnp.asarray(a, JDT[dtype]) for a in (q, k, v))
    theirs, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, None),
                          jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_(True)
                  for a in (q, k, v))
    ours = tfa.flash_attention(tq, tk, tv)
    assert ours.dtype == dtype and ours.shape == theirs.shape
    _assert_close(ours, theirs, dtype, "out")

    cot = np.cos(np.asarray(theirs, np.float32))
    if dtype == torch.float32:
        torch.sin(ours).sum().backward()
        jgrads = jax.grad(lambda a, b, c: jnp.sum(jnp.sin(
            jfa.flash_attention(a, b, c, None))), argnums=(0, 1, 2))(jq, jk, jv)
    else:
        ours.backward(torch.from_numpy(cot).to(dtype))
        jgrads = vjp(jnp.asarray(cot, jnp.bfloat16))
    for name, g, jg in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        assert g.dtype == dtype
        _assert_close(g, jg, dtype, f"d{name}")


def test_flash_attention_scale_and_plain_backward():
    """An explicit scale reaches both passes; the plain backward is the
    autograd Function's (the kernel's contract on the CPU)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 40, 24, 16), 1))
    do = torch.randn(1, 2, 40, 16, generator=torch.Generator().manual_seed(0))
    theirs = jfa.flash_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                 jnp.asarray(v.numpy()), 0.3)
    _assert_close(tfa.flash_attention(q, k, v, 0.3), theirs, torch.float32)
    args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.flash_attention(*args, 0.3).backward(do)
    for g, want in zip(args, tfa.flash_attention_bwd_plain(q, k, v, do, 0.3)):
        assert torch.equal(g.grad, want)


def test_kernel_limit_admits_one_bf16_ulp_and_not_two():
    """The card checks' bound: one bf16 ulp of every element passes, two
    ulps of the largest do not; fp32 is 1e-5 of the largest value."""
    ref = torch.tensor([1.0, -0.375, 0.0078125, 3e-4]).to(torch.bfloat16)
    up = torch.nextafter(ref, torch.full_like(ref, 8.0))
    limit = tfa.kernel_limit(ref, torch.bfloat16)
    assert bool(((up.float() - ref.float()).abs() <= limit).all())
    twice = torch.nextafter(up, torch.full_like(up, 8.0))
    assert (twice.float() - ref.float())[0] > limit[0]
    ref32 = ref.float()
    assert torch.allclose(tfa.kernel_limit(ref32, torch.float32),
                          torch.full_like(ref32, 1e-5), rtol=0, atol=1e-30)


def test_supports_gate():
    assert tfa.supports(2048, 0.0, 123) and tfa.supports(16, 0.3, None)
    assert not tfa.supports(2049, 0.0, None)
    assert not tfa.supports(512, 0.3, 123)
    assert (tfa.MIN_KV_LEN_AUTO, tfa.MAX_KV_LEN) == (jfa.MIN_KV_LEN_AUTO,
                                                      jfa.MAX_KV_LEN)


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the calls that sdpa makes to the port's flash_attention."""
    calls = []
    real = tfa.flash_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tfa, "flash_attention", spy)
    return calls


# (impl, (B, N, Tq, Tk, h), dtype, whether K3 is taken): 'auto' from kv_len
# 512 on; 'pallas' at any length up to MAX_KV_LEN (T = 400, head_dim 64 in
# bf16 is past K4's gate); neither above it, nor 'xla'
DISPATCH = [("auto", (1, 2, 512, 512, 16), torch.float32, True),
            ("auto", (1, 2, 511, 511, 16), torch.float32, False),
            ("auto", (1, 2, 512, 512, 16), torch.bfloat16, True),
            ("pallas", (1, 2, 24, 2049, 16), torch.float32, False),
            ("pallas", (1, 1, 400, 400, 64), torch.bfloat16, True),
            ("xla", (1, 2, 512, 512, 16), torch.float32, False)]


@pytest.mark.parametrize("impl,shape,dtype,taken", DISPATCH)
def test_sdpa_dispatch_matches_jax(flash_calls, impl, shape, dtype, taken):
    q, k, v = _qkv(shape, 2)
    ours = tattn.sdpa(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
                      impl=impl)
    theirs = jattn.sdpa(*(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)),
                        impl=impl)
    assert bool(flash_calls) == taken
    _assert_close(ours, theirs, dtype)


def test_active_dropout_keeps_the_composed_path(flash_calls):
    """At kv_len 512 with attention dropout on, 'auto' and 'pallas' take the
    composed path (JAX supports()): the port's own composed result with the
    same seed, bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 512, 512, 16), 3))
    kw = dict(dropout_rate=0.3, seed=11, train=True)
    want = tattn.sdpa(q, k, v, impl="xla", **kw)
    for impl in ("auto", "pallas"):
        assert torch.equal(tattn.sdpa(q, k, v, impl=impl, **kw), want)
    assert not flash_calls
    # dropout off in eval: the kernel again
    tattn.sdpa(q, k, v, impl="auto", dropout_rate=0.3, seed=11, train=False)
    assert len(flash_calls) == 1


def test_pallas_attention_past_the_k4_gate_takes_k3(flash_calls):
    """bf16 at T=400, head_dim 64: K4's shared-memory gate fails, so
    multi_head_attention at 'pallas' rotates with K1 and attends with K3,
    as the JAX sdpa at 'pallas' (held above) does."""
    assert not tfua.fits_smem(400, 400, 64, 2)
    m = MultiHeadAttention(128, 2, "pallas", "cpu")
    with torch.no_grad():
        for prm in m.parameters():
            prm.copy_(torch.randn(prm.shape, generator=torch.Generator()
                                  .manual_seed(prm.numel())) * 0.05)
        x = torch.randn(1, 400, 128).bfloat16()
        out = m(x, x, x)
    assert out.shape == x.shape and torch.isfinite(out.float()).all()
    assert flash_calls == [torch.Size([1, 2, 400, 64])]


def test_supports_declines_only_widths_k3_does_not_tile():
    """fa.supports(head_dim=...): every multiple of 16 up to 128 is taken,
    the rest declined; without a width the gate is the JAX supports()."""
    assert tfa.HEAD_DIMS == tuple(range(16, 129, 16))
    for h in range(1, 200):
        assert tfa.supports(512, 0.0, None, head_dim=h) == (
            h % 16 == 0 and h <= 128), h
    assert tfa.supports(512, 0.0, None)
    assert not tfa.supports(2049, 0.0, None, head_dim=64)
    assert not tfa.supports(512, 0.3, 7, head_dim=64)


# (impl, (B, N, Tq, Tk, h), whether K3 is taken), bf16: h = 48 takes K3 at
# 'auto' from kv_len 512 and at 'pallas' at any length; h = 40 is no
# multiple of 16, so by the stated rule it takes the composed path
WIDTH_DISPATCH = [("auto", (1, 2, 512, 512, 48), True),
                  ("pallas", (2, 2, 128, 128, 48), True),
                  ("auto", (1, 2, 512, 512, 40), False),
                  ("pallas", (2, 2, 128, 128, 40), False)]


@pytest.mark.parametrize("impl,shape,taken", WIDTH_DISPATCH)
def test_sdpa_at_other_head_widths_matches_jax_k3(flash_calls, impl, shape,
                                                  taken):
    """Against the JAX sdpa, which takes its Pallas flash kernel at every
    one of these widths. Where the port takes K3: one bf16 ulp of the
    largest output, as above. Where it takes the composed path, the bf16
    composed tolerance: its scores and weights are rounded to bf16 before
    the product with v (the JAX kernel keeps them fp32), and an O(10)
    score rounded to bf16 moves by up to 2^-9 of itself, its weight by as
    much relative: 2^-4 of the largest output covers that (these inputs
    reach 2^-6.0 at 'auto', 2^-6.9 at 'pallas'), where one ulp would not."""
    q, k, v = _qkv(shape, 9)
    ours = tattn.sdpa(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                      impl=impl)
    theirs = jattn.sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                        impl=impl)
    assert bool(flash_calls) == taken
    if taken:
        _assert_close(ours, theirs, torch.bfloat16)
    else:
        b = _f32(theirs)
        np.testing.assert_allclose(_f32(ours), b, rtol=0,
                                   atol=2.0 ** -4 * np.abs(b).max())


# ---------------------------------------------------------------------------
# the slice: a training step at window 512, and serving at frame_size=512

GEOM = dict(hidden_dim=64, n_layers=2, num_heads=4, input_dim=32,
            output_dim=7, dropout=0.0, batch_size=2, micro_batch_size=512,
            use_amp=False)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_train_step_at_window_512_matches_jax(flash_calls, impl):
    """fp32, dropout 0, batch 2 x 512 frames: loss and pre-clip grad norm
    within 1e-5 relative for 3 steps. At 'auto' every attention takes K3
    (kv_len 512); at 'pallas' head_dim 16 fits K4's gate, so K4 runs."""
    jcfg, tcfg = JConfig(**GEOM, attention_impl=impl), Config(
        **GEOM, attention_impl=impl)
    params = jmodel.init_seq2seq(jax.random.PRNGKey(1), jcfg)
    js, tx = jstep.init_train_state(jcfg, 5, params=params)
    jf = jstep.make_train_step(jcfg, tx, donate=False)
    ts = tstep.init_train_state(tcfg, 5, device="cpu", state_dict=params_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    tf = tstep.make_train_step(tcfg)
    rng = np.random.default_rng(0)
    src = rng.standard_normal((2, 512, 32)).astype(np.float32)
    trg = (rng.standard_normal((2, 512, 7)) * 0.5).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        js, jl, jn = jf(js, jnp.asarray(src), jnp.asarray(trg),
                        jax.random.PRNGKey(i))
        ts, tl, tn = tf(ts, torch.from_numpy(src), torch.from_numpy(trg), gen)
        assert np.isfinite(float(tl)) and np.isfinite(float(tn))
        assert float(tl) == pytest.approx(float(jl), rel=1e-5), i
        assert float(tn) == pytest.approx(float(jn), rel=1e-5), i
    # six attentions a forward at 2+2 layers (one a encoder layer, two a
    # decoder layer), three forwards
    assert len(flash_calls) == (3 * 6 if impl == "auto" else 0)


def _wav_bytes(seconds: float) -> bytes:
    with wave.open("dataset/test_set/audio.wav") as w:
        pcm = w.readframes(int(seconds * w.getframerate()))
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(88200)
        w.writeframes(pcm)
    return buf.getvalue()


def test_bytes_api_at_frame_size_512_matches_jax(flash_calls):
    """fp32, 10 s of the test-set WAV (601 frames: two 512-frame chunks at
    stride 496): every attention of the one batched forward takes K3 on the
    port's side and the Pallas kernel on JAX's; within 2e-5."""
    geom = dict(hidden_dim=32, n_layers=1, num_heads=2, dropout=0.0,
                use_amp=False, frame_size=512)
    jcfg, cfg = JConfig(**geom), Config(**geom)
    params = jmodel.init_seq2seq(jax.random.PRNGKey(0), jcfg)
    model = Seq2Seq(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg), strict=True)
    wav = _wav_bytes(10.0)
    theirs = np.asarray(japi.generate_facial_data_from_bytes(wav, params, jcfg))
    ours = tapi.generate_facial_data_from_bytes(wav, model.eval(), cfg,
                                                device="cpu")
    assert ours.shape == theirs.shape == (601, 61)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, atol=2e-5, rtol=0)
    assert len(flash_calls) == 3


# ---------------------------------------------------------------------------
# the arithmetic of the bf16 tensor-core kernels (csrc/flash_attention.cu),
# emulated here, against the JAX kernel: what the card computes meets
# kernel_limit, the card checks' bound, before any card is involved

LOG2E = np.float32(1.4426950408889634)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split_mm(x, y):
    """x·y as the card's backward takes it: the fp32 operand x split once
    into hi = bf16(x) and lo = bf16(x − hi), y exact in bf16, two products
    of bf16 values accumulated in fp32."""
    hi = _bf16(x)
    return torch.matmul(hi, y) + torch.matmul(_bf16(x - hi), y)


def _card_softmax(qf, kf, scale):
    """exp2(fma(s, c, −m)) with c = scale·log2(e) rounded to fp32, as the
    launch computes it, and m = c·max s (one rounding, as the FFMA): the
    unnormalised p and 1/sum."""
    c = float(np.float32(scale) * LOG2E)
    s = torch.matmul(qf, kf.transpose(-1, -2))
    m = s.amax(-1, keepdim=True) * c
    e = torch.exp2((s.double() * c - m.double()).float())
    return e, 1.0 / e.sum(-1, keepdim=True)


def _card_forward(q, k, v, scale):
    """Two passes: p normalised, rounded to bf16 (JAX's rounding point),
    then one bf16 product with v."""
    e, inv = _card_softmax(q.float(), k.float(), scale)
    return torch.matmul(_bf16(e * inv), v.float()).to(torch.bfloat16)


def _card_backward(q, k, v, do, scale):
    """p and ds in fp32, D from the unrounded p and dp (the dq kernel's
    first pass), pᵀ·dO, ds·k and dsᵀ·q split into two bf16 products."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    e, inv = _card_softmax(qf, kf, scale)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    d = (e * dp).sum(-1, keepdim=True) * inv
    p = e * inv
    ds = p * (dp - d)
    dq = _split_mm(ds, kf) * scale
    dk = _split_mm(ds.transpose(-1, -2), qf) * scale
    dv = _split_mm(p.transpose(-1, -2), dof)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _within_kernel_limit(ours, theirs, what):
    ref = torch.from_numpy(np.array(_f32(theirs)))
    diff = (ours.float() - ref).abs()
    limit = tfa.kernel_limit(ref.to(torch.bfloat16), torch.bfloat16)
    assert bool((diff <= limit).all()), (
        what, diff.max().item(), ref.abs().max().item())


# (B, N, Tq, Tk, h, cancelling): kv_len 512 and MAX_KV_LEN at the model's
# head width 64 and at 16; cancelling: dO = the output + 1% noise, so the
# sums over ds cancel
SPLIT_CASES = [(1, 2, 512, 512, 64, False), (1, 2, 512, 512, 16, False),
               (1, 1, 256, 2048, 64, False), (1, 1, 256, 2048, 16, False),
               (1, 2, 512, 512, 64, True), (1, 2, 512, 512, 48, False)]


@pytest.mark.parametrize("B,N,Tq,Tk,h,cancelling", SPLIT_CASES)
def test_split_bf16_backward_meets_the_card_limit_against_jax(
        B, N, Tq, Tk, h, cancelling):
    q, k, v = _qkv((B, N, Tq, Tk, h), 4)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, None),
                       jq, jk, jv)
    rng = np.random.default_rng(5)
    noise = rng.standard_normal(out.shape).astype(np.float32)
    do = (np.asarray(out, np.float32) + 0.01 * noise if cancelling
          else noise)
    jgrads = vjp(jnp.asarray(do, jnp.bfloat16))
    tq, tk, tv, tdo = (torch.from_numpy(np.asarray(a, np.float32))
                       .to(torch.bfloat16) for a in (q, k, v, do))
    grads = _card_backward(tq, tk, tv, tdo, h ** -0.5)
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        _within_kernel_limit(g, jg, name)


@pytest.mark.parametrize("h", [64, 16])
def test_card_forward_rounds_the_normalised_p_as_jax(h):
    """Tk = MAX_KV_LEN: p = bf16(exp2(fma(s, c, −m))·(1/sum)), one bf16
    product with v, against the JAX kernel in bf16."""
    q, k, v = _qkv((1, 2, 512, 2048, h), 6)
    theirs = jfa.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                   for a in (q, k, v)), None)
    ours = _card_forward(*(torch.from_numpy(a).to(torch.bfloat16)
                           for a in (q, k, v)), h ** -0.5)
    _within_kernel_limit(ours, theirs, "out")


def test_k3_variants_edit_constants_the_source_holds():
    """k3_variants.py builds each variant by replacing text of Mma<HD> in
    csrc/flash_attention.cu: each replaced text is there exactly once, and
    every variant but "as built" differs from the source."""
    import k3_variants
    from neurosync_trainer_lite_tpu_torch.ops import kernels

    source = (kernels.CSRC / "flash_attention.cu").read_text()
    assert k3_variants.VARIANTS["as built"] == {}
    for name, edits in k3_variants.VARIANTS.items():
        text = source
        for old, new in edits.items():
            assert source.count(old) == 1, (name, old)
            text = text.replace(old, new)
        assert (text != source) == bool(edits), name

"""K2, the fused FFN backward (ops/ffn_bwd.py), against the JAX package.

The port's plain ffn_bwd_dh1 (what CPU tensors run, and what the CUDA
kernel is held against on the card) against the Pallas kernel in interpret
mode at the JAX test's shapes; the FFN core with K2 (models/layers.py)
against JAX's ffn_lean_core_fused and against the same core without K2; a
bf16 train step routed through ffn_fused against the JAX step routed
through its ffn_fused. Inputs are seeded numpy arrays handed to both
packages; the port's core draws its mask from a seed, and JAX gets that
mask (dropout_keep). JAX's w2 is [F, H]; the port's linear2.weight is its
transpose.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neurosync_trainer_lite_tpu.models import seq2seq as jmodel
from neurosync_trainer_lite_tpu.ops import ffn_bwd_pallas as jffn
from neurosync_trainer_lite_tpu_torch.models import layers
from neurosync_trainer_lite_tpu_torch.models import seq2seq as tmodel
from neurosync_trainer_lite_tpu_torch.ops import ffn_bwd
from neurosync_trainer_lite_tpu_torch.ops.attention import _bf16_value, dropout_keep

BF16_ULP = 2.0 ** -7       # one bf16 ulp is at most 2^-7 of the value
Q77 = 256.0 / (256 - 77)   # dropout 0.3's inverted scale, unrounded


def _f32(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _within_one_ulp(ours, theirs, what):
    """bf16 values rounded from the same fp32 math summed in another order:
    one bf16 ulp of the value, plus 1e-5 of the largest where a sum cancels
    (chip_smoke.py's criterion for the kernels)."""
    a, b = _f32(ours), _f32(theirs)
    limit = BF16_ULP * np.abs(b) + 1e-5 * np.abs(b).max() + 1e-30
    assert np.all(np.abs(a - b) <= limit), (what, np.abs(a - b).max())


def _inputs(M, H, F, seed):
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((M, H)).astype(np.float32)
    w = rng.standard_normal((H, F)).astype(np.float32)   # torch layout
    raw = rng.standard_normal((M, F)).astype(np.float32)
    am = np.where(raw > 0.3, raw, 0.0).astype(np.float32)  # nonneg, sparse
    return dy, w, am


@pytest.mark.parametrize("M,H,F", [(256, 128, 512), (128, 128, 512),
                                   (96, 64, 192)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_the_pallas_kernel(M, H, F, dtype):
    """dh1 within 1e-5 of JAX's after the same rounding (fp32: the same
    sums in another order; bf16: equal but where that order moves the fp32
    value across a bf16 rounding boundary, one ulp); db2 and db1 fp32 sums
    in another order, 2e-4."""
    dy, w, am = _inputs(M, H, F, seed=M + F)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = [torch.from_numpy(a).to(tdt) for a in (dy, w, am)]
    dh1, db2, db1 = ffn_bwd.ffn_bwd_dh1(*t, scale=Q77)
    jd, jw, ja = (jnp.asarray(a, jdt) for a in (dy, w.T, am))
    jdh1, jdb2, jdb1 = jax.jit(
        lambda a, b, c: jffn.ffn_bwd_dh1(a, b, c, scale=Q77))(jd, jw, ja)
    assert dh1.dtype == tdt and dh1.shape == (M, F)
    assert db2.dtype == db1.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(_f32(dh1), _f32(jdh1), rtol=1e-5,
                                   atol=1e-5)
    else:
        _within_one_ulp(dh1, jdh1, "dh1")
        differ = np.mean(_f32(dh1) != _f32(jdh1))
        assert differ < 1e-3, differ
    np.testing.assert_allclose(_f32(db2), _f32(jdb2), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_f32(db1), _f32(jdb1), rtol=2e-4, atol=2e-4)


def test_scale_one_and_full_mask_is_the_rounded_product():
    """Dropout off (scale 1, every am kept): dh1 is dy·W rounded once."""
    dy, w, am = _inputs(64, 32, 96, seed=5)
    t = [torch.from_numpy(a).bfloat16() for a in (dy, w, np.abs(am) + 0.01)]
    dh1, db2, db1 = ffn_bwd.ffn_bwd_dh1(*t, scale=1.0)
    want = (t[0].float() @ t[1].float())
    assert torch.equal(dh1, want.bfloat16())
    torch.testing.assert_close(db1, want.sum(0), rtol=0, atol=0)
    assert db2.shape == (32,) and db1.shape == (96,)


def _core_inputs(seed, B=2, T=16, H=32, F=128):
    """Seeded inputs, the core's mask seed and its keep mask at dropout 0.3
    (q 77), as the core draws it."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    w1 = (rng.standard_normal((H, F)) * 0.05).astype(np.float32)  # JAX [in, out]
    b1 = (rng.standard_normal(F) * 0.01).astype(np.float32)
    w2 = (rng.standard_normal((F, H)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(H) * 0.01).astype(np.float32)
    keep = dropout_keep(seed, (B, T, F), 77, "cpu", split_dim=-1).numpy()
    dy = rng.standard_normal((B, T, H)).astype(np.float32)
    return x, w1, b1, w2, b2, seed, keep, dy


def _port_grads(k2, x, w1, b1, w2, b2, seed, q, dy, activation="relu"):
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    params = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
              for a in (w1.T, b1, w2.T, b2)]
    y = layers._FfnCore.apply(tx, *params, seed, q, activation, None, k2)
    y.backward(torch.from_numpy(dy).bfloat16())
    w1g, b1g, w2g, b2g = (p.grad for p in params)
    return y, (tx.grad, w1g.T, b1g, w2g.T, b2g)


@pytest.mark.parametrize("dropout", [True, False])
def test_fused_core_matches_jax(dropout):
    """The FFN core with K2 against ffn_lean_core_fused on the same bf16
    inputs and mask, at dropout 0.3's fp32 scale and at dropout 0 (the port
    draws no mask, JAX takes a mask of ones): forward and gradients within
    one bf16 ulp plus 1e-5 of the largest."""
    x, w1, b1, w2, b2, seed, keep, dy = _core_inputs(7)
    scale = Q77 if dropout else 1.0
    jkeep = keep if dropout else np.ones_like(keep)
    y, grads = _port_grads(True, x, w1, b1, w2, b2, seed,
                           77 if dropout else 0, dy)
    jargs = [jnp.asarray(x, jnp.bfloat16)] + [jnp.asarray(a) for a in
                                              (w1, b1, w2, b2)]
    jy, vjp = jax.vjp(lambda *a: jffn.ffn_lean_core_fused(
        *a, jnp.asarray(jkeep), scale), *jargs)
    jgrads = vjp(jnp.asarray(dy, jnp.bfloat16))
    _within_one_ulp(y, jy, "y")
    for name, ours, theirs in zip(("dx", "dw1", "db1", "dw2", "db2"), grads,
                                  jgrads):
        _within_one_ulp(ours, theirs, name)


def test_fused_core_forward_is_the_lean_core_and_grads_agree(monkeypatch):
    """At dropout 0.3 the forward with K2 is bitwise the one without (both
    scale am by the bf16-rounded scale); the gradients differ only in where
    the epilogue rounds (after the fp32 scale, not before it) and in db1's
    fp32 source: the JAX test's bf16 bound, 2e-2."""
    x, w1, b1, w2, b2, seed, _, dy = _core_inputs(8)
    calls = []
    real = ffn_bwd.ffn_bwd_dh1

    def spy(dy2, w2c, am, *, scale):
        calls.append((scale, am))
        return real(dy2, w2c, am, scale=scale)

    monkeypatch.setattr(ffn_bwd, "ffn_bwd_dh1", spy)
    y_f, g_f = _port_grads(True, x, w1, b1, w2, b2, seed, 77, dy)
    y_l, g_l = _port_grads(False, x, w1, b1, w2, b2, seed, 77, dy)
    assert torch.equal(y_f, y_l)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), g_f, g_l):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=2e-2, atol=2e-2,
                                   err_msg=name)
    # the fp32 scale reaches the epilogue: with the bf16-rounded one the
    # kernel's dh1 (hence db1) moves by 3.4e-4 relative
    (scale, am), = calls
    assert scale == Q77 != _bf16_value(Q77)
    dy2 = torch.from_numpy(dy).bfloat16().reshape(-1, dy.shape[-1])
    w2c = torch.from_numpy(np.ascontiguousarray(w2.T)).bfloat16()
    rounded = real(dy2, w2c, am, scale=_bf16_value(Q77))
    assert torch.equal(real(dy2, w2c, am, scale=Q77)[2], g_f[2])
    assert not torch.equal(rounded[2], g_f[2])


def test_k2_takes_only_the_relu():
    """K2's epilogue is the ReLU's derivative: the GELU core refuses it."""
    x, w1, b1, w2, b2, seed, _, dy = _core_inputs(9)
    with pytest.raises(ValueError, match="K2"):
        _port_grads(True, x, w1, b1, w2, b2, seed, 26, dy, "gelu")


def _ffn_module(rate, seed=3):
    rng = np.random.default_rng(seed)
    m = tmodel.FeedForward(32, 128, "cpu", rate)
    with torch.no_grad():
        for prm in m.parameters():
            prm.copy_(torch.from_numpy(
                rng.standard_normal(prm.shape).astype(np.float32) * 0.1))
    return m


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_ffn_fused_takes_the_default_paths_gates_and_mask(rate, monkeypatch):
    """ffn_fused drops what the default _ffn drops (one draw from the same
    seed site), its forward is bitwise the default's, and outside bf16
    training it is the plain composition."""
    m = _ffn_module(rate)
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(1))
    xb = x.bfloat16()
    assert torch.equal(layers.ffn_fused(m, xb, 11), m(xb, 11))
    assert torch.equal(layers.ffn_fused(m, x, 11), m(x, 11))      # fp32
    assert torch.equal(layers.ffn_fused(m, xb), m(xb))            # eval
    monkeypatch.setattr(tmodel, "_ffn", layers.ffn_fused)
    calls = []
    real = layers._FfnCore.apply
    monkeypatch.setattr(layers._FfnCore, "apply",
                        lambda *a: calls.append(a[-1]) or real(*a))
    m(xb, 11)
    assert calls == [True]      # one core, with K2


GEOM = dict(hidden_dim=64, n_layers=2, num_heads=4, input_dim=32,
            output_dim=7, batch_size=4, use_amp=True)


def test_patched_bf16_step_matches_the_patched_jax_step(monkeypatch):
    """A tiny bf16 train step at dropout 0 with both packages' _ffn routed
    through their ffn_fused (K2 in the backward; the Pallas kernel in
    interpret mode), three steps from the same weights and batch: the
    bounds of tests/test_torch_training.py's bf16 step (loss rel 1e-2,
    grad norm 5e-2: RoPE rounds its tables differently in the two)."""
    from neurosync_trainer_lite_tpu.config import Config as JConfig
    from neurosync_trainer_lite_tpu.training import step as jstep
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.training import step as tstep
    from neurosync_trainer_lite_tpu_torch.utils.weights import params_from_jax

    monkeypatch.setattr(jmodel, "_ffn", jffn.ffn_fused)
    monkeypatch.setattr(tmodel, "_ffn", layers.ffn_fused)
    jcfg, tcfg = JConfig(**GEOM, dropout=0.0), Config(**GEOM, dropout=0.0)
    params = jmodel.init_seq2seq(jax.random.PRNGKey(1), jcfg)
    js, tx = jstep.init_train_state(jcfg, 5, params=params)
    jf = jstep.make_train_step(jcfg, tx, donate=False)
    ts = tstep.init_train_state(
        tcfg, 5, device="cpu",
        state_dict=params_from_jax(jax.tree.map(np.asarray, params), tcfg))
    tf = tstep.make_train_step(tcfg)
    rng = np.random.default_rng(2)
    src = rng.standard_normal((4, 16, 32)).astype(np.float32)
    trg = (rng.standard_normal((4, 16, 7)) * 0.5).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    calls = []
    real = ffn_bwd.ffn_bwd_dh1
    monkeypatch.setattr(ffn_bwd, "ffn_bwd_dh1",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for i in range(3):
        js, jl, jn = jf(js, jnp.asarray(src), jnp.asarray(trg),
                        jax.random.PRNGKey(i))
        ts, tl, tn = tf(ts, torch.from_numpy(src), torch.from_numpy(trg), gen)
        assert float(tl) == pytest.approx(float(jl), rel=1e-2), i
        assert float(tn) == pytest.approx(float(jn), rel=5e-2), i
    assert len(calls) == 3 * 2 * 2      # 2 + 2 FFNs a step


def test_patched_step_at_dropout_draws_the_default_masks(monkeypatch):
    """At dropout 0.3, one bf16 step routed through ffn_fused and one
    through the default _ffn from the same weights, batch and generator:
    the same loss bit for bit (the same masks, a bit-identical forward),
    and gradients within the JAX test's bf16 bound (2e-2 of the largest)."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.training import step as tstep

    cfg = Config(**GEOM, dropout=0.3)
    rng = np.random.default_rng(4)
    src = torch.from_numpy(rng.standard_normal((4, 16, 32)).astype(np.float32))
    trg = torch.from_numpy(rng.random((4, 16, 7)).astype(np.float32))
    runs = []
    for fn in (tmodel._ffn, layers.ffn_fused):
        monkeypatch.setattr(tmodel, "_ffn", fn)
        state = tstep.init_train_state(
            cfg, 5, generator=torch.Generator().manual_seed(3), device="cpu")
        state, loss, norm = tstep.make_train_step(cfg)(
            state, src, trg, torch.Generator().manual_seed(9))
        runs.append((float(loss), float(norm),
                     {n: p.grad.clone() for n, p in
                      state.model.named_parameters()}))
    (l0, n0, g0), (l1, n1, g1) = runs
    assert l0 == l1
    assert n1 == pytest.approx(n0, rel=2e-2)
    for name, g in g0.items():
        if ".ffn." in name:
            scale = g.abs().max().item() + 1e-30
            assert (g1[name] - g).abs().max().item() <= 2e-2 * scale, name


def test_k2_variants_edit_text_the_source_holds():
    """k2_variants.py builds each variant by replacing text of
    csrc/ffn_bwd.cu: each replaced text is there exactly once, every
    variant but "as built" differs from the source, and each names the
    outputs it computes (the ones its check reads)."""
    import k2_variants
    from neurosync_trainer_lite_tpu_torch.ops import kernels

    source = (kernels.CSRC / "ffn_bwd.cu").read_text()
    assert k2_variants.VARIANTS["as built"] == ({}, ("dh1", "db2", "db1"))
    for name, (edits, outputs) in k2_variants.VARIANTS.items():
        assert outputs and set(outputs) <= {"dh1", "db2", "db1"}, name
        text = source
        for old, new in edits.items():
            assert source.count(old) == 1, (name, old)
            text = text.replace(old, new)
        assert (text != source) == bool(edits), name


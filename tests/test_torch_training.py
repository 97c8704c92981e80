"""The port's training step against the JAX package.

Same weights (JAX init carried over with params_from_jax), same numpy
batches. Dropout bits cannot match (jax keys vs torch generators), so the
steps are compared at dropout 0, and dropout is held to its own contract:
the uint8 threshold, the scale, the redrawn backward mask, the keep share.
The lean bf16 autograd Functions are held against JAX's custom VJPs and
against plain autograd of the same composition.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neurosync_trainer_lite_tpu.config import Config as JConfig
from neurosync_trainer_lite_tpu.models import seq2seq as jmodel
from neurosync_trainer_lite_tpu.ops import attention as jattn
from neurosync_trainer_lite_tpu.training import optim as joptim
from neurosync_trainer_lite_tpu.training import step as jstep
from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.models import seq2seq as tmodel
from neurosync_trainer_lite_tpu_torch.ops import attention as tattn
from neurosync_trainer_lite_tpu_torch.training import optim as toptim
from neurosync_trainer_lite_tpu_torch.training import step as tstep
from neurosync_trainer_lite_tpu_torch.utils.weights import params_from_jax

GEOM = dict(hidden_dim=64, n_layers=2, num_heads=4, input_dim=32,
            output_dim=7, dropout=0.0, batch_size=4)
BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value


def _f32(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close_to_one_ulp(ours, theirs, what=""):
    """bf16 results of the same fp32 math rounded at the same points: the
    sums run in another order, so an element may round to the neighbouring
    bf16 value; atol one bf16 ulp of the largest magnitude (2^-7 of it)."""
    a, b = _f32(ours), _f32(theirs)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=BF16_ULP * np.abs(b).max() + 1e-30,
                               err_msg=what)


# ---------------------------------------------------------------------------
# schedule and optimizer


@pytest.mark.parametrize("warmup,n_epochs", [(0, 5), (2, 6)])
def test_schedule_matches_jax_step_by_step(warmup, n_epochs):
    """The port's schedule is float64, the JAX one fp32: rel 1e-6."""
    kw = dict(warmup_epochs=warmup, n_epochs=n_epochs, learning_rate=3e-4)
    tcfg, jcfg = Config(**kw), JConfig(**kw)
    ours, theirs = toptim.make_schedule(tcfg, 7), joptim.make_schedule(jcfg, 7)
    for count in range(0, 7 * (n_epochs + 2)):
        assert ours(count) == pytest.approx(float(theirs(count)), rel=1e-6,
                                            abs=1e-12)
        epoch = count // 7
        assert toptim.lr_factor(epoch, tcfg) == joptim.lr_factor(epoch, jcfg)


@pytest.mark.parametrize("grad_scale", [0.05, 10.0])
def test_optimizer_update_matches_optax(grad_scale):
    """Three updates from the same params and gradients: clip (active at
    grad_scale 10, not at 0.05), L2 decay, Adam and the schedule. fp32 on
    both sides, rounded at other points (torch folds the bias corrections
    into the step size): a few fp32 ulps of the O(1) params, rtol 1e-6."""
    cfg = Config(learning_rate=1e-2, weight_decay=1e-2, grad_clip=2.0,
                 warmup_epochs=1, n_epochs=3)
    rng = np.random.default_rng(0)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in ((5, 3), (7,))]
    grads = [[(rng.standard_normal(p.shape) * grad_scale).astype(np.float32)
              for p in params] for _ in range(3)]

    tx = joptim.make_optimizer(JConfig(**{k: getattr(cfg, k) for k in (
        "learning_rate", "weight_decay", "grad_clip", "warmup_epochs",
        "n_epochs")}), 2)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()).requires_grad_(True) for p in params]
    opt = toptim.make_optimizer(cfg, tp)
    schedule = toptim.make_schedule(cfg, 2)
    for count, g in enumerate(grads):
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state,
                                       jp)
        jp = [p + u for p, u in zip(jp, updates)]
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        norm = toptim.global_norm([p.grad for p in tp])
        assert float(norm) == pytest.approx(
            float(jnp.sqrt(sum(jnp.sum(jnp.asarray(x) ** 2) for x in g))),
            rel=1e-6)
        toptim.clip_by_global_norm_([p.grad for p in tp], norm, cfg.grad_clip)
        for group in opt.param_groups:
            group["lr"] = schedule(count)
        opt.step()
    for ours, theirs in zip(tp, jp):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                                   atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------------------------
# dropout


def test_dropout_keep_share_scale_and_regenerated_mask():
    # no zeros in x, so that y != 0 is the keep mask
    x = torch.rand(64, 128, 128, generator=torch.Generator().manual_seed(0)) + 0.5
    rate = 0.3
    q = tattn.dropout_mask_q(rate)
    assert q == jattn.dropout_mask_q(rate) == 77
    xr = x.clone().requires_grad_(True)
    y = tattn.dropout(xr, rate, 1234, True)
    keep = y != 0
    share = keep.float().mean().item()
    # 1M draws: the share's standard deviation is ~5e-4
    assert abs(share - (1 - 77 / 256)) < 3e-3
    torch.testing.assert_close(y[keep], x[keep] * (256 / 179), rtol=0,
                               atol=1e-6)
    # the backward redraws the forward's mask from the seed, bit for bit
    y.backward(torch.ones_like(y))
    assert torch.equal(xr.grad != 0, keep)
    assert torch.equal(tattn.dropout_keep(1234, x.shape, q, "cpu"), keep)
    # bf16 scales by the bf16-rounded 256/179, as jnp.asarray(.., bf16)
    yb = tattn.dropout(x.bfloat16(), rate, 1234, True)
    assert torch.equal(yb != 0, keep)
    torch.testing.assert_close(
        yb[keep], x.bfloat16()[keep] * torch.tensor(256 / 179,
                                                    dtype=torch.bfloat16))


def test_dropout_edges():
    x = torch.randn(4, 8)
    assert torch.equal(tattn.dropout(x, 0.999, 1, True), torch.zeros_like(x))
    assert tattn.dropout(x, 0.3, 1, False) is x
    assert tattn.dropout(x, 0.3, None, True) is x
    assert tattn.dropout(x, 0.001, 1, True) is x       # q rounds to 0
    a, b = (tattn.dropout(x, 0.5, s, True) for s in (1, 2))
    assert not torch.equal(a, b)
    assert torch.equal(a, tattn.dropout(x, 0.5, 1, True))


def test_rope_tables_cached_in_inference_mode_train():
    """Serving fills the table cache in inference mode; a training step in
    the same process saves those tables for its backward."""
    from neurosync_trainer_lite_tpu_torch.ops.rope import (apply_rope,
                                                           rope_tables)

    with torch.inference_mode():
        rope_tables(29, 12, "cpu")
    x = torch.randn(2, 29, 12, requires_grad=True)
    apply_rope(x, rope_tables(29, 12, "cpu")).sum().backward()
    assert x.grad is not None


def test_split_seed_is_a_pure_function():
    assert tattn.split_seed(7, 4) == tattn.split_seed(7, 4)
    assert len(set(tattn.split_seed(7, 4) + tattn.split_seed(8, 4))) == 8
    assert tattn.split_or_none(None, 3) == [None] * 3


# ---------------------------------------------------------------------------
# the lean bf16 Functions


def test_linear_bf16_grads_match_jax():
    """_linear's Function: dx rounded once to bf16, dw rounded once to bf16
    and widened, db summed in fp32, as JAX's transposed dots."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 16)) * 0.1).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    dy = rng.standard_normal((3, 5, 16)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    out, vjp = jax.vjp(lambda x, p: jattn._linear(x, p), jx,
                       {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    jdx, jdp = vjp(jnp.asarray(dy, jnp.bfloat16))
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    tw = torch.from_numpy(w.T.copy()).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    y = tattn._linear(tx, tw, tb)
    y.backward(torch.from_numpy(dy).bfloat16())
    _close_to_one_ulp(y, out, "y")
    _close_to_one_ulp(tx.grad, jdx, "dx")
    assert tw.grad.dtype == torch.float32
    _close_to_one_ulp(tw.grad.T, jdp["w"], "dw")
    np.testing.assert_allclose(_f32(tb.grad), _f32(jdp["b"]), rtol=1e-6,
                               atol=1e-6)
    # plain autograd of the widened-operand formula rounds at the same
    # points with the same fp32 ops on the CPU: equal
    xa, wa, ba = (t.detach().clone().requires_grad_(True) for t in (tx, tw, tb))
    ya = (xa.float().reshape(-1, 32) @ wa.bfloat16().float().t() + ba
          ).bfloat16().reshape(y.shape)
    assert torch.equal(ya, y.detach())
    ya.backward(torch.from_numpy(dy).bfloat16())
    for ours, plain in ((tx.grad, xa.grad), (tw.grad, wa.grad),
                        (tb.grad, ba.grad)):
        assert torch.equal(ours, plain)


def test_layer_norm_bf16_matches_jax_and_autodiff():
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((3, 7, 32)) * 2.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    dy = rng.standard_normal((3, 7, 32)).astype(np.float32)
    out, vjp = jax.vjp(jmodel._layer_norm_bf16, jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(scale), jnp.asarray(bias))
    jg = vjp(jnp.asarray(dy, jnp.bfloat16))
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    y = tmodel.layer_norm(tx, ts, tb)
    y.backward(torch.from_numpy(dy).bfloat16())
    _close_to_one_ulp(y, out, "y")
    _close_to_one_ulp(tx.grad, jg[0], "dx")
    # fp32 sums of the same products: rel 1e-5
    for ours, theirs in ((ts.grad, jg[1]), (tb.grad, jg[2])):
        np.testing.assert_allclose(_f32(ours), _f32(theirs), rtol=1e-5,
                                   atol=1e-5)

    # against plain autograd of the fp32 formula through the bf16 input and
    # output roundings: 1e-2 of the largest gradient (JAX's own bound)
    xa = torch.from_numpy(x).bfloat16().requires_grad_(True)
    sa = torch.from_numpy(scale).requires_grad_(True)
    ba = torch.from_numpy(bias).requires_grad_(True)
    xf = xa.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mean).mean(-1, keepdim=True)
    ya = (((xf - mean) * torch.rsqrt(var + 1e-5)) * sa + ba).bfloat16()
    assert torch.equal(ya, y.detach())
    ya.backward(torch.from_numpy(dy).bfloat16())
    for ours, theirs in ((tx.grad, xa.grad), (ts.grad, sa.grad),
                         (tb.grad, ba.grad)):
        a, b = _f32(ours), _f32(theirs)
        assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max()


def _ffn_params(rng):
    return {"linear1": {"w": (rng.standard_normal((32, 128)) * 0.1
                              ).astype(np.float32),
                        "b": rng.standard_normal(128).astype(np.float32)},
            "linear2": {"w": (rng.standard_normal((128, 32)) * 0.1
                              ).astype(np.float32),
                        "b": rng.standard_normal(32).astype(np.float32)}}


def _port_ffn(p, rate):
    m = tmodel.FeedForward(32, 128, "cpu", rate)
    with torch.no_grad():
        for name in ("linear1", "linear2"):
            lin = getattr(m, name)
            lin.weight.copy_(torch.from_numpy(p[name]["w"].T.copy()))
            lin.bias.copy_(torch.from_numpy(p[name]["b"]))
    return m


def test_ffn_lean_core_matches_jax_at_rate_0():
    """bf16, train, no dropout: the port's FFN core (models/layers.py) and
    JAX's lean core, the same rounding points; bf16 results within one ulp
    of the largest, the fp32 weight gradients (sums of those bf16 values)
    within 2^-7 of the largest too."""
    rng = np.random.default_rng(11)
    p = _ffn_params(rng)
    x = rng.standard_normal((4, 8, 32)).astype(np.float32)
    dy = rng.standard_normal((4, 8, 32)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    out, vjp = jax.vjp(lambda p, x: jmodel._ffn(
        p, x, rate=0.0, rng=jax.random.PRNGKey(3), train=True), jp,
        jnp.asarray(x, jnp.bfloat16))
    jgp, jgx = vjp(jnp.asarray(dy, jnp.bfloat16))
    m = _port_ffn(p, 0.0)
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    y = m(tx, seed=5)
    y.backward(torch.from_numpy(dy).bfloat16())
    _close_to_one_ulp(y, out, "y")
    _close_to_one_ulp(tx.grad, jgx, "dx")
    for name in ("linear1", "linear2"):
        lin = getattr(m, name)
        assert lin.weight.grad.dtype == torch.float32
        _close_to_one_ulp(lin.weight.grad.T, jgp[name]["w"], name)
        _close_to_one_ulp(lin.bias.grad, jgp[name]["b"], name)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_ffn_lean_core_matches_the_plain_path(rate):
    """The FFN core vs the plain composition in the port: the same mask (one
    draw from the same seed), a bit-identical forward, and gradients within
    2e-2 (tests/test_model.py's bound: the plain path rounds the weight
    gradients to bf16)."""
    rng = np.random.default_rng(12)
    m = _port_ffn(_ffn_params(rng), rate)
    x = torch.from_numpy(rng.standard_normal((4, 8, 32)).astype(np.float32)
                         ).bfloat16()
    xl, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    y_lean = m(xl, seed=9)

    def plain(x):
        h = torch.relu(m.linear1(x))
        return m.linear2(tattn.dropout(h, rate, 9, True))

    y_plain = plain(xp)
    assert torch.equal(y_lean, y_plain)
    y_lean.float().square().sum().backward()
    lean = [xl.grad] + [prm.grad.clone() for prm in m.parameters()]
    m.zero_grad()
    y_plain.float().square().sum().backward()
    for a, b in zip(lean, [xp.grad] + [prm.grad for prm in m.parameters()]):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=2e-2, atol=2e-2)


def _qkv(seed, B=2, n=4, T=8, h=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, n, T, h)).astype(np.float32)
            for _ in range(4)]


def test_sdpa_lean_core_matches_jax_without_dropout():
    q, k, v, dout = _qkv(17)
    scale = 16 ** -0.5
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    out, vjp = jax.vjp(lambda q, k, v: jattn._sdpa_lean_core(
        q, k, v, jax.random.PRNGKey(0), scale, 0), *jargs)
    jg = vjp(jnp.asarray(dout, jnp.bfloat16))
    targs = [torch.from_numpy(a).bfloat16().requires_grad_(True)
             for a in (q, k, v)]
    y = tattn.sdpa(*targs, train=True)
    y.backward(torch.from_numpy(dout).bfloat16())
    _close_to_one_ulp(y, out, "out")
    for name, a, b in zip("qkv", targs, jg):
        _close_to_one_ulp(a.grad, b, f"d{name}")


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_sdpa_lean_core_matches_the_composed_path(rate):
    """Lean core vs autograd of the composed bf16 path (the bf16 softmax
    Function, dropout from the same seed): bit-identical forward, gradients
    within 2e-2 of the largest (tests/test_model.py's bound)."""
    q, k, v, _ = _qkv(18)
    scale = 16 ** -0.5
    qthresh = tattn.dropout_mask_q(rate) if rate else 0
    lean = [torch.from_numpy(a).bfloat16().requires_grad_(True)
            for a in (q, k, v)]
    comp = [torch.from_numpy(a).bfloat16().requires_grad_(True)
            for a in (q, k, v)]
    y_lean = tattn._SdpaLeanCore.apply(*lean, 42, scale, qthresh)
    s = tattn._matmul_round_once(comp[0], comp[1].transpose(-1, -2)) * \
        tattn._bf16_value(scale)
    w = tattn.dropout(tattn._SoftmaxResidualBf16.apply(s), rate, 42, True)
    y_comp = tattn._matmul_round_once(w, comp[2])
    assert torch.equal(y_lean, y_comp)
    y_lean.float().square().sum().backward()
    y_comp.float().square().sum().backward()
    for a, b in zip(lean, comp):
        a, b = _f32(a.grad), _f32(b.grad)
        assert np.abs(a - b).max() / np.abs(b).max() < 2e-2


def test_softmax_residual_bf16_matches_jax():
    rng = np.random.default_rng(3)
    s = (rng.standard_normal((2, 4, 8, 8)) * 3.0).astype(np.float32)
    dw = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    out, vjp = jax.vjp(jattn._softmax_residual_bf16,
                       jnp.asarray(s, jnp.bfloat16))
    (jds,) = vjp(jnp.asarray(dw, jnp.bfloat16))
    ts = torch.from_numpy(s).bfloat16().requires_grad_(True)
    w = tattn._SoftmaxResidualBf16.apply(ts)
    w.backward(torch.from_numpy(dw).bfloat16())
    _close_to_one_ulp(w, out, "w")
    _close_to_one_ulp(ts.grad, jds, "ds")
    # plain autograd through the bf16 weights: same forward, gradient within
    # 2e-2 of the largest (tests/test_model.py's bound for this Function)
    tp = torch.from_numpy(s).bfloat16().requires_grad_(True)
    wp = torch.softmax(tp.float(), dim=-1).bfloat16()
    assert torch.equal(wp, w.detach())
    wp.backward(torch.from_numpy(dw).bfloat16())
    a, b = _f32(ts.grad), _f32(tp.grad)
    assert np.abs(a - b).max() / np.abs(b).max() < 2e-2


# ---------------------------------------------------------------------------
# the train step


def _states(impl, use_amp=False, **kw):
    jcfg = JConfig(**GEOM, use_amp=use_amp, attention_impl=impl, **kw)
    tcfg = Config(**GEOM, use_amp=use_amp, attention_impl=impl, **kw)
    params = jmodel.init_seq2seq(jax.random.PRNGKey(1), jcfg)
    jstate, tx = jstep.init_train_state(jcfg, 5, params=params)
    sd = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    tstate = tstep.init_train_state(tcfg, 5, device="cpu", state_dict=sd)
    return (jcfg, jstate, jstep.make_train_step(jcfg, tx, donate=False),
            tcfg, tstate, tstep.make_train_step(tcfg))


def _batch(seed=0, B=4, T=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, GEOM["input_dim"])).astype(np.float32),
            (rng.standard_normal((B, T, GEOM["output_dim"])) * 0.5
             ).astype(np.float32))


def _param_gap(jstate, tstate, tcfg):
    jsd = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg)
    return max((jsd[k] - v.cpu()).abs().max().item()
               for k, v in tstate.model.state_dict().items())


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_ten_fp32_steps_match_jax(impl):
    """fp32, dropout 0, the clip active (grad norm ~5.7 > 2): loss and
    pre-clip grad norm within 1e-5 relative at every step. Parameters after
    1 and 10 steps within 2e-6: Adam moves each by ~lr = 5e-5 a step, and
    the two sides' fp32 gradients (sums in another order) give updates
    that differ by far less."""
    _, js, jf, tcfg, ts, tf = _states(impl)
    src, trg = _batch()
    gen = torch.Generator().manual_seed(0)
    first_loss = None
    for i in range(10):
        js, jl, jn = jf(js, jnp.asarray(src), jnp.asarray(trg),
                        jax.random.PRNGKey(i))
        ts, tl, tn = tf(ts, torch.from_numpy(src), torch.from_numpy(trg), gen)
        assert float(tl) == pytest.approx(float(jl), rel=1e-5), i
        assert float(tn) == pytest.approx(float(jn), rel=1e-5), i
        first_loss = first_loss or float(tl)
        if i == 0:
            assert _param_gap(js, ts, tcfg) < 2e-6
    assert tstep.opt_step_count(ts) == 10
    assert _param_gap(js, ts, tcfg) < 2e-6
    assert float(tl) < first_loss


def test_grad_accumulation_equals_the_full_batch():
    """grad_accum_steps=2 (two micro-batches of 2) vs one batch of 4, two
    fp32 steps (in bf16 the weight gradients round per micro-batch):
    losses rel 1e-5, grad norm rel 1e-4, params 2e-6 (the bounds of
    the JAX package's own test, tests/test_grad_accum.py)."""
    src, trg = (torch.from_numpy(a) for a in _batch(1))
    results = {}
    for accum in (1, 2):
        cfg = Config(**GEOM, use_amp=False, grad_accum_steps=accum)
        state = tstep.init_train_state(
            cfg, 5, generator=torch.Generator().manual_seed(3), device="cpu")
        step = tstep.make_train_step(cfg)
        gen = torch.Generator().manual_seed(0)
        for _ in range(2):
            state, loss, norm = step(state, src, trg, gen)
        results[accum] = (float(loss), float(norm), state.model.state_dict())
    assert results[1][0] == pytest.approx(results[2][0], rel=1e-5)
    assert results[1][1] == pytest.approx(results[2][1], rel=1e-4)
    for key, value in results[1][2].items():
        torch.testing.assert_close(value, results[2][2][key], atol=2e-6,
                                   rtol=0)
    with pytest.raises(ValueError, match="multiple"):
        step(state, src[:3], trg[:3], gen)


def test_bf16_step_matches_jax():
    """bf16 over fp32 master weights, dropout 0, three steps at 'auto' (the
    K4 kernels' bf16 backward is held in test_torch_fused_attention_bwd.py
    and inside the full-width model by chip_smoke.py). The two sides
    round at the same points but RoPE differently (the JAX CPU path rounds
    its tables to bf16; the port keeps the TPU kernel's fp32 tables), so
    the loss agrees to a few bf16 roundings of the O(1) loss (rel 1e-2) and
    the grad norm to 5e-2."""
    _, js, jf, _, ts, tf = _states("auto", use_amp=True)
    src, trg = _batch(2)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        js, jl, jn = jf(js, jnp.asarray(src), jnp.asarray(trg),
                        jax.random.PRNGKey(i))
        ts, tl, tn = tf(ts, torch.from_numpy(src), torch.from_numpy(trg), gen)
        assert np.isfinite(float(tl)) and np.isfinite(float(tn))
        assert float(tl) == pytest.approx(float(jl), rel=1e-2), i
        assert float(tn) == pytest.approx(float(jn), rel=5e-2), i


def test_eval_step_matches_jax():
    jcfg, js, _, tcfg, ts, _ = _states("auto")
    src, trg = _batch(3)
    theirs = jstep.make_eval_step(jcfg)(js.params, jnp.asarray(src),
                                        jnp.asarray(trg))
    ours = tstep.make_eval_step(tcfg)(ts.model, torch.from_numpy(src),
                                      torch.from_numpy(trg))
    assert float(ours) == pytest.approx(float(theirs), rel=1e-5)


@pytest.mark.parametrize("use_amp", [False, True])
def test_dropout_step_is_seeded_by_the_generator(use_amp):
    """At dropout 0.3 the step is a pure function of the generator's seed:
    the same seed gives the same loss and weights, another seed another
    loss; losses and norms stay finite."""
    cfg = Config(**dict(GEOM, dropout=0.3), use_amp=use_amp)
    src, trg = (torch.from_numpy(a) for a in _batch(4))
    runs = []
    for seed in (0, 0, 1):
        state = tstep.init_train_state(
            cfg, 5, generator=torch.Generator().manual_seed(3), device="cpu")
        step = tstep.make_train_step(cfg)
        gen = torch.Generator().manual_seed(seed)
        losses = []
        for _ in range(2):
            state, loss, norm = step(state, src, trg, gen)
            assert np.isfinite(float(loss)) and np.isfinite(float(norm))
            losses.append(float(loss))
        runs.append((losses, state.model.state_dict()))
    assert runs[0][0] == runs[1][0]
    assert runs[0][0] != runs[2][0]
    for key, value in runs[0][1].items():
        assert torch.equal(value, runs[1][1][key])


def test_unported_options_raise():
    """Parallel configs with no process group are JAX's mesh errors; the
    annealed loss needs its step count."""
    with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
        tstep.make_train_step(Config(**GEOM, tp=2))
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        tstep.make_train_step(Config(**GEOM, dp=2))
    with pytest.raises(ValueError, match="total_steps"):
        tstep.make_train_step(Config(**GEOM, loss_variant="smoothness",
                                     smoothness_annealing=True))

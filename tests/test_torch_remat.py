"""Per-layer remat of the port (cfg.remat, remat_scope, remat_layers,
remat_policy) against the JAX package and against itself.

Remat changes what the backward keeps, never what it computes: the port's
remat step equals the JAX remat step (fp32, dropout 0), and equals its own
no-remat step bit for bit, dropout on, since every recomputed dropout mask
is redrawn from its per-site seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neurosync_trainer_lite_tpu.config import Config as JConfig
from neurosync_trainer_lite_tpu.models import seq2seq as jmodel
from neurosync_trainer_lite_tpu.training import step as jstep
from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.models import layers
from neurosync_trainer_lite_tpu_torch.models import seq2seq as tmodel
from neurosync_trainer_lite_tpu_torch.training import step as tstep
from neurosync_trainer_lite_tpu_torch.utils.weights import params_from_jax

GEOM = dict(hidden_dim=64, n_layers=2, num_heads=4, input_dim=32,
            output_dim=7, batch_size=4)


def _batch(seed=0, B=4, T=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, GEOM["input_dim"])).astype(np.float32),
            (rng.standard_normal((B, T, GEOM["output_dim"])) * 0.5
             ).astype(np.float32))


@pytest.fixture
def checkpoints(monkeypatch):
    """Counts the layers the port runs under torch.utils.checkpoint."""
    calls = []
    real = layers.checkpoint

    def spy(fn, *args, **kwargs):
        calls.append(type(fn).__name__)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(layers, "checkpoint", spy)
    return calls


# (remat_scope, remat_layers, remat_policy) and the layers each forward
# recomputes at 2+2 layers
REMAT = [("all", -1, "full", ["EncoderLayer"] * 2 + ["DecoderLayer"] * 2),
         ("encoder", -1, "full", ["EncoderLayer"] * 2),
         ("decoder", -1, "full", ["DecoderLayer"] * 2),
         ("all", 1, "full", ["EncoderLayer", "DecoderLayer"]),
         ("all", -1, "dots", ["EncoderLayer"] * 2 + ["DecoderLayer"] * 2),
         ("decoder", 1, "dots", ["DecoderLayer"])]


@pytest.mark.parametrize("scope,layers,policy,rematted", REMAT)
def test_remat_step_matches_jax(checkpoints, scope, layers, policy, rematted):
    """fp32, dropout 0, three steps: loss and pre-clip grad norm within 1e-5
    relative of the JAX step with the same remat settings."""
    kw = dict(GEOM, dropout=0.0, use_amp=False, remat=True, remat_scope=scope,
              remat_layers=layers, remat_policy=policy)
    jcfg, tcfg = JConfig(**kw), Config(**kw)
    params = jmodel.init_seq2seq(jax.random.PRNGKey(1), jcfg)
    js, tx = jstep.init_train_state(jcfg, 5, params=params)
    jf = jstep.make_train_step(jcfg, tx, donate=False)
    ts = tstep.init_train_state(tcfg, 5, device="cpu", state_dict=params_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    tf = tstep.make_train_step(tcfg)
    src, trg = _batch()
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        js, jl, jn = jf(js, jnp.asarray(src), jnp.asarray(trg),
                        jax.random.PRNGKey(i))
        ts, tl, tn = tf(ts, torch.from_numpy(src), torch.from_numpy(trg), gen)
        assert float(tl) == pytest.approx(float(jl), rel=1e-5), i
        assert float(tn) == pytest.approx(float(jn), rel=1e-5), i
    assert checkpoints == rematted * 3


def _steps(cfg, src, trg, n=2):
    state = tstep.init_train_state(
        cfg, 5, generator=torch.Generator().manual_seed(3), device="cpu")
    step = tstep.make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    out = []
    for _ in range(n):
        state, loss, norm = step(state, src, trg, gen)
        out.append((loss, norm))
    return out, state.model.state_dict()


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("use_amp", [False, True])
def test_remat_equals_no_remat_with_dropout(policy, use_amp):
    """Dropout 0.3, the same seeds: two steps with every layer rematted give
    the same losses, grad norms and weights as without remat, bit for bit
    (torch.equal), in fp32 and in bf16 with the lean autograd Functions."""
    cfg = Config(**GEOM, dropout=0.3, use_amp=use_amp)
    src, trg = (torch.from_numpy(a) for a in _batch(1))
    plain, plain_sd = _steps(cfg, src, trg)
    remat, remat_sd = _steps(cfg.replace(remat=True, remat_policy=policy),
                             src, trg)
    for (la, na), (lb, nb) in zip(plain, remat):
        assert torch.equal(la, lb) and torch.equal(na, nb)
    for key, value in plain_sd.items():
        assert torch.equal(value, remat_sd[key]), key


def test_remat_changes_nothing_without_a_backward(checkpoints):
    """Serving (grad disabled) runs no checkpoint and gives the same output."""
    cfg = Config(**GEOM, dropout=0.0, use_amp=False)
    model = tmodel.init_seq2seq(cfg, torch.Generator().manual_seed(0), "cpu")
    remat = tmodel.Seq2Seq(cfg.replace(remat=True), "cpu")
    remat.load_state_dict(model.state_dict())
    src = torch.from_numpy(_batch(2)[0])
    with torch.inference_mode():
        assert torch.equal(model.eval()(src), remat.eval()(src))
    assert checkpoints == []


@pytest.mark.parametrize("kw,want", [
    (dict(remat=False), (0, 0)),
    (dict(remat=True), (3, 3)),
    (dict(remat=True, remat_layers=5), (3, 3)),
    (dict(remat=True, remat_layers=0), (0, 0)),
    (dict(remat=True, remat_layers=2, remat_scope="encoder"), (2, 0)),
    (dict(remat=True, remat_layers=1, remat_scope="decoder"), (0, 1)),
])
def test_remat_count_follows_the_jax_scan_split(kw, want):
    """JAX _scan_layers: the first remat_layers layers of a stack in scope,
    all of them at -1 or at >= n_layers."""
    cfg = Config(n_layers=3, **kw)
    assert (layers._remat_count(cfg, "encoder", 3),
            layers._remat_count(cfg, "decoder", 3)) == want

"""The port's training losses against the reference golden and the JAX
package: values and gradients, the zero penalty and the annealed
smoothness variant."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neurosync_trainer_lite_tpu.models import loss as jloss
from neurosync_trainer_lite_tpu_torch.models import loss as tloss

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures",
                           "reference_tiny")


def test_loss_matches_reference_golden():
    """The reference Loss on its own forward output: rel 1e-5, the bound of
    tests/test_reference_parity.py."""
    goldens = np.load(os.path.join(FIXTURE_DIR, "goldens.npz"))
    ours = float(tloss.loss_fn(torch.from_numpy(goldens["fwd_out"]),
                               torch.from_numpy(goldens["trg"])))
    assert ours == pytest.approx(float(goldens["loss"]), rel=1e-5)


def _pred_targ(seed, silent=True):
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal((3, 12, 61)).astype(np.float32)
    targ = (rng.standard_normal((3, 12, 61)) * 1.5).astype(np.float32)
    if silent:  # repeated frames: zero frame deltas, where the norm's
        pred[:, 4:7] = pred[:, 4:5]   # gradient needs the 1e-24 offset
        targ[:, 4:7] = targ[:, 4:5]
    return pred, targ


def _value_and_grad_torch(fn, pred, targ, **kw):
    p = torch.from_numpy(pred).requires_grad_(True)
    value = fn(p, torch.from_numpy(targ), **kw)
    value.backward()
    return float(value.detach()), p.grad.numpy()


def _value_and_grad_jax(fn, pred, targ, **kw):
    value, grad = jax.value_and_grad(
        lambda p: fn(p, jnp.asarray(targ), **kw))(jnp.asarray(pred))
    return float(value), np.asarray(grad)


# fp32 on both sides, sums in another order: values rel 1e-6, gradients
# (elements ~1e-3 of a mean over 2k elements) atol 1e-7.
@pytest.mark.parametrize("kw", [
    {}, {"zero_penalty_weight": 0.5},
    {"delta": 0.5, "w1": 2.0, "w2": 0.5, "w3": 1.5}])
def test_loss_and_grad_match_jax(kw):
    pred, targ = _pred_targ(0)
    v_t, g_t = _value_and_grad_torch(tloss.loss_fn, pred, targ, **kw)
    v_j, g_j = _value_and_grad_jax(jloss.loss_fn, pred, targ, **kw)
    assert v_t == pytest.approx(v_j, rel=1e-6)
    assert np.isfinite(g_t).all()
    np.testing.assert_allclose(g_t, g_j, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("anneal,step", [(False, None), (True, 0),
                                         (True, 7), (True, 1234)])
def test_smoothness_loss_and_grad_match_jax(anneal, step):
    """The annealed phase is fp32 on both sides (the JAX step count is an
    int32 scalar): values rel 1e-5, gradients atol 1e-6."""
    pred, targ = _pred_targ(1)
    kw = dict(w4=0.7, anneal=anneal, total_steps=5000,
              current_step=step)
    v_t, g_t = _value_and_grad_torch(tloss.smoothness_loss_fn, pred, targ,
                                     **kw)
    jkw = dict(kw, current_step=None if step is None
               else jnp.asarray(step, jnp.int32))
    v_j, g_j = _value_and_grad_jax(jloss.smoothness_loss_fn, pred, targ,
                                   **jkw)
    assert v_t == pytest.approx(v_j, rel=1e-5)
    np.testing.assert_allclose(g_t, g_j, atol=1e-6, rtol=1e-5)


def test_annealing_moves_the_weights():
    pred, targ = _pred_targ(2, silent=False)
    p, t = torch.from_numpy(pred), torch.from_numpy(targ)
    values = {float(tloss.smoothness_loss_fn(p, t, anneal=True,
                                             current_step=s, total_steps=4000))
              for s in (0, 1, 2)}
    assert len(values) == 3

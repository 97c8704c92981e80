"""On the card: the plain reference follows the port's training step and
served request to float32 rounding at a tiny size (the dropout masks drawn
by the card's generator on both sides), and the profiled stretch sees the
card's kernels. Run on a machine with a card:

    python -m pytest benchmark/tests -q -m cuda
"""

import pytest

from benchmark.drivers import train_loop, utterances
from benchmark.tests.tiny import context


def _on(card, ctx):
    ctx.device = str(card)
    return ctx


@pytest.mark.cuda
def test_train_step_matches_reference_on_card(card):
    ctx = _on(card, context("train-w128-b128", 2 ** 31 + 41, use_amp=False))
    got = train_loop.readings(ctx, ())["program"]
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4
    assert got["update_gap"] < 1e-3


@pytest.mark.cuda
def test_request_matches_reference_on_card(card):
    ctx = _on(card, context("serve-utterances", 2 ** 31 + 42, use_amp=False))
    got = utterances.readings(ctx, ())["program"]
    assert got["frames_rel_rms"] < 1e-4 and got["frames_max_gap"] < 1e-3


@pytest.mark.cuda
def test_profiled_stretch_sees_kernels(card):
    import torch

    from benchmark.common.harness import profiled

    x = torch.randn(1024, 1024, device=card)
    _, prof = profiled(lambda: [x @ x for _ in range(10)])
    assert prof.busy_us() > 0 and prof.class_us()["gemm"] > 0
    assert 0 <= prof.idle_pct() < 100

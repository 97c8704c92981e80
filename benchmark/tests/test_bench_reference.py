"""The plain reference against the port's plain path, at a tiny size in
float32 on the CPU: the training step (forward, loss, backward, clip, Adam,
with the dropout masks of the stated convention) and a served request
(WAV decode, frontend, chunks, forward, blend) agree to float32 rounding.
The reference imports nothing of the port; the port is only the program
whose outputs are judged."""

import numpy as np
import pytest
import torch

from benchmark.common import inputs
from benchmark.drivers import train_loop, utterances
from benchmark.reference import frontend as ref_frontend
from benchmark.tests.tiny import context


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_train_steps_match_port_fp32(dropout):
    ctx = context("train-w128-b128", seed=2 ** 31 + 11, use_amp=False,
                  dropout=dropout)
    got = train_loop.readings(ctx, ())["program"]
    assert got["loss_gap"] < 1e-6
    assert got["grad_gap"] < 1e-5
    assert got["update_gap"] < 1e-4


def test_served_frames_match_port_fp32():
    ctx = context("serve-utterances", seed=2 ** 31 + 13, use_amp=False)
    got = utterances.readings(ctx, ())["program"]
    assert got["frames_rel_rms"] < 1e-5
    assert got["frames_max_gap"] < 1e-4


def test_frontend_matches_port():
    from neurosync_trainer_lite_tpu_torch.ops.frontend import (
        extract_features)

    sr = 88200
    y = inputs.speech_like(3, 0, 2 * sr + 17, sr, "cpu").astype(np.float64)
    y /= np.abs(y).max()
    want = ref_frontend.features(y, sr)
    got = extract_features(torch.from_numpy(y.astype(np.float32)),
                           sr).numpy()
    assert got.shape == want.shape == (121, 256)
    assert np.abs(got - want).max() < 1e-4


def test_masks_matter():
    """A reference that drew other masks would disagree: the step's seed
    tree is what ties the two."""
    from benchmark.reference import model as ref_model

    assert ref_model.step_seed(5, 0) != ref_model.step_seed(5, 1)
    drop = ref_model.Dropout(0.3, 4)
    x = torch.ones(4, 8, 16)
    a, b = drop(x, 1), drop(x, 2)
    assert not torch.equal(a, b)
    kept = (a > 0).float().mean().item()
    assert 0.6 < kept < 0.8
    assert torch.equal(ref_model.Dropout(0.3, 4, 2)(x[2:], 1), a[2:])


def test_windows_cut_as_the_loop_states():
    """The reference's own cut of the check's batches: the port's windows,
    split and epoch order, from the stated convention alone."""
    from neurosync_trainer_lite_tpu_torch.data.windowing import (
        WindowedDataset)

    from benchmark.reference import windows

    frames, window, seed = [300, 256, 100, 131], 64, 2 ** 31 + 5
    clips = [(np.random.rand(n, 3).astype(np.float32),
              np.random.rand(n, 2).astype(np.float32)) for n in frames]
    ds = WindowedDataset(clips, window=window)
    assert np.array_equal(windows.window_table(frames, window), ds.table)
    train, _ = ds.split(0.1, seed)
    want = list(train.index_batches(8, shuffle=True, seed=seed + 3,
                                    drop_last=True))[:4]
    got = windows.epoch_batches(frames, window, 0.1, seed, 3, 8, 4)
    assert all(np.array_equal(ds.table[w], g) for w, g in zip(want, got))
    audio = torch.from_numpy(np.concatenate([a for a, _ in clips]))
    src, _ = ds.gather(want[0])
    assert torch.equal(windows.gather(audio, frames, got[0], window),
                       torch.from_numpy(src))

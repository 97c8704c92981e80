"""The port's training loop (training/loop.py, train.py) against the JAX
package's: train_model's history from the same weights and clips, the
auto-remat planner's decisions, the loud failures, and the CLI."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from neurosync_trainer_lite_tpu.config import Config as JConfig
from neurosync_trainer_lite_tpu.models import seq2seq as jmodel
from neurosync_trainer_lite_tpu.training import loop as jloop
from neurosync_trainer_lite_tpu_torch import train as tcli
from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.training import loop as tloop
from neurosync_trainer_lite_tpu_torch.utils.weights import params_from_jax
from tests.test_data_pipeline import make_capture_folder

REPO = Path(__file__).resolve().parent.parent
GEOM = dict(hidden_dim=32, n_layers=2, num_heads=2, input_dim=16,
            output_dim=5, dropout=0.0, use_amp=False, batch_size=8,
            micro_batch_size=16, n_epochs=2, validation_interval=4,
            learning_rate=1e-3)


def _clips():
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((n, 16)).astype(np.float32),
             rng.random((n, 5)).astype(np.float32) * 100)
            for n in (70, 55)]


def test_train_model_history_matches_jax():
    """fp32, dropout 0, the same initial weights (JAX's init through
    params_from_jax), clips, split and batch order: every train loss, val
    loss and pre-clip grad norm of 2 epochs within 1e-5 relative (fp32
    sums in another order, as tests/test_torch_training.py's steps)."""
    jcfg, tcfg = JConfig(**GEOM), Config(**GEOM)
    params = jmodel.init_seq2seq(jax.random.PRNGKey(1), jcfg)
    # before the JAX step donates (deletes) the initial params
    init = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    theirs, ours = {}, {}
    jloop.train_model(jcfg, _clips(), verbose=False, save_artifacts=False,
                      init_params=params, history_out=theirs)
    _, steps = tloop.train_model(
        tcfg, _clips(), verbose=False, save_artifacts=False, device="cpu",
        init_state_dict=init, history_out=ours)
    assert steps == len(theirs["train_losses"]) > 8
    for key in ("train_losses", "val_losses", "grad_norms"):
        assert len(ours[key]) == len(theirs[key]) > 0, key
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-5,
                                   err_msg=key)
    assert len(ours["epoch_seconds"]) == 2
    assert ours["epoch_samples"] == [steps // 2 * 8] * 2


PLANNER_GRID = [
    dict(),                                            # the full model
    dict(batch_size=256),
    dict(batch_size=512, micro_batch_size=256),
    dict(use_amp=False),
    dict(grad_accum_steps=4, batch_size=512),
    dict(micro_batch_size=2048, batch_size=8),
    dict(n_layers=4, hidden_dim=512, num_heads=8),
    dict(remat=True),
    dict(auto_remat=False, batch_size=1024),
]


@pytest.mark.parametrize("limit_gb", [16, 24, 40, 80, 141])
def test_auto_remat_planner_decides_as_jax(monkeypatch, limit_gb):
    """The planner's semantics with the JAX package's "any other device"
    coefficients, over configs and injected device memory sizes."""
    kind = "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr(jloop, "_device_hbm_limit", lambda: limit_gb * 10 ** 9)
    monkeypatch.setattr(jloop, "_local_device_kind", lambda: kind)
    monkeypatch.setattr(tloop, "_device_hbm_limit",
                        lambda device: limit_gb * 10 ** 9)
    monkeypatch.setattr(tloop, "_local_device_kind", lambda device: kind)
    for kw in PLANNER_GRID:
        jc = jloop._maybe_auto_remat(JConfig(**kw), 1, False)
        tc = tloop._maybe_auto_remat(Config(**kw), 1, False,
                                     torch.device("cpu"))
        assert (tc.remat, tc.remat_scope, tc.remat_layers) == \
            (jc.remat, jc.remat_scope, jc.remat_layers), kw
        assert tloop.estimate_step_hbm_bytes(Config(**kw)) == \
            jloop.estimate_step_hbm_bytes(JConfig(**kw))


def test_planner_leaves_the_cpu_alone():
    cfg = Config(batch_size=4096)
    assert tloop._maybe_auto_remat(cfg, 1, False, torch.device("cpu")) is cfg


@pytest.mark.parametrize("case", ["no windows", "batch above windows"])
def test_loud_failures_match_jax(case):
    if case == "no windows":
        clips, kw = [(np.zeros((10, 16), np.float32),
                      np.zeros((10, 5), np.float32))], {}
    else:
        clips, kw = _clips(), dict(batch_size=512)
    with pytest.raises(RuntimeError) as theirs:
        jloop.train_model(JConfig(**dict(GEOM, **kw)), clips, verbose=False,
                          save_artifacts=False)
    with pytest.raises(RuntimeError) as ours:
        tloop.train_model(Config(**dict(GEOM, **kw)), clips, verbose=False,
                          save_artifacts=False, device="cpu")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kw,error,match", [
    (dict(tp=2), ValueError, "mesh 1x2 needs 2 devices, have 1"),
    (dict(dp=2), ValueError, "mesh 2x1 needs 2 devices, have 1")])
def test_parallel_configs_raise(kw, error, match):
    """tp = 2 or dp = 2 with no process group is JAX's mesh error (one
    rank, no fallback to a single process)."""
    with pytest.raises(error, match=match):
        tloop.train_model(Config(**dict(GEOM, **kw)), _clips(), device="cpu")


def test_step_generators_are_pure_functions_of_seed_and_step():
    a = tloop.step_generator(1, 5).initial_seed()
    assert a == tloop.step_generator(1, 5).initial_seed()
    assert len({a, tloop.step_generator(1, 6).initial_seed(),
                tloop.step_generator(2, 5).initial_seed()}) == 3


def test_cli_flags_cover_every_config_field():
    cfg, args = tcli.parse_config(["--tiny", "--hidden_dim", "48",
                                   "--use_amp", "false", "--device", "cpu",
                                   "--profile", "p"])
    assert cfg.hidden_dim == 48 and cfg.n_layers == 4 and not cfg.use_amp
    assert (args.device, args.profile) == ("cpu", "p")
    with pytest.raises(SystemExit, match="need --coordinator HOST:PORT"):
        tcli.main(["--tiny", "--device", "cpu", "--num_processes", "2"])


def test_cli_trains_the_tiny_model_on_the_cpu(tmp_path):
    """python -m neurosync_trainer_lite_tpu_torch.train --tiny --device cpu
    on a synthetic capture folder: exits 0 and writes model.pth and the
    checkpoint; the package's __main__ is the same CLI."""
    data = tmp_path / "data"
    make_capture_folder(str(data), "clip", seconds=2.5)
    out = tmp_path / "out"
    flags = ["--tiny", "--device", "cpu", "--root_dir", str(data),
             "--micro_batch_size", "32", "--batch_size", "4",
             "--n_epochs", "1", "--max_steps_per_epoch", "2",
             "--model_path", str(out / "model.pth"),
             "--checkpoint_path", str(out / "ck" / "checkpoint"),
             "--plots_dir", str(out / "plots"),
             "--audio_path", str(tmp_path / "absent.wav")]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-m", "neurosync_trainer_lite_tpu_torch.train",
         *flags], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert (out / "model.pth").exists()
    assert (out / "ck" / "checkpoint" / "meta.json").exists()
    assert "max_steps_per_epoch=2 reached" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "neurosync_trainer_lite_tpu_torch", "--help"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--init_from_pth" in proc.stdout


def test_validation_artifacts_match_jax(tmp_path):
    """generate_and_save_facial_data on a clip with the same weights in both
    packages: the same artifacts (CSV, comparison plot, stats file), and
    the generated frames within 1e-4 of JAX's: the two frontends agree to
    tests/test_torch_frontend.py's bounds, which a tiny fp32 model carries
    to its output scaled ÷100."""
    import pandas as pd

    from neurosync_trainer_lite_tpu.training.validation import (
        generate_and_save_facial_data as jvalidate)
    from neurosync_trainer_lite_tpu.utils.csv_io import (
        save_generated_data_as_csv)
    from neurosync_trainer_lite_tpu_torch.training.step import init_train_state
    from neurosync_trainer_lite_tpu_torch.training.validation import (
        generate_and_save_facial_data as tvalidate)

    folder, blend = make_capture_folder(str(tmp_path), "v", seconds=1.5)
    wav, truth = os.path.join(folder, "audio.wav"), str(tmp_path / "gt.csv")
    save_generated_data_as_csv(blend, truth)
    geom = dict(hidden_dim=32, n_layers=1, num_heads=2, dropout=0.0,
                use_amp=False, frame_size=32, overlap=8)
    jcfg, tcfg = JConfig(**geom), Config(**geom)
    params = jmodel.init_seq2seq(jax.random.PRNGKey(3), jcfg)
    model = init_train_state(tcfg, 1, device="cpu", state_dict=params_from_jax(
        jax.tree.map(np.asarray, params), tcfg)).model
    theirs = jvalidate(0, wav, params, truth, jcfg, str(tmp_path / "j"))
    ours = tvalidate(0, wav, model, truth, tcfg, str(tmp_path / "t"))
    assert os.path.basename(ours) == os.path.basename(theirs)
    for d in ("j", "t"):
        assert sorted(os.listdir(tmp_path / d)) == [
            "comparison_plot_epoch_1.jpg", "generated_facial_data_epoch_1.csv",
            "stats"]
        assert os.listdir(tmp_path / d / "stats") == [
            "comparison_stats_epoch_1.txt"]
    a, b = pd.read_csv(ours), pd.read_csv(theirs)
    assert list(a.columns) == list(b.columns) and a.shape == b.shape
    assert (a["Timecode"] == b["Timecode"]).all()
    np.testing.assert_allclose(a.values[:, 1:].astype(float),
                               b.values[:, 1:].astype(float), atol=1e-4)

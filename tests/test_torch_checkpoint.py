"""The port's checkpoints (training/checkpoint.py): the JAX package's
directory contract (meta.json present ⇒ state complete, 5 rotated backups,
fallback to the newest complete backup), async saves equal to sync saves, a
resumed run bit for bit the uninterrupted one at dropout 0.3, and model.pth
moving between the packages in both directions."""

import json
import os
import time

import numpy as np
import pytest
import torch

import jax

from neurosync_trainer_lite_tpu.config import Config as JConfig
from neurosync_trainer_lite_tpu.models import seq2seq as jmodel
from neurosync_trainer_lite_tpu.utils import torch_interop
from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.training import checkpoint as ckpt
from neurosync_trainer_lite_tpu_torch.training.loop import train_model
from neurosync_trainer_lite_tpu_torch.training.step import (
    init_train_state,
    make_train_step,
    opt_step_count,
)
from neurosync_trainer_lite_tpu_torch.utils.weights import params_from_jax

GEOM = dict(hidden_dim=32, n_layers=1, num_heads=2, input_dim=16,
            output_dim=5, batch_size=4, micro_batch_size=16, use_amp=False)


def _state(tmp_path, steps=2, **kw):
    cfg = Config(**GEOM, checkpoint_path=str(tmp_path / "ck" / "checkpoint"),
                 **kw)
    state = init_train_state(cfg, 5, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(cfg)
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.standard_normal((4, 16, 16)).astype(np.float32))
    trg = torch.from_numpy(rng.random((4, 16, 5)).astype(np.float32))
    for i in range(steps):
        step(state, src, trg, torch.Generator().manual_seed(i))
    return cfg, state


def _assert_same_state(a, b):
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for key, value in st.items():
            assert torch.equal(value, sb["state"][i][key]), (i, key)


def test_save_load_and_the_directory_contract(tmp_path):
    cfg, state = _state(tmp_path)
    path = ckpt.save_checkpoint(state, 3, 17, cfg)
    assert os.path.basename(path) == "state.pt"
    with open(os.path.join(cfg.checkpoint_path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["epoch"] == 3 and meta["batch_step"] == 17
    assert Config.from_dict(meta["config"]) == cfg
    epoch, batch_step, loaded = ckpt.load_checkpoint(cfg.checkpoint_path, cfg,
                                                     5, device="cpu")
    assert (epoch, batch_step) == (3, 17)
    assert opt_step_count(loaded) == 2
    _assert_same_state(state, loaded)
    model = ckpt.load_model(cfg.checkpoint_path, cfg, device="cpu")
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k])


def test_rotation_keeps_five_backups_and_falls_back_without_meta(tmp_path):
    cfg, state = _state(tmp_path, steps=0)
    for epoch in range(7):
        ckpt.save_checkpoint(state, epoch, epoch * 10, cfg)
        time.sleep(0.01)      # distinct modification times for the order
    parent = os.path.dirname(cfg.checkpoint_path)
    backups = sorted(d for d in os.listdir(parent) if d.startswith("backup_"))
    assert len(backups) == 5
    # a crash mid-save: the newest checkpoint has no meta.json
    os.remove(os.path.join(cfg.checkpoint_path, "meta.json"))
    epoch, batch_step, _ = ckpt.load_checkpoint(cfg.checkpoint_path, cfg, 5,
                                                device="cpu")
    assert (epoch, batch_step) == (5, 50)
    for b in backups:
        os.remove(os.path.join(parent, b, "checkpoint", "meta.json"))
    with pytest.raises(FileNotFoundError, match="No complete checkpoint"):
        ckpt.load_checkpoint(cfg.checkpoint_path, cfg, 5, device="cpu")


def test_async_save_equals_sync_and_defers_meta(tmp_path):
    cfg, state = _state(tmp_path)
    sync_dir = str(tmp_path / "sync" / "checkpoint")
    ckpt.save_checkpoint(state, 1, 8, cfg, sync_dir)
    ckpt.save_checkpoint(state, 1, 8, cfg, async_save=True)
    # the snapshot was taken before returning: a later in-place update does
    # not reach the file
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    assert ckpt._pending.metas      # meta.json waits for the write
    ckpt.wait_for_pending_saves()
    assert os.path.exists(os.path.join(cfg.checkpoint_path, "meta.json"))
    a = torch.load(os.path.join(sync_dir, "state.pt"), weights_only=True)
    b = torch.load(os.path.join(cfg.checkpoint_path, "state.pt"),
                   weights_only=True)
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for key, value in st.items():
            assert torch.equal(value, b["optimizer"]["state"][i][key])


def test_a_failed_async_write_raises_and_leaves_no_meta(tmp_path, monkeypatch):
    cfg, state = _state(tmp_path, steps=0)

    def refuse(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", refuse)
    ckpt.save_checkpoint(state, 0, 0, cfg, async_save=True)
    with pytest.raises(RuntimeError, match="async checkpoint") as info:
        ckpt.wait_for_pending_saves()
    assert isinstance(info.value.__cause__, OSError)
    assert not os.path.exists(os.path.join(cfg.checkpoint_path, "meta.json"))
    ckpt.wait_for_pending_saves()        # the failure is reported once


def _clips(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((90, 16)).astype(np.float32),
             rng.random((90, 5)).astype(np.float32) * 100)]


def _run_cfg(tmp_path, name, **kw):
    out = tmp_path / name
    base = dict(GEOM, dropout=0.3, n_epochs=2, validation_interval=3,
                async_checkpoint=True,
                checkpoint_path=str(out / "ck" / "checkpoint"),
                model_path=str(out / "model.pth"),
                plots_dir=str(out / "plots"),
                audio_path=str(out / "none.wav"),
                ground_truth_path=str(out / "none.csv"))
    return Config(**{**base, **kw})


def test_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """Dropout 0.3: the step generators come from (seed + 1, batch_step) and
    the batch order from seed + epoch, so a run stopped after epoch 1 and
    resumed reproduces the uninterrupted run bit for bit."""
    full_cfg = _run_cfg(tmp_path, "full")
    full_hist = {}
    full, full_steps = train_model(full_cfg, _clips(), device="cpu",
                                   verbose=False, history_out=full_hist)
    part_cfg = _run_cfg(tmp_path, "part", n_epochs=1)
    part_hist = {}
    _, part_steps = train_model(part_cfg, _clips(), device="cpu",
                                verbose=False, history_out=part_hist)
    resumed, steps = train_model(
        part_cfg.replace(mode="resume", n_epochs=2), _clips(), device="cpu",
        verbose=False, history_out=part_hist)
    assert 0 < part_steps < steps == full_steps == opt_step_count(resumed)
    assert part_hist["train_losses"] == full_hist["train_losses"]
    assert part_hist["grad_norms"] == full_hist["grad_norms"]
    _assert_same_state(full, resumed)
    # and the exports match the final weights
    sd = torch.load(part_cfg.model_path, weights_only=True)
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(sd[k], v)


def test_model_pth_moves_between_the_packages(tmp_path):
    """The port's model.pth loads in the JAX package's load_torch_model to
    the same params, and a JAX-written one into the port's model."""
    cfg = Config(**GEOM)
    jcfg = JConfig(**GEOM)
    model = init_train_state(cfg, 1, generator=torch.Generator().manual_seed(4),
                             device="cpu").model
    path = ckpt.save_final_model(model, cfg, str(tmp_path / "port.pth"))
    params = torch_interop.load_torch_model(path, jcfg)
    back = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k

    jparams = jmodel.init_seq2seq(jax.random.PRNGKey(2), jcfg)
    torch_interop.save_torch_model(jparams, jcfg, str(tmp_path / "jax.pth"))
    ours = ckpt.load_model(str(tmp_path / "jax.pth"), cfg, device="cpu")
    want = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    for k, v in ours.state_dict().items():
        assert torch.equal(v, want[k]), k

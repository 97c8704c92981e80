"""The port's reference-name surface against the JAX package's: the compat
shims (compat.py), generate_facial_data_from_bytes_device, the chunked
research helpers, rope_qk and count_parameters.

Geometry: the reference fixture's (hidden 64, 2 layers, 4 heads), dropout
0, fp32, on JAX's seeded weights carried over by params_from_jax.
Tolerances: served frames atol 1e-6, rtol 1e-4 (the bound of
tests/test_torch_inference.py: fp32 features in another summation order,
divided by 100 at the end), on the first 2.5 s of the test-set speech, as
there (a pure tone is no parity input: its near-constant feature columns,
std ~1e-6, make CMVN divide the rounding noise of either package by that
std); losses rtol 1e-6 (one fp32 reduction in another order); the LR
schedule rtol 1e-6 (JAX's factor in fp32, LambdaLR's in float64); rope_qk
atol 1e-6 (fp32 products, one rounding each); the column helpers and
parameter counts exactly.
"""

import io
import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neurosync_trainer_lite_tpu import compat as jcompat
from neurosync_trainer_lite_tpu.config import Config as JConfig
from neurosync_trainer_lite_tpu.inference import chunked as jchunk
from neurosync_trainer_lite_tpu.inference import device_pipeline as jdp
from neurosync_trainer_lite_tpu.models import seq2seq as jmodel
from neurosync_trainer_lite_tpu.ops import rope as jrope
from neurosync_trainer_lite_tpu.training.optim import make_schedule
from neurosync_trainer_lite_tpu_torch import compat
from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.inference import chunked as tchunk
from neurosync_trainer_lite_tpu_torch.inference import device_pipeline as tdp
from neurosync_trainer_lite_tpu_torch.models.seq2seq import (
    Seq2Seq,
    count_parameters,
)
from neurosync_trainer_lite_tpu_torch.ops import rope as trope
from neurosync_trainer_lite_tpu_torch.training import loop as tloop
from neurosync_trainer_lite_tpu_torch.training.step import (
    init_train_state,
    make_train_step,
)
from neurosync_trainer_lite_tpu_torch.utils.weights import params_from_jax
from tests.test_torch_inference import _clip_bytes as speech_wav

REPO = Path(__file__).resolve().parent.parent
TINY = dict(hidden_dim=64, n_layers=2, num_heads=4, dropout=0.0,
            use_amp=False)
FULL_WIDTH_PARAMETERS = 235_472_957   # PERF.md §4; tests/test_model.py:122


def _tiny_dict(module=compat):
    d = dict(module.training_config)
    d.update(TINY)
    return d


def _sine_wav(seconds: float, sr: int = 88200) -> bytes:
    y = (0.2 * np.sin(np.arange(int(sr * seconds)) * 0.01)).astype(np.float32)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((y * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def same_weights():
    """JAX's compat.build_model and the port's model on its weights."""
    params = jcompat.build_model(_tiny_dict(jcompat))
    cfg = Config(**TINY)
    model = Seq2Seq(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg), strict=True)
    return params, model.eval()


# ---------------------------------------------------------------------------
# tests/test_compat.py's four cases, on the port


def test_training_config_mirrors_reference_keys():
    for key in ("mode", "sr", "frame_rate", "input_dim", "output_dim",
                "frame_size", "micro_batch_size", "hidden_dim", "n_layers",
                "num_heads", "dropout", "batch_size", "learning_rate",
                "weight_decay", "n_epochs", "delta", "w1", "w2",
                "use_multi_gpu", "num_gpus", "use_amp", "overlap",
                "root_dir", "model_path", "audio_path", "ground_truth_path",
                "checkpoint_path", "ffmpeg_path"):
        assert key in compat.training_config, key


def test_build_save_load_roundtrip(tmp_path):
    cfg_dict = _tiny_dict()
    model = compat.build_model(cfg_dict, device="cpu")
    path = str(tmp_path / "model.pth")
    compat.save_final_model(model, cfg_dict, path)
    restored = compat.load_model(path, cfg_dict, device="cpu")
    assert not restored.training
    for (ka, a), (kb, b) in zip(model.state_dict().items(),
                                restored.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka


def test_prepare_training_components():
    cfg_dict = _tiny_dict()
    model = compat.build_model(cfg_dict, device="cpu")
    criterion, optimizer, scheduler = compat.prepare_training_components(
        cfg_dict, model)
    loss = criterion(torch.zeros(1, 4, 61), torch.ones(1, 4, 61))
    assert float(loss) > 0
    assert isinstance(optimizer, torch.optim.Adam)
    assert scheduler.optimizer is optimizer


def test_generate_facial_data_from_bytes_reference_signature(monkeypatch):
    # the reference's call shape (audio_bytes, model, device), no config:
    # training_config is the default, here made the tiny geometry
    monkeypatch.setattr(compat, "training_config", _tiny_dict())
    model = compat.build_model(compat.training_config, device="cpu")
    out = compat.generate_facial_data_from_bytes(_sine_wav(2), model, "cpu")
    assert out.shape[1] == 61 and out.shape[0] > 0


# ---------------------------------------------------------------------------
# against the JAX package


def test_training_config_equals_jax_key_for_key():
    assert compat.training_config.keys() == jcompat.training_config.keys()
    for key, value in jcompat.training_config.items():
        assert compat.training_config[key] == value, key


def test_compat_serving_matches_jax(same_weights, monkeypatch):
    """The reference call shape (no config) and process_audio_features on
    extract_audio_features' features, against JAX's compat."""
    params, model = same_weights
    monkeypatch.setattr(compat, "training_config", _tiny_dict())
    monkeypatch.setattr(jcompat, "training_config", _tiny_dict(jcompat))
    wav = speech_wav(2.5)
    theirs = jcompat.generate_facial_data_from_bytes(wav, params, None)
    ours = compat.generate_facial_data_from_bytes(wav, model, "cpu")
    assert ours.shape == np.asarray(theirs).shape == (151, 61)
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=1e-4)

    feats, y = compat.extract_audio_features(wav, from_bytes=True,
                                             device="cpu")
    jfeats, jy = jcompat.extract_audio_features(wav, from_bytes=True)
    assert feats.shape == np.asarray(jfeats).shape
    np.testing.assert_array_equal(y, jy)
    ours = compat.process_audio_features(feats, model, "cpu")
    theirs = jcompat.process_audio_features(feats, params)
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=1e-4)


def test_compat_shims_refuse_a_model_on_another_device(same_weights):
    _, model = same_weights
    with pytest.raises(ValueError, match="model weights are on cpu"):
        compat.process_audio_features(np.zeros((130, 256), np.float32),
                                      model, "cuda", config=_tiny_dict())


def test_criterion_matches_jax():
    cfg_dict = _tiny_dict()
    model = compat.build_model(cfg_dict, device="cpu")
    criterion, _, _ = compat.prepare_training_components(cfg_dict, model)
    params = jcompat.build_model(_tiny_dict(jcompat))
    jcriterion, _, _ = jcompat.prepare_training_components(
        _tiny_dict(jcompat), params)
    rng = np.random.default_rng(0)
    pred = rng.standard_normal((4, 16, 61)).astype(np.float32)
    trg = rng.uniform(0, 1, (4, 16, 61)).astype(np.float32)
    ours = float(criterion(torch.from_numpy(pred), torch.from_numpy(trg)))
    theirs = float(jcriterion(jnp.asarray(pred), jnp.asarray(trg)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6)


def test_scheduler_lr_matches_jax_schedule():
    """After c scheduler steps the LR is JAX's compat schedule at count c
    (steps_per_epoch=1): 3 warm-up epochs, then the linear decay to 0."""
    kw = dict(warmup_epochs=3, n_epochs=10, learning_rate=1e-3)
    cfg_dict = {**_tiny_dict(), **kw}
    model = compat.build_model(cfg_dict, device="cpu")
    _, optimizer, scheduler = compat.prepare_training_components(cfg_dict,
                                                                 model)
    schedule = make_schedule(JConfig(**TINY, **kw), steps_per_epoch=1)
    lrs, theirs = [], []
    for c in range(12):
        lrs.append(optimizer.param_groups[0]["lr"])
        theirs.append(float(schedule(c)))
        optimizer.step()
        scheduler.step()
    assert lrs[0] == 0.0 and lrs[10] == lrs[11] == 0.0
    np.testing.assert_allclose(lrs, theirs, rtol=1e-6, atol=0)


def test_checkpoint_round_trip(tmp_path):
    cfg = Config(**TINY, input_dim=16, output_dim=5, micro_batch_size=8,
                 batch_size=4,
                 checkpoint_path=str(tmp_path / "ck" / "checkpoint"))
    state = init_train_state(cfg, 5, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.standard_normal((4, 8, 16)).astype(np.float32))
    trg = torch.from_numpy(rng.random((4, 8, 5)).astype(np.float32))
    make_train_step(cfg)(state, src, trg, torch.Generator().manual_seed(1))
    compat.save_checkpoint(state, 3, 7, cfg.to_dict())
    epoch, batch_step, back = compat.load_checkpoint(
        cfg.checkpoint_path, cfg.to_dict(), 5, device="cpu")
    assert (epoch, batch_step) == (3, 7)
    for (ka, a), (kb, b) in zip(state.model.state_dict().items(),
                                back.model.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    sa, sb = state.optimizer.state_dict(), back.optimizer.state_dict()
    for i, st in sa["state"].items():
        for key, value in st.items():
            assert torch.equal(torch.as_tensor(value),
                               torch.as_tensor(sb["state"][i][key])), (i, key)


def test_compat_train_model_is_the_loop():
    geom = dict(hidden_dim=32, n_layers=1, num_heads=2, input_dim=16,
                output_dim=5, dropout=0.0, use_amp=False, batch_size=8,
                micro_batch_size=16, n_epochs=1, validation_interval=4)
    rng = np.random.default_rng(0)
    clips = [(rng.standard_normal((n, 16)).astype(np.float32),
              rng.random((n, 5)).astype(np.float32)) for n in (70, 55)]
    runs = []
    for train in (compat.train_model, tloop.train_model):
        cfg = Config(**geom) if train is tloop.train_model else geom
        history = {}
        state, steps = train(cfg, clips, verbose=False, save_artifacts=False,
                             device="cpu", history_out=history)
        runs.append((state, steps, history))
    (sa, na, ha), (sb, nb, hb) = runs
    assert na == nb > 0
    for key in ("train_losses", "val_losses", "grad_norms"):
        assert ha[key] == hb[key], key
    for (ka, a), (kb, b) in zip(sa.model.state_dict().items(),
                                sb.model.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka


# ---------------------------------------------------------------------------
# the single names


def test_generate_facial_data_from_bytes_device_matches_jax(same_weights):
    params, model = same_weights
    jcfg, cfg = JConfig(**TINY), Config(**TINY)
    wav = speech_wav(2.5)
    for smoothing in (False, True):
        theirs = jdp.generate_facial_data_from_bytes_device(
            wav, params, jcfg, use_smoothing=smoothing)
        ours = tdp.generate_facial_data_from_bytes_device(
            wav, model, cfg, use_smoothing=smoothing, device="cpu")
        assert ours.shape == np.asarray(theirs).shape == (151, 61)
        np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=1e-4)
    short = _sine_wav(0.02)
    out = tdp.generate_facial_data_from_bytes_device(short, model, cfg,
                                                     device="cpu")
    theirs = jdp.generate_facial_data_from_bytes_device(short, params, jcfg)
    assert out[0] == theirs[0] == [] and out[1].size == theirs[1].size == 0


def test_chunked_column_helpers_match_jax():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((40, 61))
    np.testing.assert_array_equal(tchunk.zero_columns(data),
                                  jchunk.zero_columns(data))
    assert not np.array_equal(tchunk.zero_columns(data), data)
    reduced = rng.standard_normal((40, 48))
    np.testing.assert_array_equal(
        tchunk.add_specified_dimensions_back(reduced),
        jchunk.add_specified_dimensions_back(reduced))


def test_rope_qk_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 4, 24, 16)).astype(np.float32)
    k = rng.standard_normal((2, 4, 40, 16)).astype(np.float32)
    ours = trope.rope_qk(torch.from_numpy(q), torch.from_numpy(k))
    theirs = jrope.rope_qk(jnp.asarray(q), jnp.asarray(k))
    for a, b in zip(ours, theirs):
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)


def test_count_parameters_matches_jax(same_weights):
    params, model = same_weights
    assert count_parameters(model) == jmodel.count_parameters(params)


def test_count_parameters_at_full_width():
    """Counted on a meta-device model: no 235M parameters on the CPU."""
    cfg = Config()
    H, L, F_, I, O = 1024, 8, 4096, 256, 61
    attn = 4 * (H * H + H)
    ffn = H * F_ + F_ + F_ * H + H
    norm = 2 * H
    enc = (I * H + H) + L * (attn + ffn + 2 * norm) + norm
    dec = L * (2 * attn + ffn + 3 * norm) + (H * O + O) + norm
    assert enc + dec == FULL_WIDTH_PARAMETERS
    assert count_parameters(Seq2Seq(cfg, "meta")) == FULL_WIDTH_PARAMETERS


_TP_WORKER = """
import json, sys, torch
from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.models.seq2seq import (
    count_parameters, init_seq2seq)
from neurosync_trainer_lite_tpu_torch.parallel import distributed, make_mesh
store, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
distributed.initialize_distributed(init_method="file://" + store,
                                   num_processes=2, process_id=rank,
                                   device="cpu", timeout_s=60)
try:
    cfg = Config(**json.loads(sys.argv[4]), tp=2)
    model = init_seq2seq(cfg, torch.Generator().manual_seed(0), "cpu",
                         make_mesh(cfg))
    with open(out, "w") as f:
        json.dump({"count": count_parameters(model),
                   "local": sum(p.numel() for p in model.parameters())}, f)
finally:
    distributed.destroy()
"""


def test_count_parameters_at_tp2_is_the_full_models(tmp_path):
    """Two gloo CPU ranks at (dp, tp) = (1, 2): each holds half of every
    sharded leaf and counts the full model's parameters."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    outs = [tmp_path / f"r{r}.json" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TP_WORKER, str(tmp_path / "store"), str(r),
         str(outs[r]), json.dumps(TINY)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    full = count_parameters(Seq2Seq(Config(**TINY), "meta"))
    for out in outs:
        got = json.loads(out.read_text())
        assert got["count"] == full
        assert got["local"] < full

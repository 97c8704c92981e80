"""Reference-style API shims for users moving from NeuroSync Trainer Lite
(port of neurosync_trainer_lite_tpu/compat.py).

Each function keeps the reference's name and call shape (reference
file:line cited per function) and maps onto the port's own function, so
existing scripts move over with an import change:

    from neurosync_trainer_lite_tpu_torch import compat as neurosync
    model = neurosync.load_model('out/model.pth', neurosync.training_config)
    frames = neurosync.generate_facial_data_from_bytes(wav_bytes, model,
                                                       device=None)

`training_config` is a plain dict with the reference's config.py:26-55
keys; every function takes that dict or a typed Config. `device` is
honoured (the JAX shims ignore it): None is the CUDA card, and without a
card a call raises unless it passes device="cpu". The shims catch
nothing: a failure raises as the function underneath raises it.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.data import processing
from neurosync_trainer_lite_tpu_torch.inference import api, chunked
from neurosync_trainer_lite_tpu_torch.models.loss import loss_fn
from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq
from neurosync_trainer_lite_tpu_torch.training import checkpoint, loop
from neurosync_trainer_lite_tpu_torch.training.optim import (
    lr_factor,
    make_optimizer,
)
from neurosync_trainer_lite_tpu_torch.utils.device import (
    check_model_device,
    resolve_device,
)


def _cfg(config) -> Config:
    if isinstance(config, Config):
        return config
    return Config.from_dict(dict(config))


#: reference: config.py:26-55 (same keys, same defaults)
training_config: dict[str, Any] = Config().to_dict()


def build_model(config, device=None):
    """A fresh Seq2Seq at the configured scale on `device`, its weights
    drawn from a generator seeded with the config's seed (reference:
    utils/model_utils.py:22-26 build_model)."""
    cfg = _cfg(config)
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    return init_seq2seq(cfg, generator, device)


def load_model(model_path: str, config, device=None):
    """A reference-format model.pth (or one of the port's checkpoint
    directories) as a Seq2Seq in eval mode on `device` (reference:
    utils/model_utils.py:29-44)."""
    return checkpoint.load_model(model_path, _cfg(config), device)


def save_final_model(model, config, path: str | None = None) -> None:
    """Weights-only model.pth export (reference: model_utils.py:46-49)."""
    checkpoint.save_final_model(model, _cfg(config), path)


def prepare_training_components(config, model):
    """(criterion, optimizer, scheduler), the reference's own return shape
    (reference: utils/model_utils.py:9-20). The scheduler is a LambdaLR
    over the reference's factor, stepped once an epoch as the reference
    steps it: after c steps its LR is learning_rate · lr_factor(c), the
    JAX shim's optax schedule at count c."""
    cfg = _cfg(config)
    criterion = functools.partial(loss_fn, delta=cfg.delta, w1=cfg.w1,
                                  w2=cfg.w2, w3=cfg.w3)
    optimizer = make_optimizer(cfg, model.parameters())
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda epoch: lr_factor(epoch, cfg))
    return criterion, optimizer, scheduler


def train_model(config, clips=None, **kw):
    """Full training run (reference: train.py:12-58 train_model +
    __main__:61-104)."""
    return loop.train_model(_cfg(config), clips, **kw)


def generate_facial_data_from_bytes(audio_bytes: bytes, model, device=None,
                                    config=None):
    """Bytes → [T, 61] blendshapes (reference: utils/generate_face_shapes.py:8).

    The reference's signature takes (audio_bytes, model, device) and does
    not pass its config on (generate_face_shapes.py:15); here the config
    defaults to `training_config`, so that call shape works.
    """
    cfg = _cfg(config if config is not None else training_config)
    return api.generate_facial_data_from_bytes(audio_bytes, model, cfg,
                                               device=device)


def process_audio_features(audio_features, model, device=None, config=None):
    """Chunked features → blendshapes on the model's device, which must be
    `device` (reference: utils/audio/processing/audio_processing.py:50)."""
    check_model_device(model, device)
    cfg = _cfg(config if config is not None else training_config)
    return chunked.process_audio_features(np.asarray(audio_features), model,
                                          cfg)


def extract_audio_features(audio_input, sr: int = 88200,
                           from_bytes: bool = False, device=None):
    """(features [T, 256], waveform), the frontend on `device` (reference:
    utils/audio/extraction/extract_features.py:6)."""
    return processing.extract_audio_features(audio_input, sr, from_bytes,
                                             device=device)


def save_checkpoint(state, epoch, batch_step, config):
    """(reference: utils/checkpoint_utils.py:10)."""
    checkpoint.save_checkpoint(state, epoch, batch_step, _cfg(config))


def load_checkpoint(checkpoint_path, config, steps_per_epoch=1, device=None):
    """(epoch, batch_step, TrainState) on `device` (reference:
    checkpoint_utils.py:40)."""
    return checkpoint.load_checkpoint(checkpoint_path, _cfg(config),
                                      steps_per_epoch, device=device)

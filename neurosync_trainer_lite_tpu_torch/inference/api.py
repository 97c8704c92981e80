"""Bytes-in serving API, in PyTorch.

Port of neurosync_trainer_lite_tpu/inference/api.py. pipeline='device' runs
inference/device_pipeline.py (one upload, frontend, gather and decode on the
device, one download); pipeline='host' runs the reference's orchestration
(features downloaded, chunked on the host, uploaded, decoded). A failure on
either path raises: the JAX package's breaker, which serves from the host
path after device failures, is not ported, so a device fault is never
hidden behind a slower answer. Its reset, reset_device_pipeline_breaker,
has nothing to reset here and is not ported either.
"""

from __future__ import annotations

import numpy as np

from neurosync_trainer_lite_tpu_torch.config import Config, check_servable
from neurosync_trainer_lite_tpu_torch.data.processing import extract_audio_features
from neurosync_trainer_lite_tpu_torch.inference import device_pipeline as dp
from neurosync_trainer_lite_tpu_torch.inference.chunked import process_audio_features
from neurosync_trainer_lite_tpu_torch.utils.device import check_model_device


def smooth_by_averaging_pairs(data: np.ndarray) -> np.ndarray:
    smoothed = data.copy()
    smoothed[:-1] = (data[:-1] + data[1:]) / 2.0
    return smoothed


def generate_facial_data_from_bytes(audio_bytes: bytes, model, cfg: Config,
                                    use_smoothing: bool = False,
                                    pipeline: str = "device", device=None):
    """WAV/audio bytes → [T, 61] blendshape frames at 60 fps, or the
    reference's ([], np.array([])) for a clip too short to featurise.

    Runs where `device` says (the CUDA card by default); the model's weights
    must already live there.
    """
    check_servable(cfg)
    if pipeline == "device":
        return dp.generate_facial_data_from_bytes_device(
            audio_bytes, model, cfg, use_smoothing, device)
    if pipeline != "host":
        raise ValueError(f"pipeline must be 'device' or 'host', got {pipeline!r}")
    device = check_model_device(model, device)
    audio_features, y = extract_audio_features(
        audio_bytes, sr=cfg.sr, from_bytes=True, device=device)
    if audio_features is None or y is None:
        return [], np.array([])
    out = process_audio_features(audio_features, model, cfg)
    if use_smoothing:
        out = smooth_by_averaging_pairs(out)
    return out

"""Device-resident WAV→blendshape serving pipeline, in PyTorch.

Port of neurosync_trainer_lite_tpu/inference/device_pipeline.py. One upload
and one download per request:

- A 16-bit mono WAV at cfg.sr uploads as raw int16 (half the bytes of
  fp32) and is widened by /32768 (exact in fp32) and peak-normalised on the
  device, bitwise the host loader's result. Anything else decodes on the
  host first and uploads normalised fp32.
- The frontend runs on the device at the true clip length, so the
  clip-global statistics (CMVN, top_db) are those of the clip.
- The chunk gather (reflect-padded short chunks, the tail chunk) indexes
  the feature rows on the device, and all chunks decode in one forward at
  the true chunk count.
- One download of the [chunks, frame_size, output_dim] frames, then the
  overlap blend, tail and ÷100 rescale on the host
  (inference/chunked.py:blend_decoded_chunks).

There is no sample bucket and no chunk bucket: the JAX package pads the
waveform and the chunk batch to bound XLA recompiles, which eager PyTorch
does not have.
"""

from __future__ import annotations

import io
import wave

import numpy as np
import torch

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.inference.chunked import (
    blend_decoded_chunks,
    chunk_plan,
)
from neurosync_trainer_lite_tpu_torch.ops.frontend import (
    extract_features,
    num_frames_60,
    too_short,
    widen_and_normalize,
)
from neurosync_trainer_lite_tpu_torch.utils.audio_io import load_audio_from_bytes
from neurosync_trainer_lite_tpu_torch.utils.device import (
    check_model_device,
    module_device,
)


def _gather_rows(num_frames: int, frame_length: int, overlap: int):
    """Gather index rows [N(+tail), frame_length] mirroring the host path's
    chunk extraction and reflect tail padding, plus the chunk plan."""
    starts, lengths, remaining = chunk_plan(num_frames, frame_length, overlap)

    def reflect_rows(s: int, L: int) -> np.ndarray:
        idx = np.arange(s, s + L)
        if L < frame_length:
            idx = np.pad(idx, (0, frame_length - L), mode="reflect")
        return idx

    rows = [reflect_rows(s, L) for s, L in zip(starts, lengths)]
    if remaining > 0:
        rows.append(reflect_rows(num_frames - remaining, remaining))
    return np.asarray(rows, np.int64), lengths, remaining


@torch.inference_mode()
def infer_waveform_device(y: np.ndarray, model, cfg: Config,
                          *, normalized: bool = False) -> np.ndarray | None:
    """Mono waveform at cfg.sr → [T, output_dim] LiveLink frames on the
    model's device, or None for a clip shorter than the frontend minimum.

    y: int16 PCM (uploaded raw; widened and peak-normalised on the device)
    or a float array (peak-normalised on the host unless normalized=True).
    """
    device = module_device(model)
    y = np.asarray(y).reshape(-1)
    n = y.shape[0]
    if too_short(n, cfg.sr):
        return None
    if y.dtype == np.int16:
        y_dev = widen_and_normalize(torch.from_numpy(y.copy()).to(device))
    else:
        yf = np.asarray(y, np.float32)
        if not normalized:
            peak = np.max(np.abs(yf)) if yf.size else 0.0
            if peak > 0:
                yf = yf / peak
        y_dev = torch.from_numpy(np.ascontiguousarray(yf)).to(device)

    feats = extract_features(y_dev, cfg.sr)
    num_frames = num_frames_60(n, int(0.01667 * cfg.sr))
    rows, lengths, remaining = _gather_rows(num_frames, cfg.frame_size,
                                            cfg.overlap)
    chunks = feats[torch.from_numpy(rows).to(device)]
    decoded = model(chunks).cpu().numpy().astype(np.float64)
    return blend_decoded_chunks(decoded, lengths, remaining, cfg.overlap,
                                num_frames)


def _sniff_wav_int16(audio_bytes: bytes, sr: int) -> np.ndarray | None:
    """Raw int16 samples iff the bytes are a 16-bit mono WAV already at sr."""
    try:
        with wave.open(io.BytesIO(audio_bytes)) as w:
            if (w.getsampwidth() == 2 and w.getnchannels() == 1
                    and w.getframerate() == sr):
                return np.frombuffer(
                    w.readframes(w.getnframes()), dtype="<i2")
    except (wave.Error, EOFError):
        pass
    return None


def decode_bytes_to_waveform(audio_bytes: bytes, cfg: Config):
    """(waveform, normalized): raw int16 for a 16-bit mono WAV at cfg.sr,
    else the host loader's peak-normalised fp32. Raises on undecodable input."""
    i16 = _sniff_wav_int16(audio_bytes, cfg.sr)
    if i16 is not None:
        return i16, False
    y, _ = load_audio_from_bytes(audio_bytes, cfg.sr)
    return y, True


def generate_facial_data_from_bytes_device(audio_bytes: bytes, model,
                                           cfg: Config,
                                           use_smoothing: bool = False,
                                           device=None):
    """Bytes-in serving on the device pipeline: [T, 61] frames, or the
    bytes API's ([], np.array([])) for a clip too short to featurise.
    inference/api.py:generate_facial_data_from_bytes at pipeline='device'
    is this function; `device` is checked against the model's weights as
    there."""
    from neurosync_trainer_lite_tpu_torch.inference.api import (
        smooth_by_averaging_pairs)

    check_model_device(model, device)
    y, normalized = decode_bytes_to_waveform(audio_bytes, cfg)
    out = infer_waveform_device(y, model, cfg, normalized=normalized)
    if out is None:
        return [], np.array([])
    if use_smoothing:
        out = smooth_by_averaging_pairs(out)
    return out

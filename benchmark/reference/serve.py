"""The plain reference of a served request: WAV bytes → [T, 61] frames.

The reference repository's serving path (``utils/audio/processing/
audio_processing.py:50-96`` and the Local API's bytes entry): decode the
16-bit WAV, peak-normalise, extract the features (reference/frontend.py),
cut them into frame_size chunks at stride frame_size − overlap (a short
chunk reflect-padded), decode each chunk, cross-fade the `overlap` frames
where consecutive chunks meet, decode the tail that the blends left short,
and divide the 61 blendshapes by 100.
"""

from __future__ import annotations

import io
import wave

import numpy as np
import torch

from benchmark.common import flops
from benchmark.reference import frontend
from benchmark.reference import model as ref_model

BLENDSHAPE_SCALE = 100.0


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """16-bit PCM WAV → (peak-normalised float64 mono, sample rate)."""
    with wave.open(io.BytesIO(data)) as w:
        if w.getsampwidth() != 2:
            raise ValueError("the reference reads 16-bit WAVs")
        ch, sr = w.getnchannels(), w.getframerate()
        y = np.frombuffer(w.readframes(w.getnframes()), "<i2") / 32768.0
    if ch > 1:
        y = y.reshape(-1, ch).mean(axis=1)
    peak = np.max(np.abs(y)) if y.size else 0.0
    return (y / peak if peak > 0 else y), sr


def _pad(chunk: np.ndarray, length: int) -> np.ndarray:
    if chunk.shape[0] < length:
        pad = length - chunk.shape[0]
        padded = np.pad(chunk, ((0, pad), (0, 0)), mode="reflect")
        chunk = np.vstack((chunk, padded[-pad:, :chunk.shape[1]]))
    return chunk


def _blend(a: np.ndarray, b: np.ndarray, overlap: int) -> np.ndarray:
    n = min(overlap, len(a), len(b))
    if n == 0:
        return np.vstack((a, b))
    out = np.copy(a)
    alpha = (np.arange(n) / n)[:, None]
    out[-n:] = (1 - alpha) * a[-n:] + alpha * b[:n]
    return np.vstack((out, b[n:]))


def plan(num_frames: int, length: int, overlap: int):
    """(chunk starts, valid lengths, tail frames or 0): the serial
    accumulate of the reference, run on lengths alone."""
    starts = list(range(0, num_frames, length - overlap))
    lengths = [min(s + length, num_frames) - s for s in starts]
    acc = lengths[0] if lengths else 0
    for n in lengths[1:]:
        acc += n - min(overlap, acc, n)
    return starts, lengths, max(0, num_frames - acc)


def serve(data: bytes, weights: dict, config: dict, *, prec: str = "fp32",
          device="cpu") -> np.ndarray:
    y, sr = decode_wav(data)
    feats = frontend.features(y, sr)
    length, overlap = int(config["frame_size"]), int(config["overlap"])
    T = feats.shape[0]
    starts, lengths, tail = plan(T, length, overlap)
    chunks = [_pad(feats[s:s + length], length) for s in starts]
    if tail:
        chunks.append(_pad(feats[T - tail:], length))
    x = torch.from_numpy(np.asarray(chunks, np.float32)).to(device)
    out = ref_model.eval_forward(weights, x, flops.dims(config), prec=prec)
    out = out.double().cpu().numpy()
    acc = out[0][:lengths[0]]
    for i in range(1, len(lengths)):
        acc = _blend(acc, out[i][:lengths[i]], overlap)
    if tail:
        acc = np.vstack((acc, out[-1][:tail]))
    final = acc[:T]
    final[:, :61] /= BLENDSHAPE_SCALE
    return final


def chunk_count(num_samples: int, config: dict) -> int:
    """How many chunks the reference decodes for a clip of this length."""
    sr = int(config["sr"])
    length = int(0.01667 * sr)
    hop = length // 2
    t120 = (num_samples + 2 * (length // 2) - length) // hop + 1
    t60 = t120 // 2 + t120 % 2
    starts, _, tail = plan(t60, int(config["frame_size"]),
                           int(config["overlap"]))
    return len(starts) + (1 if tail else 0)

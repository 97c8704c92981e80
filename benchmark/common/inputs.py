"""Inputs that the benchmark makes from --seed and hands to the program and
to the reference alike: the weights, the training corpus, the audio.

Everything is drawn on the device with a torch.Generator in a few large
calls, so set-up stays short and the same seed gives the same bytes in
every run and in the reference, which draws them again after the window.
"""

from __future__ import annotations

import io
import math
import wave
from statistics import NormalDist

import numpy as np
import torch

from benchmark.reference.model import param_shapes

#: torch.Generator.manual_seed takes 64 bits
SEED_MASK = (1 << 63) - 1


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on `device` for one purpose (`stream`) of one seed."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) & SEED_MASK)
    return g


def seeded_weights(d: dict, seed: int, device) -> dict:
    """The model at its initialisation: every Linear weight N(0, 0.02),
    biases 0, LayerNorm scales 1 and shifts 0, as a state dict in the
    reference's names. One draw for all the weights."""
    shapes = param_shapes(d)
    mats = {k: s for k, s in shapes.items() if len(s) == 2}
    flat = torch.randn(sum(math.prod(s) for s in mats.values()),
                       generator=generator(seed, device, 1),
                       device=device).mul_(0.02)
    out, offset = {}, 0
    for k, s in shapes.items():
        if len(s) == 2:
            n = math.prod(s)
            out[k] = flat[offset: offset + n].view(s)
            offset += n
        elif "norm" in k and k.endswith(".weight"):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def corpus_series(seed: int, clips: int, frames: int, input_dim: int,
                  output_dim: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """`clips` clips of `frames` frames end to end, on the device: features
    N(0, 1) (as the frontend's CMVN'd MFCCs and normalised lags are) and
    blendshape targets in [0, 1)."""
    g = generator(seed, device, 2)
    audio = torch.randn(clips * frames, input_dim, generator=g,
                        device=device)
    facial = torch.rand(clips * frames, output_dim, generator=g,
                        device=device)
    return audio, facial


def corpus(seed: int, clips: int, frames: int, input_dim: int,
           output_dim: int, device) -> list[tuple[np.ndarray, np.ndarray]]:
    """corpus_series as the program takes it: a (features, targets) pair of
    host arrays a clip, copied from the device once."""
    audio, facial = (t.cpu().numpy() for t in corpus_series(
        seed, clips, frames, input_dim, output_dim, device))
    return [(audio[i * frames:(i + 1) * frames],
             facial[i * frames:(i + 1) * frames]) for i in range(clips)]


def ladder(rungs: int, median_s: float, sigma: float, lo: float,
           hi: float) -> list[float]:
    """The `rungs` quantiles (i + ½)/rungs of a log-normal with this median
    and σ, clipped to [lo, hi]: the same mix of lengths under every seed."""
    nd = NormalDist()
    return [min(hi, max(lo, median_s * math.exp(
        sigma * nd.inv_cdf((i + 0.5) / rungs)))) for i in range(rungs)]


def speech_like(seed: int, index: int, n: int, sr: int, device) -> np.ndarray:
    """n samples of noise under a syllable-rate envelope (3-7 Hz bursts
    with pauses), float32 in [-1, 1]: the frontend and every chunk see
    loud and quiet frames."""
    g = generator(seed, device, 1000 + index)
    noise = torch.randn(n, generator=g, device=device)
    rate = 3.0 + 4.0 * float(torch.rand(1, generator=g, device=device))
    t = torch.arange(n, device=device, dtype=torch.float32) / sr
    env = torch.clamp(torch.sin(2 * math.pi * rate * t), min=0.0) ** 2
    y = 0.3 * noise * (0.05 + env)
    return y.clamp(-1.0, 1.0).cpu().numpy()


def wav_bytes(y: np.ndarray, sr: int) -> bytes:
    """A 16-bit mono WAV of float samples in [-1, 1]."""
    pcm = np.clip(np.asarray(y, np.float64) * 32767.0, -32768,
                  32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()

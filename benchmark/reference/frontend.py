"""The plain reference of the audio frontend, in float64 NumPy and SciPy.

Written from the reference repository's feature extraction
(``utils/audio/extraction/extract_features.py`` over librosa), not from the
port: at 60 fps, for frame_length = int(0.01667·sr) and hop frame_length//2
at 120 fps,

- MFCC(23) of the centred, zero-padded, periodic-Hann STFT (n_fft =
  frame_length) through 128 Slaney mel filters, power to dB (floor 1e-10,
  top_db 80 under the clip's maximum) and the orthonormal DCT-II; CMVN over
  the clip (population std, +1e-10); the first and second Savitzky-Golay
  deltas (width 9, mode 'interp', as librosa.feature.delta);
- the autocorrelation of each reflect-padded frame, mean removed, under a
  symmetric Hann window, normalised by its zero lag, lags 1..187; an edge
  frame that is silent (every lag under 1e-7) takes its neighbour's lags;
- both pair-averaged from 120 to 60 fps, an odd last frame kept alone, and
  stacked as [T60, 69 + 187].
"""

from __future__ import annotations

import numpy as np
from scipy.fft import dct
from scipy.signal import savgol_filter

N_MELS, N_MFCC, N_LAGS, DELTA_WIDTH = 128, 23, 187, 9


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz)
                                               / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


def mel_filters(sr: int, n_fft: int, n_mels: int = N_MELS) -> np.ndarray:
    """Slaney-scale triangles with Slaney (area) normalisation,
    [n_mels, 1 + n_fft//2], from 0 Hz to sr/2."""
    freqs = np.arange(1 + n_fft // 2) * sr / n_fft
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0),
                                n_mels + 2))
    out = np.zeros((n_mels, freqs.size))
    for i in range(n_mels):
        lo, mid, hi = hz[i], hz[i + 1], hz[i + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        out[i] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (hi - lo)
    return out


def _frames(y: np.ndarray, length: int, hop: int) -> np.ndarray:
    n = (y.size - length) // hop + 1
    idx = np.arange(length)[None, :] + hop * np.arange(n)[:, None]
    return y[idx]


def _pairs(x: np.ndarray) -> np.ndarray:
    """[C, T] → [C, ceil(T/2)]: pair means, an odd last frame alone."""
    T = x.shape[1]
    out = x[:, :T // 2 * 2].reshape(x.shape[0], -1, 2).mean(axis=2)
    if T % 2:
        out = np.concatenate([out, x[:, -1:]], axis=1)
    return out


def mfcc_69(y: np.ndarray, sr: int) -> np.ndarray:
    length = int(0.01667 * sr)
    hop, half = length // 2, length // 2
    n = np.arange(length)
    window = 0.5 - 0.5 * np.cos(2 * np.pi * n / length)
    frames = _frames(np.pad(y, (half, half)), length, hop) * window
    power = np.abs(np.fft.rfft(frames, n=length, axis=1)) ** 2
    mel = power @ mel_filters(sr, length).T
    db = 10.0 * np.log10(np.maximum(mel, 1e-10))
    db = np.maximum(db, db.max() - 80.0)
    mfcc = dct(db, type=2, norm="ortho", axis=1)[:, :N_MFCC].T   # [23, T]
    mfcc = (mfcc - mfcc.mean(axis=1, keepdims=True)) / (
        mfcc.std(axis=1, keepdims=True) + 1e-10)
    d1 = savgol_filter(mfcc, DELTA_WIDTH, polyorder=1, deriv=1, axis=-1,
                       mode="interp")
    d2 = savgol_filter(mfcc, DELTA_WIDTH, polyorder=2, deriv=2, axis=-1,
                       mode="interp")
    return _pairs(np.concatenate([mfcc, d1, d2])).T


def autocorr_187(y: np.ndarray, sr: int) -> np.ndarray:
    length = int(0.01667 * sr)
    hop, half = length // 2, length // 2
    frames = _frames(np.pad(y, (half, half), mode="reflect"), length, hop)
    frames = (frames - frames.mean(axis=1, keepdims=True)) * np.hanning(
        length)
    nfft = 1 << (2 * length - 1).bit_length()
    spec = np.fft.rfft(frames, n=nfft, axis=1)
    ac = np.fft.irfft(np.abs(spec) ** 2, n=nfft, axis=1)[:, :N_LAGS + 1]
    r0 = ac[:, :1]
    ac = np.where(r0 != 0, ac / np.where(r0 == 0, 1.0, r0), ac)[:, 1:]
    if np.all(np.abs(ac[0]) < 1e-7):
        ac[0] = ac[1]
    if np.all(np.abs(ac[-1]) < 1e-7):
        ac[-1] = ac[-2]
    return _pairs(ac.T).T


def features(y: np.ndarray, sr: int) -> np.ndarray:
    """Peak-normalised mono waveform → [T60, 256] float64 features."""
    y = np.asarray(y, np.float64)
    return np.concatenate([mfcc_69(y, sr), autocorr_187(y, sr)], axis=1)

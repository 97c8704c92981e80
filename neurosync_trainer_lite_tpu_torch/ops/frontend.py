"""The audio feature frontend on the device, in PyTorch.

Port of neurosync_trainer_lite_tpu/ops/frontend.py at the true clip length:

  features[T60, 256] = hstack(
      CMVN MFCC(23) + delta + delta²   (69),
      zero-lag-normalised autocorrelation lags 1..187   (187),
  ) pair-averaged from 120 to 60 fps

with frame_length = int(0.01667*sr) and hop = frame_length // 2.

- The STFT is a matmul with precomputed rDFT cos/−sin matrices, then the mel
  and DCT-II projections are matmuls too. The autocorrelation is a
  power-of-two rfft/irfft (Wiener–Khinchin).
- The Savitzky-Golay deltas are an unfold + matmul over the interior plus
  two small edge matrices (scipy mode='interp'). Unlike a convolution, which
  cuDNN runs in TF32 by default, this stays fp32. The matmuls need
  torch.backends.cuda.matmul.allow_tf32 False, PyTorch's default.
- CMVN and the top_db clamp use clip-global statistics, so the features of
  a frame depend on the whole clip; they are taken at the true length.

The valid-length variants (extract_features_valid and its helpers) run the
same math over K zero-padded rows [K, S] at once, each row's statistics
taken over its own valid length n_samples[k], a tensor on the device: one
request at its true length needs none of them, but one pass over K live
sessions of different lengths does (inference/multi_stream.py). Rows at or
past a row's valid frame count are garbage that no caller reads. Where the
JAX functions slice at a traced start, jax.lax.dynamic_slice clamps the
start so that the slice fits; torch indexing would wrap or raise, so every
such start is clamped here explicitly, to the same values. Nothing in them
synchronises with the host.
"""

from __future__ import annotations

import functools
from math import factorial

import numpy as np
import torch
import torch.nn.functional as nnf

from neurosync_trainer_lite_tpu_torch.ops import frontend_np as F
from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device

N_MELS = 128
N_MFCC = 23
N_LAGS = 187
SG_WIDTH = 9

# ---------------------------------------------------------------------------
# host-precomputed constants
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _rdft_matrices(n_fft: int):
    """Real DFT as two matrices [n_fft, 1+n_fft//2] (cos, -sin)."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(1 + n_fft // 2)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return (np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _mfcc_constants(sr: int, n_fft: int, n_mels: int, n_mfcc: int):
    return (
        F.hann_periodic(n_fft).astype(np.float32),
        F.mel_filterbank(sr, n_fft, n_mels).astype(np.float32).T,   # [736, 128]
        F.dct_ii_ortho_matrix(n_mfcc, n_mels).astype(np.float32).T,  # [128, 23]
    )


@functools.lru_cache(maxsize=8)
def _savgol_constants(width: int, order: int):
    """(reversed interior kernel, left edge matrix, right edge matrix)."""
    from scipy.signal import savgol_coeffs

    kernel = savgol_coeffs(width, polyorder=order, deriv=order, delta=1.0)[::-1]
    V = np.vander(np.arange(width), order + 1, increasing=True)
    pinv = np.linalg.pinv(V)

    def deriv_row(t):
        # d-th derivative of the least-squares polynomial fit at position t,
        # as a linear functional of the window (scipy mode='interp')
        d = order
        row = np.zeros(width)
        for j in range(d, order + 1):
            row += factorial(j) / factorial(j - d) * t ** (j - d) * pinv[j]
        return row

    half = width // 2
    left = np.array([deriv_row(t) for t in range(half)])
    right = np.array([deriv_row(t) for t in range(width - half, width)])
    return (kernel.astype(np.float32).copy(),
            left.astype(np.float32), right.astype(np.float32))


@functools.lru_cache(maxsize=8)
def _device_constants(sr: int, frame_length: int, device: torch.device):
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    win, mel_T, dct_T = _mfcc_constants(sr, frame_length, N_MELS, N_MFCC)
    cos_m, msin_m = _rdft_matrices(frame_length)
    consts = {
        "win": put(win), "mel_T": put(mel_T), "dct_T": put(dct_T),
        "cos_m": put(cos_m), "msin_m": put(msin_m),
        "hann_sym": put(F.hann_symmetric(frame_length).astype(np.float32)),
    }
    for order in (1, 2):
        consts[f"sg{order}"] = tuple(
            put(c) for c in _savgol_constants(SG_WIDTH, order))
    return consts


# ---------------------------------------------------------------------------
# feature math
# ---------------------------------------------------------------------------


def _frame_half_overlap(y: torch.Tensor, frame_length: int) -> torch.Tensor:
    """[..., T, frame_length] frames at hop frame_length//2 of a padded
    signal (librosa.util.frame's hop arithmetic, for odd and even lengths)."""
    return y.unfold(-1, frame_length, frame_length // 2)


def _savgol_delta(x: torch.Tensor, consts) -> torch.Tensor:
    """Savitzky-Golay derivative along time. x [..., C, T] → [..., C, T]."""
    kernel, left, right = consts
    width = kernel.shape[0]
    interior = x.unfold(-1, width, 1) @ kernel       # [..., C, T-w+1]
    first = x[..., :width] @ left.T                  # [..., C, half]
    last = x[..., -width:] @ right.T                 # [..., C, half]
    return torch.cat([first, interior, last], dim=-1)


def _reduce_features(x: torch.Tensor) -> torch.Tensor:
    """Pair-average over time (120→60 fps), keep an odd tail. x [C, T]."""
    T = x.shape[1]
    reduced = x[:, : T // 2 * 2].reshape(x.shape[0], -1, 2).mean(dim=2)
    if T % 2 == 1:
        reduced = torch.cat([reduced, x[:, -1:]], dim=1)
    return reduced


def _mel_db(y: torch.Tensor, frame_length: int, c) -> torch.Tensor:
    """[..., T120, 128]: log-mel power (dB) of the centred, zero-padded
    hann-periodic STFT of y [..., S]."""
    half = frame_length // 2
    y_pad = nnf.pad(y, (half, half))
    frames = _frame_half_overlap(y_pad, frame_length) * c["win"]

    re = frames @ c["cos_m"]
    im = frames @ c["msin_m"]
    power = re * re + im * im                            # [..., T, 736]

    mel = power @ c["mel_T"]                             # [..., T, 128]
    return 10.0 * torch.log10(torch.clamp_min(mel, 1e-10))


def _mfcc_23(y: torch.Tensor, frame_length: int, c) -> torch.Tensor:
    """[23, T120]: MFCC of the centred, zero-padded hann-periodic STFT."""
    mel_db = _mel_db(y, frame_length, c)
    mel_db = torch.maximum(mel_db, mel_db.max() - 80.0)  # top_db, global max
    return (mel_db @ c["dct_T"]).T                       # [23, T]


def _mfcc_69(y: torch.Tensor, frame_length: int, c) -> torch.Tensor:
    """[T60, 69]: CMVN MFCC(23) + delta + delta² at 60 fps."""
    mfcc = _mfcc_23(y, frame_length, c)
    mean = mfcc.mean(dim=1, keepdim=True)
    std = mfcc.std(dim=1, keepdim=True, correction=0)
    mfcc = (mfcc - mean) / (std + 1e-10)

    stacked = torch.cat(
        [mfcc, _savgol_delta(mfcc, c["sg1"]), _savgol_delta(mfcc, c["sg2"])],
        dim=0)
    return _reduce_features(stacked).T


def _autocorr_lags(y_pad: torch.Tensor, frame_length: int, c,
                   num_coeff: int = N_LAGS) -> torch.Tensor:
    """[..., T, 187]: zero-lag-normalised autocorrelation lags 1..187 of
    the half-overlap frames of an already reflect-padded y_pad [..., S']."""
    frames = _frame_half_overlap(y_pad, frame_length)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = frames * c["hann_sym"]

    nfft = pow2_bucket(2 * frame_length - 1)
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)
    ac = torch.fft.irfft(spec.abs() ** 2, n=nfft, dim=-1)[..., : num_coeff + 1]

    r0 = ac[..., :1]
    ac = torch.where(r0 != 0, ac / torch.where(r0 == 0, 1.0, r0), ac)
    return ac[..., 1:]


def _autocorr_187(y: torch.Tensor, frame_length: int, c,
                  num_coeff: int = N_LAGS) -> torch.Tensor:
    """[T60, 187]: zero-lag-normalised autocorrelation lags 1..187."""
    half = frame_length // 2
    y_pad = nnf.pad(y[None, None], (half, half), mode="reflect")[0, 0]
    ac = _autocorr_lags(y_pad, frame_length, c, num_coeff)  # [T, 187]

    # near-silent edge frames take their neighbour's lags
    first_dead = (ac[0].abs() < 1e-7).all()
    last_dead = (ac[-1].abs() < 1e-7).all()
    first = torch.where(first_dead, ac[1], ac[0])
    last = torch.where(last_dead, ac[-2], ac[-1])
    ac = torch.cat([first[None], ac[1:-1], last[None]], dim=0)
    return _reduce_features(ac.T).T


def extract_features(y: torch.Tensor, sr: int) -> torch.Tensor:
    """fp32 waveform (on any device) → [T60, 256] features on that device."""
    frame_length = int(0.01667 * sr)
    c = _device_constants(sr, frame_length, y.device)
    return torch.cat([_mfcc_69(y, frame_length, c),
                      _autocorr_187(y, frame_length, c)], dim=1)


# ---------------------------------------------------------------------------
# valid-length variants: K zero-padded rows, each with its own valid length
# ---------------------------------------------------------------------------


def _window(x: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """Gather/scatter index along x's last axis for each row k of x
    [K, ..., T]: [start_k, start_k + size), the start clamped to
    [0, T - size] as jax.lax.dynamic_slice clamps it."""
    idx = (start.clamp(0, x.shape[-1] - size)[:, None]
           + torch.arange(size, device=x.device))
    idx = idx.view(idx.shape[0], *([1] * (x.dim() - 2)), size)
    return idx.expand(*x.shape[:-1], size)


def _take(x: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """jax.lax.dynamic_slice of each row along the last axis."""
    return x.gather(-1, _window(x, start, size))


def _put(x: torch.Tensor, patch: torch.Tensor,
         start: torch.Tensor) -> torch.Tensor:
    """jax.lax.dynamic_update_slice of each row along the last axis."""
    return x.scatter(-1, _window(x, start, patch.shape[-1]), patch)


def _savgol_delta_valid(x: torch.Tensor, t_valid: torch.Tensor,
                        consts) -> torch.Tensor:
    """_savgol_delta of x [K, C, T] with the right-edge rows re-derived at
    each row's valid end (the static edge matrices sit at the bucket end)."""
    kernel, _, right = consts
    width = kernel.shape[0]
    out = _savgol_delta(x, consts)
    patch = _take(x, t_valid - width, width) @ right.T   # [K, C, half]
    return _put(out, patch, t_valid - width // 2)


def _reduce_features_valid(x: torch.Tensor,
                           t_valid: torch.Tensor) -> torch.Tensor:
    """Pair-average over time with each row's odd valid tail kept.
    x [K, C, T] → [K, C, T//2]; output rows at index ≥ (t_valid+1)//2 are
    garbage. An odd bucket's last row is dropped (it is garbage)."""
    if x.shape[-1] % 2 == 1:
        x = x[..., :-1]
    red = x.reshape(*x.shape[:-1], -1, 2).mean(dim=-1)
    # odd valid length: the last valid output row is the single frame
    # x[..., t_valid-1], not a pair average (as _reduce_features' tail)
    patched = _put(red, _take(x, t_valid - 1, 1), t_valid // 2)
    return torch.where((t_valid % 2 == 1)[:, None, None], patched, red)


def _mfcc_69_valid(y: torch.Tensor, frame_length: int, t120: torch.Tensor,
                   c) -> torch.Tensor:
    """_mfcc_69 of y [K, S] with t120[k] valid frames: [K, T60, 69]."""
    mel_db = _mel_db(y, frame_length, c)                  # [K, T, 128]
    valid = (torch.arange(mel_db.shape[1], device=y.device)[None, :]
             < t120[:, None])                              # [K, T]
    vmax = torch.where(valid[..., None], mel_db, -torch.inf).amax(dim=(1, 2))
    mel_db = torch.maximum(mel_db, (vmax - 80.0)[:, None, None])

    mfcc = (mel_db @ c["dct_T"]).transpose(1, 2)           # [K, 23, T]
    # CMVN over each row's valid frames only
    mask = valid[:, None, :].float()
    n = t120.float()[:, None, None]
    mean = (mfcc * mask).sum(dim=-1, keepdim=True) / n
    var = ((mfcc - mean).square() * mask).sum(dim=-1, keepdim=True) / n
    mfcc = (mfcc - mean) / (var.sqrt() + 1e-10)

    stacked = torch.cat([mfcc, _savgol_delta_valid(mfcc, t120, c["sg1"]),
                         _savgol_delta_valid(mfcc, t120, c["sg2"])], dim=1)
    return _reduce_features_valid(stacked, t120).transpose(1, 2)


def _autocorr_187_valid(y: torch.Tensor, frame_length: int,
                        n_samples: torch.Tensor, t120: torch.Tensor,
                        c) -> torch.Tensor:
    """_autocorr_187 of y [K, S] with n_samples[k] valid: [K, T60, 187].

    Each row's bucket must hold n_samples + frame_length//2 + 1 samples, so
    that its reflected tail fits in the zero region (the callers' buckets
    do)."""
    half = frame_length // 2
    # write each row's reflect-pad into its zero region: np.pad reflect
    # appends y[n-2], y[n-3], ..., y[n-half-1]
    tail = _take(y, n_samples - (half + 1), half + 1)[:, :-1].flip(-1)
    y = _put(y, tail, n_samples)
    y_pad = nnf.pad(y[:, None], (half, half), mode="reflect")[:, 0]
    ac = _autocorr_lags(y_pad, frame_length, c).transpose(1, 2)  # [K, 187, T]

    # dead-edge fix at the first frame and at each row's last valid frame
    first_dead = (ac[..., 0].abs() < 1e-7).all(dim=-1)
    ac = torch.cat([torch.where(first_dead[:, None, None], ac[..., 1:2],
                                ac[..., :1]), ac[..., 1:]], dim=-1)
    lastf = _take(ac, t120 - 1, 1)
    prevf = _take(ac, t120 - 2, 1)
    last_dead = (lastf.abs() < 1e-7).all(dim=-1).all(dim=-1)
    ac = _put(ac, torch.where(last_dead[:, None, None], prevf, lastf),
              t120 - 1)
    return _reduce_features_valid(ac, t120).transpose(1, 2)


def extract_features_valid(y: torch.Tensor, n_samples: torch.Tensor,
                           sr: int) -> torch.Tensor:
    """K zero-padded fp32 rows y [K, S] and their valid sample counts
    n_samples [K] (an int tensor on y's device) → [K, T60, 256] features,
    T60 = num_frames_120(S) // 2, in one batched pass. Row k's first
    num_frames_60(n_samples[k]) rows equal extract_features of its first
    n_samples[k] samples; the rows after them are garbage."""
    frame_length = int(0.01667 * sr)
    c = _device_constants(sr, frame_length, y.device)
    t120 = num_frames_120(n_samples, frame_length)
    return torch.cat(
        [_mfcc_69_valid(y, frame_length, t120, c),
         _autocorr_187_valid(y, frame_length, n_samples, t120, c)], dim=-1)


#: smallest power-of-two sample bucket of extract_audio_features_bucketed
#: (~1.5 s at 88.2 kHz); buckets double above it
MIN_SAMPLE_BUCKET = 1 << 17


@torch.no_grad()
def extract_audio_features_bucketed(y, sr: int = 88200,
                                    min_bucket: int = MIN_SAMPLE_BUCKET,
                                    device=None) -> np.ndarray | None:
    """Mono waveform → features [T60, 256] numpy, or None when the clip is
    too short: extract_features_valid over the clip zero-padded to a
    power-of-two sample bucket. The streamer (inference/streaming.py)
    re-extracts its growing buffer on every push: the bucket keeps the
    shapes it presents to the card to a few, and its features are the
    masked frontend's, which the multi-session tick runs.

    Integer PCM is widened by the dtype's full scale, without the peak
    normalisation of extract_audio_features: this is a streaming surface,
    and the peak is not known yet."""
    device = resolve_device(device)
    y = np.asarray(y).reshape(-1)
    if y.dtype == np.int16:
        y = y.astype(np.float32) / 32768.0
    elif np.issubdtype(y.dtype, np.integer):
        y = widen_int_pcm(y)
    y = y.astype(np.float32, copy=False)
    n = y.shape[0]
    if too_short(n, sr):
        return None
    frame_length = int(0.01667 * sr)
    # + the autocorrelation's reflected-tail room
    bucket = pow2_bucket(n + frame_length // 2 + 1, min_bucket)
    y_pad = np.zeros((1, bucket), np.float32)
    y_pad[0, :n] = y
    feats = extract_features_valid(
        torch.from_numpy(y_pad).to(device),
        torch.tensor([n], device=device), sr)
    return feats[0, : num_frames_60(n, frame_length)].cpu().numpy()


def widen_and_normalize(y: torch.Tensor) -> torch.Tensor:
    """int16 PCM tensor → fp32 by /32768 (exact), divided by its peak where
    the peak is non-zero: bitwise the host loader's result."""
    y = y.float() * (1.0 / 32768.0)
    peak = y.abs().max()
    return torch.where(peak > 0, y / torch.where(peak > 0, peak, 1.0), y)


def pow2_bucket(n: int, minimum: int = 1) -> int:
    """Smallest power of two ≥ n (and ≥ minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def num_frames_120(n_samples, frame_length: int):
    """120 fps frame count of the centre-padded half-overlap framing;
    n_samples is an int or an int tensor (then so is the count)."""
    hop = frame_length // 2
    if frame_length % 2 == 0:
        return (n_samples + 2 * (frame_length // 2)) // hop - 1
    return 1 + (n_samples + 2 * (frame_length // 2) - frame_length) // hop


def num_frames_60(n_samples, frame_length: int):
    """60 fps feature-row count after the pair-reduce (odd tail kept); an
    int or an int tensor, as n_samples."""
    t120 = num_frames_120(n_samples, frame_length)
    return t120 // 2 + t120 % 2


def widen_int_pcm(y: np.ndarray) -> np.ndarray:
    """Integer PCM other than int16 → float32 in [-1, 1) by the dtype's full
    scale; unsigned PCM is offset-binary and is re-centred first."""
    info = np.iinfo(y.dtype)
    if info.min == 0:
        mid = (info.max + 1) / 2.0
        return ((y.astype(np.float64) - mid) / mid).astype(np.float32)
    return (y.astype(np.float64) / float(info.max + 1)).astype(np.float32)


def too_short(n_samples: int, sr: int) -> bool:
    """Fewer than MIN_FRAMES intermediate frames: no features."""
    frame_length = int(0.01667 * sr)
    return (n_samples - frame_length) // (frame_length // 2) + 1 < F.MIN_FRAMES


@torch.no_grad()
def extract_audio_features(y, sr: int = 88200, device=None):
    """Mono waveform → (features [T60, 256] numpy, waveform numpy), or
    (None, None) when the clip is too short.

    A float input is used as-is (callers peak-normalise). int16 uploads raw
    and is widened and peak-normalised on the device; the returned waveform
    is the same normalisation done on the host. Other integer PCM is widened
    by its full scale and peak-normalised on the host.
    """
    device = resolve_device(device)
    y = np.asarray(y).reshape(-1)
    if too_short(y.shape[0], sr):
        return None, None
    if np.issubdtype(y.dtype, np.integer) and y.dtype != np.int16:
        y = widen_int_pcm(y)
        peak = np.max(np.abs(y)) if y.size else 0.0
        if peak > 0:
            y = y / peak
    if y.dtype == np.int16:
        feats = extract_features(
            widen_and_normalize(torch.from_numpy(y.copy()).to(device)), sr)
        y_f = y.astype(np.float32) / 32768.0
        peak = np.max(np.abs(y_f)) if y_f.size else 0.0
        if peak > 0:
            y_f = y_f / peak
        return feats.cpu().numpy(), y_f
    y = np.asarray(y, np.float32)
    feats = extract_features(torch.from_numpy(y.copy()).to(device), sr)
    return feats.cpu().numpy(), y

"""Feature extraction, per-folder feature collection, length matching and
speed augmentation (port of neurosync_trainer_lite_tpu/data/processing.py).

Semantics match the reference (reference: dataset/data_processing.py):
- audio features cached to / loaded from 'audio_features.csv' (:112-120),
  in pandas' layout (header 0..255, no index column), read and written with
  numpy, so no pandas is needed, and a cache written by either
  package loads into both as the same float32 values
- facial CSV loaded with Timecode/BlendshapeCount dropped by header name (:8,
  :123)
- center-trim so audio/facial lengths match (:126-145)
- blendshape values scaled ×100 before training (:68)
- augmentation: 'fast' = every-2nd-frame (:151-158); 'slow' = 2N-1 midpoint
  interpolation + pairwise smoothing (:84-106, :161-167)
- versions concatenated with a blend_frames-long linear cross-fade
  (stack_with_blend, :179-197)

The features always come from the device frontend (ops/frontend.py): there
is no host fallback that would hide a device failure.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from neurosync_trainer_lite_tpu_torch.data.ingest import find_files, get_audio
from neurosync_trainer_lite_tpu_torch.ops import frontend
from neurosync_trainer_lite_tpu_torch.utils.audio_io import (
    load_and_preprocess_audio,
    load_audio_from_bytes,
)

COLUMNS_TO_DROP = ["Timecode", "BlendshapeCount"]

# blendshapes train in x100 space and serve in LiveLink [0, 1] space
BLENDSHAPE_SCALE = 100.0

# dims that are pure noise in Lite capture (blinks/neck), for the optional
# zeroing helpers (reference: data_processing.py:208-219)
SPECIFIED_COLUMNS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13,
                     51, 52, 53, 54, 55, 56, 57, 58, 59, 60)


def extract_audio_features(audio_input, sr: int = 88200,
                           from_bytes: bool = False, device=None):
    """Audio path, bytes or a decoded mono waveform → (features [T, 256],
    waveform), or (None, None) for a clip shorter than the frontend minimum.

    Integer PCM other than int16 is widened by its full scale and
    peak-normalised; int16 is widened and normalised on the device.
    """
    if isinstance(audio_input, np.ndarray):
        y = audio_input.reshape(-1)
        if np.issubdtype(y.dtype, np.integer):
            if y.dtype != np.int16:
                y = frontend.widen_int_pcm(y)
                peak = np.max(np.abs(y)) if y.size else 0.0
                if peak > 0:
                    y = y / peak
        else:
            y = np.asarray(y, np.float32)
    elif from_bytes:
        y, sr = load_audio_from_bytes(audio_input, sr)
    else:
        y, sr = load_and_preprocess_audio(audio_input, sr)
    return frontend.extract_audio_features(y, sr, device=device)


def read_feature_cache(path: str) -> np.ndarray:
    """audio_features.csv → float64 [T, dim] (the header row is skipped)."""
    return np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64,
                      ndmin=2)


def write_feature_cache(path: str, features) -> None:
    """[T, dim] float32 features → audio_features.csv as pandas' to_csv
    writes it: header 0..dim-1, no index, each value in its shortest float32
    repr, so either package's cache holds the same text."""
    features = np.asarray(features, np.float32)
    with open(path, "w") as f:
        f.write(",".join(str(i) for i in range(features.shape[1])) + "\n")
        for row in features:
            f.write(",".join(map(str, row)) + "\n")


def read_facial_csv(path: str) -> np.ndarray:
    """LiveLink CSV → float64 [T, columns], Timecode and BlendshapeCount
    dropped by header name."""
    with open(path, newline="") as f:
        header = next(csv.reader(f))
    keep = [i for i, name in enumerate(header) if name not in COLUMNS_TO_DROP]
    return np.loadtxt(path, delimiter=",", skiprows=1, usecols=keep,
                      dtype=np.float64, ndmin=2)


def smooth_facial_data(facial_data: np.ndarray) -> np.ndarray:
    """Pairwise smoothing (reference: data_processing.py:201-204)."""
    smoothed = np.copy(facial_data)
    smoothed[1:] = (facial_data[:-1] + facial_data[1:]) / 2
    return smoothed


def interpolate_slower(data: np.ndarray) -> np.ndarray:
    """(N, F) → (2N-1, F) with midpoints inserted (reference:
    data_processing.py:84-106)."""
    n = data.shape[0]
    out = np.empty((2 * n - 1, data.shape[1]), dtype=data.dtype)
    out[0::2] = data
    out[1::2] = (data[:-1] + data[1:]) / 2.0
    return out


def stack_with_blend(sequences: list[np.ndarray],
                     blend_frames: int) -> np.ndarray | None:
    """Concatenate versions with a linear cross-fade at each boundary
    (reference: data_processing.py:179-197): at each join the last n frames
    of the running result fade out against the first n frames of the next
    sequence (n = blend_frames capped by both lengths, ramp endpoints
    inclusive), so every join consumes n frames of total length."""
    if not sequences:
        return None
    if len(sequences) == 1:
        return sequences[0].copy()
    # each join fades against the running result, so its cap depends on the
    # length accumulated so far
    caps, running = [], sequences[0].shape[0]
    for seq in sequences[1:]:
        n = min(blend_frames, running, seq.shape[0])
        caps.append(n)
        running += seq.shape[0] - n
    # float64, as the reference's fp64 linspace ramps
    out = np.empty((running, sequences[0].shape[1]),
                   dtype=np.result_type(np.float64, *sequences))
    out[: len(sequences[0])] = sequences[0]
    pos = len(sequences[0])
    for seq, n in zip(sequences[1:], caps):
        if n > 0:
            fade_in = np.linspace(0.0, 1.0, n)[:, None]
            out[pos - n: pos] *= 1.0 - fade_in
            out[pos - n: pos] += fade_in * seq[:n]
        out[pos: pos + len(seq) - n] = seq[n:]
        pos += len(seq) - n
    return out


def scale_facial_data(facial_data: np.ndarray,
                      scale_factor: float = 1.1) -> np.ndarray:
    """Clip-scaled copy (reference: data_processing.py:28-41)."""
    return np.clip(facial_data * scale_factor, -1, 1)


def zero_specified_columns(facial_data: np.ndarray) -> np.ndarray:
    facial_data[:, list(SPECIFIED_COLUMNS)] = 0
    return facial_data


def remove_specified_dimensions(facial_data: np.ndarray) -> np.ndarray:
    return np.delete(facial_data, list(SPECIFIED_COLUMNS), axis=1)


def _center_trim(audio_features, facial_data):
    """Trim the longer stream symmetrically (reference: :126-145)."""
    len_audio, len_facial = len(audio_features), len(facial_data)
    if len_audio > len_facial:
        diff = len_audio - len_facial
        audio_features = audio_features[diff // 2: len_audio - (diff - diff // 2)]
    elif len_facial > len_audio:
        diff = len_facial - len_audio
        facial_data = facial_data[diff // 2: len_facial - (diff - diff // 2)]
    n = min(len(audio_features), len(facial_data))
    return audio_features[:n], facial_data[:n]


def collect_features(audio_path, audio_features_csv_path, facial_csv_path, sr,
                     include_fast: bool = True, include_slow: bool = False,
                     blend_boundaries: bool = True, blend_frames: int = 30,
                     device=None):
    """Load-or-extract audio features + facial CSV, match lengths, build
    augmented versions (reference: data_processing.py:108-177)."""
    if os.path.exists(audio_features_csv_path):
        print(f"feature cache hit: {audio_features_csv_path}")
        audio_features = read_feature_cache(audio_features_csv_path)
    else:
        print(f"feature cache miss — extracting: {audio_path}")
        audio_features, _ = extract_audio_features(audio_path, sr,
                                                   device=device)
        if audio_features is not None:
            write_feature_cache(audio_features_csv_path, audio_features)
            print(f"feature cache written: {audio_features_csv_path}")
    if audio_features is None:
        return None, None
    facial_data = read_facial_csv(facial_csv_path)
    audio_features, facial_data = _center_trim(audio_features, facial_data)

    audio_versions = [audio_features]
    facial_versions = [facial_data]
    if include_fast:
        audio_versions.append(audio_features[::2].copy())
        facial_versions.append(facial_data[::2].copy())
    if include_slow:
        audio_versions.append(interpolate_slower(audio_features))
        facial_versions.append(smooth_facial_data(interpolate_slower(facial_data)))

    if blend_boundaries:
        return (stack_with_blend(audio_versions, blend_frames),
                stack_with_blend(facial_versions, blend_frames))
    return np.vstack(audio_versions), np.vstack(facial_versions)


def process_folder(folder_path: str, sr: int, apply_smoothing: bool = False,
                   apply_over_scale: bool = False, ffmpeg_path: str = "ffmpeg",
                   **collect_kwargs):
    """One capture folder → (audio_features, facial_data ×100), or
    (None, None) when it holds no usable pair (reference:
    data_processing.py:44-78)."""
    files = find_files(folder_path)
    if not files.facial_csv_path:
        return None, None
    have_cache = os.path.exists(files.audio_features_csv_path)
    if not (files.video_path or files.wav_path or have_cache):
        return None, None
    audio_path = None
    if files.video_path or files.wav_path:
        audio_path = get_audio(files, folder_path, sr, ffmpeg_path)
    if not audio_path and not have_cache:
        return None, None

    audio_features, facial_data = collect_features(
        audio_path, files.audio_features_csv_path, files.facial_csv_path, sr,
        **collect_kwargs)
    if audio_features is None or facial_data is None:
        return None, None
    if apply_over_scale:
        facial_data = scale_facial_data(facial_data)
    facial_data = np.asarray(facial_data, dtype=np.float64)
    facial_data[:, :61] *= BLENDSHAPE_SCALE  # training space (reference: :68)
    if apply_smoothing:
        facial_data = smooth_facial_data(facial_data)
    return audio_features, facial_data


def load_data(root_dir: str, sr: int, processed_folders: set | None = None,
              **kwargs) -> list[tuple[np.ndarray, np.ndarray]]:
    """Walk capture folders in name order → [(audio_features, facial_data)]
    (reference: data_processing.py:10-26)."""
    if processed_folders is None:
        processed_folders = set()
    examples = []
    for folder in sorted(os.listdir(root_dir)):
        folder_path = os.path.join(root_dir, folder)
        if os.path.isdir(folder_path) and folder not in processed_folders:
            audio_features, facial_data = process_folder(folder_path, sr,
                                                         **kwargs)
            if audio_features is not None and facial_data is not None:
                examples.append((audio_features, facial_data))
                processed_folders.add(folder)
    return examples

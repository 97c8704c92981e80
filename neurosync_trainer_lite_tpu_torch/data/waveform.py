"""Waveform windows for the waveform architecture (models/wav2vec2.py): the
capture audio kept as samples at cfg.sr beside the 60 fps targets, and
windows cut in samples.

Loading (load_waveform_data): the capture folders of data/ingest.py, in
name order; each folder's audio (extracted from its video by ffmpeg at
sr, or its wav) is decoded and resampled to sr (utils/audio_io.load_audio,
no normalisation: the model normalises each window), its LiveLink CSV read
as for the Seq2Seq (Timecode and BlendshapeCount dropped, blendshapes
×100), and the longer stream centre-trimmed to the shorter. No MFCC
features are made and no speed augmentation is applied: a speed change of
raw audio is a resampling the reference recipe does not define.

Windows (WaveformDataset): the frame table of data/windowing.py (every
window of `window` frames at stride 1, the last once more where the clip's
frames are not a multiple of it) over n = min(target frames, floor(samples
· frame_rate / sr)) frames a clip. Frame window [s, s + window) takes the
samples [floor(s · sr / frame_rate), + floor(window · sr / frame_rate)),
all inside the clip for every s ≤ n − window. The split, the batch order,
the rows of a rank and the pinned gather in the prefetch thread are
data/windowing.py's.
"""

from __future__ import annotations

import os

import numpy as np

from neurosync_trainer_lite_tpu_torch.data.ingest import find_files, get_audio
from neurosync_trainer_lite_tpu_torch.data.processing import (
    BLENDSHAPE_SCALE,
    read_facial_csv,
)
from neurosync_trainer_lite_tpu_torch.data.windowing import WindowedDataset
from neurosync_trainer_lite_tpu_torch.utils.audio_io import load_audio


class WaveformDataset(WindowedDataset):
    """Windows over (waveform [S], facial [T, dim]) clip pairs; a batch is
    (src [B, samples] float32, trg [B, window, dim] float32)."""

    def __init__(self, clips, window: int, sr: int, frame_rate: int):
        self.window, self.sr, self.frame_rate = window, sr, frame_rate
        self.samples = window * sr // frame_rate
        self.audio, self.facial, table = [], [], []
        for ci, (y, f) in enumerate(clips):
            y = np.ascontiguousarray(np.reshape(y, -1), dtype=np.float32)
            f = np.ascontiguousarray(f, dtype=np.float32)
            n = min(len(f), len(y) * frame_rate // sr)
            self.audio.append(y)
            self.facial.append(f[:n])
            if n < window:
                print(f"skipping clip {ci}: {n} frames < window {window}")
                continue
            starts = list(range(0, n - window + 1))
            if n % window != 0:
                starts.append(n - window)  # the duplicated tail window
            table.extend((ci, s) for s in starts)
        self.table = np.asarray(table, dtype=np.int64).reshape(-1, 2)

    def sample_start(self, frame: int) -> int:
        """The first sample of the window that starts at `frame`."""
        return frame * self.sr // self.frame_rate

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        ci, s = self.table[idx]
        a = self.sample_start(s)
        return (self.audio[ci][a: a + self.samples],
                self.facial[ci][s: s + self.window])

    @property
    def dims(self) -> tuple[int, int]:
        """(1, facial_dim): one sample a step of the waveform."""
        return (1, self.facial[0].shape[1]) if self.facial else (0, 0)

    def batch_shapes(self, n: int) -> tuple[tuple, tuple]:
        return (n, self.samples), (n, self.window, self.dims[1])

    def gather(self, idxs: np.ndarray, out=None) -> tuple[np.ndarray,
                                                         np.ndarray]:
        """Batch gather → (src [B, samples], trg [B, window, dim]) float32,
        into `out` (a pair of such arrays) if given."""
        rows = self.table[np.asarray(idxs)]
        if out is None:
            src_shape, trg_shape = self.batch_shapes(len(rows))
            out = (np.empty(src_shape, np.float32),
                   np.empty(trg_shape, np.float32))
        for j, (ci, s) in enumerate(rows):
            a = self.sample_start(s)
            out[0][j] = self.audio[ci][a: a + self.samples]
            out[1][j] = self.facial[ci][s: s + self.window]
        return out


def _center_trim(y: np.ndarray, facial: np.ndarray, sr: int,
                 frame_rate: int) -> tuple[np.ndarray, np.ndarray]:
    """Trim the longer stream symmetrically to the shorter, as the feature
    path's _center_trim does in frames: the audio to the fewest samples
    that cover the facial frames, or the facial frames to those the audio
    covers."""
    covered = len(y) * frame_rate // sr
    if len(facial) > covered:
        diff = len(facial) - covered
        facial = facial[diff // 2: diff // 2 + covered]
    else:
        keep = -(-len(facial) * sr // frame_rate)
        diff = len(y) - keep
        y = y[diff // 2: diff // 2 + keep]
    return y, facial


def process_folder_waveform(folder_path: str, sr: int, frame_rate: int,
                            ffmpeg_path: str = "ffmpeg"):
    """One capture folder → (waveform [S] float32 at sr, facial_data ×100),
    or (None, None) when it holds no audio and facial CSV pair."""
    files = find_files(folder_path)
    if not files.facial_csv_path or not (files.video_path or files.wav_path):
        return None, None
    audio_path = get_audio(files, folder_path, sr, ffmpeg_path)
    if not audio_path:
        return None, None
    y, _ = load_audio(audio_path, sr, ffmpeg_path)
    facial = read_facial_csv(files.facial_csv_path)
    y, facial = _center_trim(np.asarray(y, np.float32), facial, sr,
                             frame_rate)
    facial = np.asarray(facial, dtype=np.float64)
    facial[:, :61] *= BLENDSHAPE_SCALE
    return y, facial


def load_waveform_data(root_dir: str, sr: int, frame_rate: int,
                       ffmpeg_path: str = "ffmpeg"
                       ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Capture folders in name order → [(waveform, facial_data)]."""
    clips = []
    for folder in sorted(os.listdir(root_dir)):
        path = os.path.join(root_dir, folder)
        if os.path.isdir(path):
            y, facial = process_folder_waveform(path, sr, frame_rate,
                                                ffmpeg_path)
            if y is not None and facial is not None:
                clips.append((y, facial))
    return clips


def waveform_windows(cfg, clips=None, device=None) -> WaveformDataset:
    """The waveform architecture's dataset (models/architectures.py): the
    given clips, or cfg.root_dir's captures decoded at cfg.sr."""
    if clips is None:
        clips = load_waveform_data(cfg.root_dir, cfg.sr, cfg.frame_rate,
                                   ffmpeg_path=cfg.ffmpeg_path)
    return WaveformDataset(clips, cfg.micro_batch_size, cfg.sr,
                           cfg.frame_rate)

"""Capture-folder discovery and media extraction (the port's own copy of
neurosync_trainer_lite_tpu/data/ingest.py).

Mirrors the reference's folder conventions (reference:
utils/video/mov_extraction.py): each capture folder may contain a .mov/.mp4
video, a .wav, an iPhone LiveLink facial CSV (filename containing
'iPhone_cal'), and a cached 'audio_features.csv'. Audio is extracted from
video by an ffmpeg subprocess at the configured sample rate (host-side; not
performance-critical).
"""

from __future__ import annotations

import os
import subprocess
from dataclasses import dataclass


@dataclass
class FolderFiles:
    mov_path: str | None
    mp4_path: str | None
    wav_path: str | None
    facial_csv_path: str | None
    audio_features_csv_path: str      # expected path, may not exist
    other_csv_path: str | None

    @property
    def video_path(self) -> str | None:
        return self.mov_path or self.mp4_path


def find_files(folder_path: str) -> FolderFiles:
    """Discover capture files by extension (reference: mov_extraction.py:8-29)."""
    ff = FolderFiles(None, None, None, None,
                     os.path.join(folder_path, "audio_features.csv"), None)
    for file in os.listdir(folder_path):
        path = os.path.join(folder_path, file)
        if file.endswith(".mov"):
            ff.mov_path = path
        elif file.endswith(".mp4"):
            ff.mp4_path = path
        elif file.endswith(".wav"):
            ff.wav_path = path
        elif file.endswith(".csv") and file != "audio_features.csv":
            if "iPhone_cal" in file:
                ff.facial_csv_path = path
            else:
                ff.other_csv_path = path
    return ff


def extract_audio(video_path: str, output_dir: str, sr: int,
                  ffmpeg_path: str = "ffmpeg") -> str | None:
    """Video → mono WAV at sr via ffmpeg; reuses an existing audio.wav
    (reference: mov_extraction.py:39-62)."""
    audio_path = os.path.join(output_dir, "audio.wav")
    if os.path.exists(audio_path):
        return audio_path
    try:
        subprocess.run(
            [ffmpeg_path, "-i", video_path, "-ac", "1", "-ar", str(sr),
             "-y", audio_path],
            check=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        return audio_path
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        stderr = getattr(e, "stderr", b"") or b""
        print(f"Failed to extract audio from {video_path}: "
              f"{stderr.decode('utf-8', 'replace') or e}")
        return None


def get_audio(files: FolderFiles, folder_path: str, sr: int,
              ffmpeg_path: str = "ffmpeg") -> str | None:
    """Prefer video-extracted audio, else the raw wav
    (reference: mov_extraction.py:31-37)."""
    if files.video_path:
        return extract_audio(files.video_path, folder_path, sr, ffmpeg_path)
    return files.wav_path

"""Audio decoding and encoding without librosa (the port's own copy).

The WAV, float-WAV and ffmpeg decoders, resampling, the path and bytes
loaders, the WAV writers and playback of
neurosync_trainer_lite_tpu/utils/audio_io.py:

- PCM WAV (8/16/24/32-bit int) decoded with the stdlib ``wave`` module and
  numpy, IEEE-float WAV (32/64-bit) by a RIFF chunk walk.
- Other containers decoded by piping through ffmpeg.
- Resampling by polyphase filtering (scipy.signal.resample_poly).
- Peak normalisation to [-1, 1] for the bytes loader.
- Playback through pygame where it is installed, for the NeuroSync Player's
  surface: a host-side convenience, so without pygame (or on any playback
  error) it prints one line and returns.
"""

from __future__ import annotations

import io
import subprocess
import wave
from fractions import Fraction

import numpy as np


def _decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """bytes of a RIFF/WAV file → (float32 mono array, sample_rate)."""
    with wave.open(io.BytesIO(data)) as w:
        n_ch, sampwidth, sr = w.getnchannels(), w.getsampwidth(), w.getframerate()
        raw = w.readframes(w.getnframes())

    if sampwidth == 2:
        y = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        y = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        y = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        y = vals.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width: {sampwidth}")

    if n_ch > 1:
        y = y.reshape(-1, n_ch).mean(axis=1)
    return y, sr


def _decode_float_wav(data: bytes) -> tuple[np.ndarray, int]:
    """IEEE-float WAV (format tag 3) → (float32 mono, sample_rate).

    The stdlib ``wave`` module raises ``unknown format: 3`` on float WAVs,
    so this minimal RIFF chunk walk keeps the module's advertised
    32/64-bit-float support true without requiring ffmpeg."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos, fmt = 12, None
    while pos + 8 <= len(data):
        cid = data[pos: pos + 4]
        size = int.from_bytes(data[pos + 4: pos + 8], "little")
        body = data[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data" and fmt is not None and len(fmt) >= 16:
            tag = int.from_bytes(fmt[0:2], "little")
            n_ch = max(1, int.from_bytes(fmt[2:4], "little"))
            rate = int.from_bytes(fmt[4:8], "little")
            bits = int.from_bytes(fmt[14:16], "little")
            if tag != 3 or bits not in (32, 64):
                raise ValueError(f"not an IEEE-float WAV (tag {tag}, {bits}-bit)")
            if rate <= 0:
                # A zero/negative fmt-chunk rate would otherwise surface as a
                # ZeroDivisionError from Fraction() inside resample(), which
                # load_audio doesn't catch — raise ValueError so the caller
                # falls through to the ffmpeg decoder instead.
                raise ValueError(f"invalid WAV sample rate: {rate}")
            dt = np.dtype("<f4") if bits == 32 else np.dtype("<f8")
            usable = len(body) // (dt.itemsize * n_ch) * (dt.itemsize * n_ch)
            y = np.frombuffer(body[:usable], dtype=dt).astype(np.float32)
            if n_ch > 1:
                y = y.reshape(-1, n_ch).mean(axis=1)
            return y, rate
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    raise ValueError("no fmt/data chunks found")


def _decode_via_ffmpeg(data: bytes, sr: int, ffmpeg_path: str = "ffmpeg"
                       ) -> tuple[np.ndarray, int]:
    """Arbitrary container → mono float32 at sr via an ffmpeg pipe."""
    proc = subprocess.run(
        [ffmpeg_path, "-i", "pipe:0", "-f", "f32le", "-ac", "1",
         "-ar", str(sr), "pipe:1"],
        input=data, stdout=subprocess.PIPE, stderr=subprocess.PIPE, check=True,
    )
    return np.frombuffer(proc.stdout, dtype=np.float32).copy(), sr


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling with a Kaiser-windowed sinc filter."""
    if orig_sr == target_sr:
        return y
    from scipy.signal import resample_poly

    frac = Fraction(target_sr, orig_sr)
    return resample_poly(y, frac.numerator, frac.denominator).astype(np.float32)


def load_audio(source, sr: int = 88200, ffmpeg_path: str = "ffmpeg"
               ) -> tuple[np.ndarray, int]:
    """Load a path or bytes → (float32 mono at sr, sr). No normalization."""
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
    else:
        with open(source, "rb") as f:
            data = f.read()
    try:
        y, native_sr = _decode_wav(data)
    except (wave.Error, EOFError):
        try:  # stdlib wave rejects IEEE-float WAVs (format 3)
            y, native_sr = _decode_float_wav(data)
        except ValueError:
            return _decode_via_ffmpeg(data, sr, ffmpeg_path)
    return resample(y, native_sr, sr), sr


def load_and_preprocess_audio(audio_path, sr: int = 88200
                              ) -> tuple[np.ndarray, int]:
    """Path → peak-normalized mono float32 at sr (reference: load_audio.py:6-16)."""
    return _peak_normalized(*load_audio(audio_path, sr))


def _peak_normalized(y: np.ndarray, sr: int) -> tuple[np.ndarray, int]:
    max_val = np.max(np.abs(y)) if y.size else 0.0
    if max_val > 0:
        y = y / max_val
    return y, sr


def load_audio_from_bytes(audio_bytes: bytes, sr: int = 88200
                          ) -> tuple[np.ndarray, int]:
    """Bytes → peak-normalized mono float32 at sr (reference: load_audio.py:23-32)."""
    return _peak_normalized(*load_audio(audio_bytes, sr))


def load_audio_file_from_memory(audio_bytes: bytes, sr: int = 88200
                                ) -> tuple[np.ndarray, int]:
    """The reference's name for the bytes loader (load_audio.py:34-43):
    decode, peak-normalise, report the rate."""
    y, sr = load_audio_from_bytes(audio_bytes, sr)
    print(f"Loaded audio data with sample rate {sr}")
    return y, sr


def _write_wav(target, y: np.ndarray, sr: int) -> None:
    pcm = np.clip(np.asarray(y, np.float64) * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(target, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def save_audio_file(y: np.ndarray, sr: int, output_path: str) -> None:
    """float waveform → 16-bit PCM WAV file (reference: save_audio.py:7-20)."""
    _write_wav(output_path, y, sr)


def audio_to_bytes(y: np.ndarray, sr: int) -> bytes:
    """float waveform → in-memory WAV bytes (reference: save_audio.py:23-34)."""
    buf = io.BytesIO()
    _write_wav(buf, y, sr)
    return buf.getvalue()


def _play(source, start_event, label: str) -> None:
    """Playback core (reference: play_audio.py:6-52): init the mixer, load,
    wait for the Player's start event, block until done; a WAV pygame
    cannot read is skipped, as the reference skips it."""
    try:
        import pygame
    except ImportError:
        print(f"{label}: pygame not installed; skipping playback")
        return
    try:
        pygame.mixer.init()
        pygame.mixer.music.load(source)
        if start_event is not None:
            start_event.wait()
        pygame.mixer.music.play()
        while pygame.mixer.music.get_busy():
            pygame.time.Clock().tick(10)
    except pygame.error as e:
        if "Unknown WAVE format" in str(e):
            print("Unknown WAVE format encountered. "
                  "Skipping to the next item in the queue.")
        else:
            print(f"Error in {label}: {e}")
    except Exception as e:  # noqa: BLE001 — playback must never kill a session
        print(f"Error in {label}: {e}")


def play_audio_bytes(audio_bytes: bytes, start_event=None) -> None:
    """Play in-memory encoded audio (reference: play_audio.py:6-25)."""
    _play(io.BytesIO(audio_bytes), start_event, "play_audio_bytes")


def play_audio_from_memory(audio_data: bytes, start_event=None) -> None:
    """The reference's second name for it (play_audio.py:27-44)."""
    _play(io.BytesIO(audio_data), start_event, "play_audio_from_memory")


def play_audio_from_path(audio_path: str, start_event=None) -> None:
    """Play an audio file from disk (reference: play_audio.py:46-52)."""
    _play(audio_path, start_event, "play_audio_from_path")

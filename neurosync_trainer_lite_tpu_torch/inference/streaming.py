"""Live streaming inference: incremental audio → incremental blendshapes.

Port of neurosync_trainer_lite_tpu/inference/streaming.py. Audio samples go
in as they arrive, and blendshape frames come out once they are final, with
the offline path's chunk and overlap-blend math (inference/chunked.py):

- feature rows accumulate; every frame_size - overlap new rows a
  frame_size-row window is decoded;
- the first `overlap` frames of a new window cross-fade into the previous
  window's tail, so a window's last `overlap` frames stay provisional until
  the next window (or flush()) finalises them;
- flush() decodes what remains (reflect-padded) and finalises it.

Latency: one window stride, (128 - 16) frames ≈ 1.87 s of audio at the
defaults.

The MFCC half of the features normalises with clip-global statistics
(CMVN), so a feature row is reproducible only given the whole clip. The
streamer re-extracts its buffered audio on every push and decodes each
window with the freshest statistics; finalised frames are never revised.
Audio consumed beyond a context margin is dropped (TRIM_THRESHOLD_FRAMES,
TRIM_MARGIN_FRAMES), so a session runs in bounded memory and bounded work
a push. Streamed and offline frames therefore agree to the CMVN drift, not
bit for bit, and the tail frames are blended where the offline path
concatenates them.

FrameAssembler holds the feature → frame half (the consumption cursor, the
provisional tail, window planning, the blend). Its drain has two phases:
plan() lists the windows a drain will decode, apply() blends their decoded
frames, so that decodes batch across catch-up windows and, in
inference/multi_stream.py, across sessions.

Not ported: FEATURE_QUANT_FRAMES, which quantised a custom extractor's
input length to bound XLA recompiles; eager PyTorch compiles nothing.
"""

from __future__ import annotations

import numpy as np

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.data.processing import BLENDSHAPE_SCALE
from neurosync_trainer_lite_tpu_torch.inference.chunked import (
    blend_chunks,
    decode_chunks_batched,
    pad_audio_chunk,
)
from neurosync_trainer_lite_tpu_torch.ops.frontend import (
    MIN_SAMPLE_BUCKET,
    extract_audio_features_bucketed,
    widen_int_pcm,
)
from neurosync_trainer_lite_tpu_torch.utils.device import check_model_device


class FrameAssembler:
    """Features in → finalised blendshape frames out, with overlap-blend
    continuity.

    Indices live in the owner's current buffer space: feature row i is the
    i-th 60 fps frame of the (possibly trimmed) audio buffer. shift(m)
    renumbers after the owner drops m frames of audio from the front.
    """

    def __init__(self, cfg: Config, *, smooth: bool = False):
        self.cfg = cfg
        self._features = np.zeros((0, cfg.input_dim), np.float32)
        self._base = 0                  # buffer-space row of _features[0]
        self._pending: np.ndarray | None = None  # provisional tail frames
        self._emitted: list[np.ndarray] = []
        self._consumed = 0              # buffer-space rows already decoded
        #: the reference API's pair-average smoothing, s[i] = (x[i] +
        #: x[i+1]) / 2 with the last frame as it is, streamed with one
        #: frame of lookahead so that the live output equals
        #: smooth_by_averaging_pairs over the whole stream
        self._smooth = smooth
        self._smooth_hold: np.ndarray | None = None

    # -- feeding ------------------------------------------------------------

    @property
    def consumed(self) -> int:
        return self._consumed

    @property
    def n_features(self) -> int:
        """Highest feature row (buffer space) currently ingested."""
        return self._base + len(self._features)

    def ingest(self, feats: np.ndarray, base: int = 0) -> None:
        """Replace the feature window: rows [base, base+len) of buffer space.

        Skipped when it brings nothing new beyond the consumption point
        (CMVN makes earlier rows drift slightly as audio accrues; finalised
        frames are never revised, so stale earlier rows are harmless)."""
        if base + len(feats) > self._consumed:
            self._features = np.asarray(feats, np.float32)
            self._base = base

    def shift(self, m: int) -> None:
        """The owner dropped m frames of audio from the buffer front."""
        self._consumed -= m
        self._base -= m

    # -- two-phase drain ----------------------------------------------------

    def plan(self, *, final: bool) -> list[tuple[int, int, int, bool]]:
        """The windows the next drain will decode, (start, take, hold,
        is_final_tail) each, without decoding or changing state. `hold` is
        the provisional tail the next window will cross-fade into."""
        cfg = self.cfg
        frame_len, overlap = cfg.frame_size, cfg.overlap
        plans = []
        consumed = self._consumed
        pend = 0 if self._pending is None else len(self._pending)
        n_feat = self.n_features
        while True:
            avail = n_feat - consumed
            if avail <= 0:
                break
            if avail < frame_len and not final:
                break
            take = min(frame_len, avail)
            if pend == 0:
                merged_len = take
            else:
                merged_len = pend + take - min(overlap, pend, take)
            if final and take >= avail:
                plans.append((consumed, take, 0, True))
                break
            hold = min(overlap, merged_len)
            plans.append((consumed, take, hold, False))
            consumed += take - hold
            pend = hold
        return plans

    def plan_next(self, n_feat_total: int, *,
                  final: bool) -> tuple[int, int, int, bool] | None:
        """The single next window (start, take, hold, is_final_tail) given a
        total feature-row count that need not be ingested: the fused tick
        (inference/multi_stream.py) gathers its windows on the device, so
        the assembler holds no features there. plan()'s first iteration."""
        cfg = self.cfg
        frame_len, overlap = cfg.frame_size, cfg.overlap
        avail = n_feat_total - self._consumed
        if avail <= 0 or (avail < frame_len and not final):
            return None
        take = min(frame_len, avail)
        pend = 0 if self._pending is None else len(self._pending)
        merged_len = (take if pend == 0
                      else pend + take - min(overlap, pend, take))
        if final and take >= avail:
            return (self._consumed, take, 0, True)
        return (self._consumed, take, min(overlap, merged_len), False)

    def windows(self, plans) -> np.ndarray:
        """[N, frame_size, input_dim] reflect-padded decode inputs."""
        cfg = self.cfg
        return np.stack([
            pad_audio_chunk(
                self._features[s - self._base: s - self._base + take],
                cfg.frame_size, cfg.input_dim)
            for (s, take, _, _) in plans
        ])

    def apply(self, plans, decoded: np.ndarray) -> None:
        """Blend and finalise the decoded windows (the offline path's serial
        accumulation)."""
        overlap = self.cfg.overlap
        for (start, take, hold, is_tail), dec in zip(plans, decoded):
            dec = dec[:take]
            if self._pending is None:
                merged = dec
            else:
                merged = blend_chunks(self._pending, dec, overlap)
            if is_tail:
                self._finalize(merged)
                self._pending = None
                self._consumed = start + take
            else:
                self._finalize(merged[: len(merged) - hold])
                self._pending = merged[len(merged) - hold:]
                self._consumed = start + take - hold

    # -- reading ------------------------------------------------------------

    @property
    def frames_ready(self) -> int:
        return sum(len(e) for e in self._emitted)

    def pop_frames(self) -> np.ndarray:
        """All finalised frames since the last pop: [n, output_dim]."""
        if not self._emitted:
            return np.zeros((0, self.cfg.output_dim), np.float64)
        out = np.concatenate(self._emitted, axis=0)
        self._emitted = []
        return out

    def finish(self) -> None:
        """End of stream: release the smoothing lookahead frame (the last
        frame goes out as it is, as in smooth_by_averaging_pairs)."""
        if self._smooth_hold is not None:
            self._emitted.append(self._smooth_hold)
            self._smooth_hold = None

    def _finalize(self, frames: np.ndarray) -> None:
        if len(frames) == 0:
            return
        out = np.array(frames, np.float64)
        out[:, :61] /= BLENDSHAPE_SCALE  # LiveLink space
        if self._smooth:
            block = (out if self._smooth_hold is None
                     else np.vstack([self._smooth_hold, out]))
            self._emitted.append((block[:-1] + block[1:]) / 2.0)
            self._smooth_hold = block[-1:]
            return
        self._emitted.append(out)


class BlendshapeStreamer:
    """Incremental wav → blendshape decoder with overlap-blend continuity,
    on the device that holds the model's weights (the CUDA card unless the
    caller passes device="cpu")."""

    #: drop consumed audio once this many finalised frames accumulate
    TRIM_THRESHOLD_FRAMES = 512
    #: frames of context kept behind the consumption point when trimming
    TRIM_MARGIN_FRAMES = 64
    #: most windows a decode call takes: a long catch-up push drains in
    #: bounded groups, not as one batch through the model
    DECODE_GROUP = 4

    def __init__(self, model, cfg: Config, *, extract_features=None,
                 smooth: bool = False, device=None):
        self.model = model
        self.cfg = cfg
        self._device = check_model_device(model, device)
        self._default_extract = extract_features is None
        self._extract = extract_features or (
            lambda y: extract_audio_features_bucketed(
                y, cfg.sr, device=self._device))
        self._audio = np.zeros((0,), np.float32)      # buffered samples
        self._asm = FrameAssembler(cfg, smooth=smooth)
        # one 60 fps output frame spans exactly frame_length samples when
        # the frontend's two 120 fps hops tile it (frame_length even, the
        # default sr=88200 → 1470); trimming relies on that alignment
        self._frame_samples = int(0.01667 * cfg.sr)
        self._can_trim = (self._default_extract
                          and self._frame_samples % 2 == 0)

    def warmup(self, max_buffer_seconds: float | None = None) -> int:
        """Run each decode group size (1, 2, 4) and each frontend sample
        bucket a trimmed session can reach once, on noise, so that the
        first live pushes pay no cuBLAS or allocator first use. Returns the
        number of frontend buckets run (1 for a custom extractor, run once
        at the cap).

        max_buffer_seconds: the longest buffer to run; by default the trim
        bound (threshold + margin + two windows of slack)."""
        cfg = self.cfg
        if max_buffer_seconds is None:
            bound_frames = (self.TRIM_THRESHOLD_FRAMES
                            + self.TRIM_MARGIN_FRAMES + 2 * cfg.frame_size)
            max_samples = bound_frames * self._frame_samples
        else:
            max_samples = int(max_buffer_seconds * cfg.sr)

        rng = np.random.default_rng(0)
        for m in (1, 2, 4):
            chunk = rng.standard_normal(
                (m, cfg.frame_size, cfg.input_dim)).astype(np.float32)
            decode_chunks_batched(self.model, chunk, cfg)

        if not self._default_extract:
            self._extract(rng.standard_normal(max_samples).astype(np.float32))
            return 1

        margin = self._frame_samples // 2 + 1  # autocorr reflected-tail room
        warmed, bucket = 0, MIN_SAMPLE_BUCKET
        while True:
            n = min(bucket - margin, max_samples)
            self._extract(rng.standard_normal(n).astype(np.float32) * 0.1)
            warmed += 1
            if n >= max_samples:
                return warmed
            bucket *= 2

    # -- feeding ------------------------------------------------------------

    def push_audio(self, samples: np.ndarray) -> int:
        """Append raw mono samples at cfg.sr; returns the frames newly
        finalised. Integer PCM is widened by its dtype's full scale, with no
        peak normalisation (a streaming surface: the peak is not known)."""
        samples = np.asarray(samples).reshape(-1)
        if samples.dtype == np.int16:
            samples = samples.astype(np.float32) / 32768.0
        elif np.issubdtype(samples.dtype, np.integer):
            samples = widen_int_pcm(samples)
        samples = samples.astype(np.float32, copy=False)
        self._audio = np.concatenate([self._audio, samples])
        self._refresh_features()
        before = self.frames_ready
        self._drain(final=False)
        self._maybe_trim()
        return self.frames_ready - before

    def _maybe_trim(self) -> None:
        """Drop audio behind the consumption point, keeping a margin of
        context frames so that re-extracted features match up to the CMVN
        drift; 60 fps frame i starts at sample i·frame_samples, so dropping
        m frames of audio shifts indices by exactly m."""
        if not self._can_trim:
            return
        excess = self._asm.consumed - self.TRIM_MARGIN_FRAMES
        if excess < self.TRIM_THRESHOLD_FRAMES:
            return
        self._audio = self._audio[excess * self._frame_samples:]
        self._asm.shift(excess)
        self._refresh_features()

    def flush(self) -> None:
        """Finalise everything buffered (end of stream)."""
        self._refresh_features()
        self._drain(final=True)
        self._asm.finish()

    # -- reading ------------------------------------------------------------

    @property
    def frames_ready(self) -> int:
        return self._asm.frames_ready

    def pop_frames(self) -> np.ndarray:
        """All finalised frames since the last pop: [n, output_dim]."""
        return self._asm.pop_frames()

    # -- internals ----------------------------------------------------------

    def _refresh_features(self) -> None:
        """Re-extract features over the (bounded) audio buffer."""
        if len(self._audio) == 0:
            return
        feats = self._extract(self._audio)
        if feats is None:
            return
        self._asm.ingest(feats)

    def _drain(self, *, final: bool) -> None:
        plans = self._asm.plan(final=final)
        for at in range(0, len(plans), self.DECODE_GROUP):
            group = plans[at: at + self.DECODE_GROUP]
            decoded = decode_chunks_batched(
                self.model, self._asm.windows(group), self.cfg)
            self._asm.apply(group, decoded)

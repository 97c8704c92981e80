"""Multi-session live serving: K concurrent audio → blendshape streams,
batched on one card each tick.

Port of neurosync_trainer_lite_tpu/inference/multi_stream.py. K sessions
driven as K independent BlendshapeStreamers would cost K frontend and K
decode launches sequences a push interval, re-upload each whole buffer on
every push, and run the model at batch 1. Here:

1. **Rings on the card.** Each session owns a row of a [K_cap, S_cap] fp32
   waveform buffer that stays on the device across ticks. A tick uploads
   only the new samples (raw int16 when every queued piece is int16); the
   ring is shifted (trim), appended and re-extracted on the device.
2. **The fused tick** (the default): ring update over the session rows →
   the masked frontend (ops/frontend.py:extract_features_valid, each row's
   statistics over its own valid length) → each ready row's reflect-padded
   window gathered at its (start, take) → one batched decode, over only
   the D rows that have a window ready. One download: the decoded
   [D, frame_size, output_dim]. Ticks on which no row is ready (most of
   them at live cadence: a window completes every ~1.9 s of audio) update
   the rings and download nothing.
3. **The two-dispatch tick**, the stall watchdog's fallback and an option
   for catch-up-heavy feeds: ring update and frontend over every row, one
   download of each row's [f_win, 256] feature window (bf16 when the model
   computes in bf16: the decode's first op rounds to bf16 anyway, so the
   decode is identical), then the windows of all sessions decode in one
   decode_chunks_batched call, several a session when a backlog allows.

Frames are BlendshapeStreamer's (the same FrameAssembler, the same blend,
the same CMVN-drift contract: inference/streaming.py).

Ported as behaviour: the session and decode buckets (rows beyond the live
count are padding; their ring writes are dropped, so only the live rows
are written back), s16 uploads, decode_bucket_cap with 'auto' and
least-recently-decoded-first fairness, the liveness floor, push_seconds
and push_formats, the stall watchdog's flip to the two-dispatch family on
the card (counted in watchdog_flips, each (session bucket, upload dtype,
decode bucket) exempt at its first use), the ring recovery from host
shadows (one retry on the card; a second failure raises), flush and
metrics_snapshot.

Not applicable, because nothing compiles in eager PyTorch: warmup's
background_fallback and serve_buckets (the progressive ramp) have nothing
to defer and are accepted and documented as such, as is
wait_background_warmup; the JAX warmup's thread pool (`parallel`) and its
compile bookkeeping (`last_eager_sigs`); the persistent compilation cache.
warmup() builds the CUDA kernels and runs each tick family once per bucket
on noise, so that the first live session pays no cuBLAS or allocator
first use.

The JAX ops become explicit here. jax.lax.dynamic_slice clamps its start,
and torch indexing does not: every traced start is clamped
(ops/frontend.py:_window, the feature window, the window gather). A
scatter with mode="drop" at a padding index K_cap becomes a copy of the
live rows alone: an out-of-range index_copy_ on the card is a device-side
assert, which poisons the context. jnp.roll by a per-row shift becomes a
gather at (arange + shift) mod S. No per-row code reads a device value on
the host: a tick's only synchronisation is its one download.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.inference.chunked import (
    decode_chunks_batched,
)
from neurosync_trainer_lite_tpu_torch.inference.streaming import FrameAssembler
from neurosync_trainer_lite_tpu_torch.ops import frontend_np as F
from neurosync_trainer_lite_tpu_torch.ops import kernels
from neurosync_trainer_lite_tpu_torch.ops.frontend import (
    extract_features_valid,
    num_frames_60,
    num_frames_120,
    pow2_bucket,
    widen_int_pcm,
)
from neurosync_trainer_lite_tpu_torch.utils.device import check_model_device


def session_bucket(n: int) -> int:
    """Next session-count bucket ≥ n on the ladder 1, 2, 4, 8, 16, 24, 32,
    48, … (powers of two, and the midpoint above 16)."""
    b = 1
    while True:
        if n <= b:
            return b
        if b >= 16 and n <= b + b // 2:
            return b + b // 2
        b *= 2


def _validate_formats(name: str, formats) -> tuple:
    """The accepted upload formats, shared by the constructor's push_formats
    and warmup's push_dtypes."""
    bad = set(formats) - {"f32", "s16"}
    if bad or not formats:
        raise ValueError(
            f"{name}={formats!r}: must be a non-empty subset "
            f"of ('f32', 's16')")
    return tuple(formats)


def _ring_update(rows, new, shift, buf_len, new_len):
    """Every tick's ring update of rows [k, S]: trim-shift each row left by
    shift[i], clear what rolled in past its valid length, widen int16 new
    samples by /32768 (a power of two: exact in fp32) and append each row's
    new [P] samples at its end. Returns (rows, total valid samples).

    The append adds the new samples at (bl + arange(P)) mod S: the samples
    past new_len are zero, and the host keeps bl + new_len ≤ S_avail, so a
    wrapped tail adds zeros to audio (or to zeros) and changes nothing."""
    S = rows.shape[1]
    ar = torch.arange(S, device=rows.device)
    rows = rows.gather(1, (ar[None, :] + shift[:, None]) % S)
    bl = buf_len - shift
    rows = torch.where(ar[None, :] < bl[:, None], rows, 0.0)
    if new.dtype == torch.int16:
        new = new.float() * (1.0 / 32768.0)
    at = (bl[:, None] + torch.arange(new.shape[1], device=rows.device)) % S
    return rows.scatter_add(1, at, new), bl + new_len


def _gather_rows(buf, idx):
    """The ring rows of idx; a padding entry (idx == K_cap) reads the last
    row, whose copy is never written back."""
    return buf[idx.clamp(max=buf.shape[0] - 1)]


def _tick_ring_only(buf, idx, new, shift, buf_len, new_len, *, n_live: int):
    """Intake-only tick: update the rings of the first n_live entries of
    idx in place; extract and decode nothing."""
    rows, _ = _ring_update(_gather_rows(buf, idx), new, shift, buf_len,
                           new_len)
    buf.index_copy_(0, idx[:n_live], rows[:n_live])


def _tick_program(buf, idx, new, shift, buf_len, new_len, feat_start, *,
                  n_live: int, sr: int, f_win: int, feat_dtype):
    """Two-dispatch tick over the gathered rows: ring update (the first
    n_live rows written back), the masked frontend over every row, and each
    row's [f_win, 256] feature window at feat_start (clamped as
    jax.lax.dynamic_slice clamps it) in feat_dtype."""
    rows, totals = _ring_update(_gather_rows(buf, idx), new, shift, buf_len,
                                new_len)
    buf.index_copy_(0, idx[:n_live], rows[:n_live])
    feats = extract_features_valid(rows, totals, sr)      # [k, T60_cap, 256]
    start = feat_start.clamp(0, feats.shape[1] - f_win)
    at = start[:, None] + torch.arange(f_win, device=feats.device)
    wins = feats.gather(1, at[..., None].expand(-1, -1, feats.shape[2]))
    return wins.to(feat_dtype)


def _tick_fused(model, buf, idx, new, shift, buf_len, new_len, dec_idx,
                win_start, win_take, *, n_live: int, sr: int,
                frame_size: int):
    """Fused tick: ring update over every gathered row (the first n_live
    written back), then frontend, window gather and decode over only the
    [D] rows dec_idx (indices into this tick's rows; a padding entry points
    at row 0 with win_take 0, and the host discards its frames). Returns
    the decoded [D, frame_size, output_dim] fp32 on the device.

    Window row j of a row with (start, take) is feature row start +
    min(m, p - m), m = j mod p, p = max(2(take - 1), 1): numpy's repeated
    reflection, which inference/chunked.py:pad_audio_chunk applies."""
    rows, totals = _ring_update(_gather_rows(buf, idx), new, shift, buf_len,
                                new_len)
    buf.index_copy_(0, idx[:n_live], rows[:n_live])
    sel = dec_idx.clamp(0, rows.shape[0] - 1)
    feats = extract_features_valid(rows[sel], totals[sel], sr)
    j = torch.arange(frame_size, device=feats.device)
    p = (2 * (win_take - 1)).clamp_min(1)[:, None]
    m = j[None, :] % p
    at = (win_start[:, None] + torch.minimum(m, p - m)).clamp(
        0, feats.shape[1] - 1)
    wins = feats.gather(1, at[..., None].expand(-1, -1, feats.shape[2]))
    return model(wins).float()


@dataclass
class _Session:
    row: int                      # ring row in the device buffer
    asm: FrameAssembler
    buf_len: int = 0              # valid samples in the ring
    pending: list = field(default_factory=list)  # host-queued new audio
    #: the _dec_seq of this session's last fused decode (-1: never): when
    #: decode_bucket_cap binds, ready rows are served least recently
    #: decoded first, so late-opened sessions are not starved
    last_dec: int = -1
    #: host mirror of the ring's content (widened floats): what
    #: _recover_rings re-uploads after a device fault
    shadow: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float32))


class MultiStreamer:
    """K concurrent BlendshapeStreamer-equivalent sessions on one card.

    Usage::

        ms = MultiStreamer(model, cfg, max_sessions=8)
        ms.warmup()
        a = ms.open(); b = ms.open()
        ms.push_audio(a, samples_a); ms.push_audio(b, samples_b)
        ms.tick()                      # one batched tick for everyone
        frames_a = ms.pop_frames(a)
        ms.flush(b); tail_b = ms.pop_frames(b); ms.close(b)

    Runs on the device of the model's weights, the CUDA card unless the
    caller passes device="cpu"; without a card and without device="cpu"
    the constructor raises.
    """

    def __init__(self, model, cfg: Config, *, max_sessions: int = 8,
                 f_win: int = 256, trim_threshold: int = 256,
                 trim_margin: int = 64, max_buffer_seconds: float | None = None,
                 fused_decode: bool = True,
                 stall_watchdog_s: float | None = 30.0,
                 decode_bucket_cap: int | None | str = "auto",
                 push_seconds: float | None = None,
                 push_formats: tuple = ("f32", "s16"), device=None):
        self.model = model
        self.cfg = cfg
        self._device = check_model_device(model, device)
        self.max_sessions = max_sessions
        self.trim_threshold = trim_threshold
        self.trim_margin = trim_margin
        #: upload formats this deployment pushes, "f32" and/or "s16" (raw
        #: int16 PCM): warmup()'s default set, and the dtype of the empty
        #: upload on ticks with no queued audio
        self.push_formats = _validate_formats("push_formats", push_formats)
        self._empty_i16 = "f32" not in self.push_formats
        #: a fused tick slower than this (seconds, wall) flips the streamer
        #: to the two-dispatch family for every later tick; None disables
        self.stall_watchdog_s = stall_watchdog_s
        #: fused ticks (the default) decode at most one window a session a
        #: tick, on the card inside the tick; False selects the two-dispatch
        #: family, which decodes several a session when a backlog allows
        self.fused = fused_decode
        #: fused signatures (session bucket, upload dtype, decode bucket;
        #: 0 for an intake-only tick) that have run once: the watchdog
        #: exempts a signature's first use (cuBLAS and allocator first use)
        self._fused_seen: set = set()
        self._dec_seq = 0  # fused-decode clock for the last_dec stamps

        self._frame_samples = int(0.01667 * cfg.sr)
        if self._frame_samples % 2:
            raise ValueError("MultiStreamer needs an even frame length "
                             "(sr=88200 default); use BlendshapeStreamer")
        if max_buffer_seconds is None:
            bound = (trim_threshold + trim_margin + 2 * cfg.frame_size
                     ) * self._frame_samples
        else:
            bound = int(max_buffer_seconds * cfg.sr)
        tail_room = self._frame_samples // 2 + 1  # autocorr reflected tail
        self._s_cap = pow2_bucket(bound + tail_room)
        self._s_avail = self._s_cap - tail_room
        # Liveness floor: a backlogged session with a full ring progresses
        # only by a full decode window (frame_size unconsumed frames) or an
        # eligible trim (threshold + margin consumed frames); a ring that
        # holds neither deadlocks
        floor_frames = trim_threshold + trim_margin + cfg.frame_size
        cap_frames = num_frames_60(self._s_avail, self._frame_samples)
        if cap_frames < floor_frames:
            need_s = (floor_frames * self._frame_samples + tail_room
                      ) / cfg.sr
            raise ValueError(
                f"max_buffer_seconds={max_buffer_seconds} gives a ring of "
                f"{cap_frames} frames < trim_threshold + trim_margin + "
                f"frame_size = {floor_frames}; a backlogged session would "
                f"deadlock. Use max_buffer_seconds >= {need_s:.2f} or "
                f"lower the trim settings.")
        #: new samples a session takes a tick (the rest wait for later
        #: ticks); the tick uploads [session bucket, push_capacity] samples
        #: whatever is queued, so this width is the tick's upload
        if push_seconds is None:
            self.push_capacity = min(1 << 17, self._s_cap // 2)
        else:
            if push_seconds <= 0:
                raise ValueError(
                    f"push_seconds={push_seconds} must be > 0 "
                    f"(or None for the default ≈1.5 s width)")
            self.push_capacity = min(
                pow2_bucket(max(1, int(push_seconds * cfg.sr))),
                self._s_cap // 2)
        #: most rows a fused tick decodes: more ready rows wait for the next
        #: tick. None: every ready row. 'auto': enough for decode to keep up
        #: with window production at a 0.5 s push cadence (a window every
        #: ~3.8 ticks a session → ≥ K/3), on the bucket ladder, at least 8
        if decode_bucket_cap == "auto":
            decode_bucket_cap = max(8, session_bucket(-(-max_sessions // 3)))
        elif isinstance(decode_bucket_cap, str):
            raise ValueError(
                f"decode_bucket_cap={decode_bucket_cap!r}: the only string "
                f"value is 'auto' (or pass an int >= 1, or None for no cap)")
        elif decode_bucket_cap is not None and (
                not isinstance(decode_bucket_cap, int)
                or isinstance(decode_bucket_cap, bool)
                or decode_bucket_cap < 1):
            raise ValueError(
                f"decode_bucket_cap={decode_bucket_cap!r} must be an int "
                f">= 1, None (no cap), or 'auto'")
        self.decode_bucket_cap = decode_bucket_cap

        # the feature rows of a ring: its 120 fps frame count pair-reduced
        # with an odd last frame dropped (ops/frontend.py:
        # _reduce_features_valid), not num_frames_60, which counts a row
        # past the array
        self._t60_cap = num_frames_120(self._s_cap, self._frame_samples) // 2
        self.f_win = min(f_win, self._t60_cap)

        self._kcap = session_bucket(max_sessions)
        self._feat_dtype = torch.bfloat16 if cfg.use_amp else torch.float32
        self._buf = self._zero_rings()
        self._free_rows = list(range(self._kcap - 1, -1, -1))
        self._sessions: dict[int, _Session] = {}
        self._next_id = 0

        #: counters and the recent tick wall times, read by
        #: metrics_snapshot (the HTTP server's GET /metrics); the lock
        #: guards them against a scrape from another thread
        self._counters = {"ticks": 0, "decode_ticks": 0, "frames_out": 0,
                          "watchdog_flips": 0, "ring_recoveries": 0}
        self._tick_times: deque[float] = deque(maxlen=512)
        self._metrics_lock = threading.Lock()

    def _zero_rings(self) -> torch.Tensor:
        with torch.inference_mode():
            return torch.zeros(self._kcap, self._s_cap, device=self._device)

    # -- session lifecycle ---------------------------------------------------

    def open(self, *, smooth: bool = False) -> int:
        """Allocate a session; returns its id. smooth=True applies the
        reference API's pair-average smoothing to the live stream."""
        if not self._free_rows or len(self._sessions) >= self.max_sessions:
            raise RuntimeError(f"all {self.max_sessions} session slots busy")
        sid = self._next_id
        self._next_id += 1
        self._sessions[sid] = _Session(
            row=self._free_rows.pop(),
            asm=FrameAssembler(self.cfg, smooth=smooth))
        return sid

    def close(self, sid: int) -> None:
        """Release the session's ring row (flush first to finalise)."""
        st = self._sessions.pop(sid)
        self._free_rows.append(st.row)

    @property
    def n_active(self) -> int:
        return len(self._sessions)

    def has_session(self, sid: int) -> bool:
        return sid in self._sessions

    # -- feeding / reading ---------------------------------------------------

    def push_audio(self, sid: int, samples: np.ndarray) -> None:
        """Queue raw mono samples at cfg.sr for the next tick.

        int16 PCM stays int16 and uploads raw whenever every queued piece of
        a tick is int16; float input is taken as samples in [-1, 1]; other
        integer PCM is widened by its dtype's full scale."""
        samples = np.asarray(samples)
        if np.issubdtype(samples.dtype, np.integer) and \
                samples.dtype != np.int16:
            samples = widen_int_pcm(samples)
        elif samples.dtype != np.int16:
            samples = samples.astype(np.float32)
        samples = samples.reshape(-1)
        if samples.size:
            self._sessions[sid].pending.append(samples)

    def frames_ready(self, sid: int) -> int:
        return self._sessions[sid].asm.frames_ready

    def pop_frames(self, sid: int) -> np.ndarray:
        """Finalised frames since the last pop: [n, output_dim]."""
        return self._sessions[sid].asm.pop_frames()

    # -- the tick ------------------------------------------------------------

    def _t60_valid(self, n_samples: int) -> int:
        """60 fps feature rows a ring of n_samples yields (0 below the
        frontend minimum)."""
        fl = self._frame_samples
        if n_samples < fl or (n_samples - fl) // (fl // 2) + 1 < F.MIN_FRAMES:
            return 0
        return num_frames_60(n_samples, fl)

    def _needs_tick(self, st: _Session, final: bool) -> bool:
        if st.pending:
            return True
        avail = self._t60_valid(st.buf_len) - st.asm.consumed
        return avail >= (1 if final else self.cfg.frame_size)

    def tick(self, *, final_ids=(), _retry: bool = True) -> dict[int, int]:
        """Run one serving tick; returns {sid: newly finalised frames}.

        Sessions in final_ids drain to the very end (flush semantics). A
        failed tick rebuilds every ring from its host shadow and runs again
        once, on the card; a second failure raises."""
        t0 = time.perf_counter()
        try:
            out = self._tick_impl(final_ids=final_ids, _retry=_retry)
        finally:
            # a failed tick counts too, with its time
            with self._metrics_lock:
                self._tick_times.append(time.perf_counter() - t0)
                self._counters["ticks"] += 1
        n = sum(out.values())
        if n:
            with self._metrics_lock:
                self._counters["decode_ticks"] += 1
                self._counters["frames_out"] += n
        return out

    def metrics_snapshot(self) -> dict:
        """Counters and the tick-latency percentiles of the last ≤ 512
        ticks: decode_ticks counts ticks that finalised a frame,
        watchdog_flips the fused → two-dispatch flips, ring_recoveries the
        rebuilds from the host shadows. Served as GET /metrics."""
        with self._metrics_lock:
            times = np.asarray(self._tick_times, dtype=float) * 1e3
            snap = dict(self._counters)
        snap.update(
            live_sessions=self.n_active,
            max_sessions=self.max_sessions,
            fused_decode=self.fused,
            tick_p50_ms=round(float(np.percentile(times, 50)), 2)
            if times.size else None,
            tick_p95_ms=round(float(np.percentile(times, 95)), 2)
            if times.size else None,
            tick_max_ms=round(float(times.max()), 2) if times.size else None,
        )
        return snap

    def _tick_impl(self, *, final_ids=(), _retry: bool = True
                   ) -> dict[int, int]:
        final_ids = set(final_ids)
        # the watchdog may flip self.fused for later ticks; this tick's
        # branches stay on one family
        fused = self.fused
        work = [(sid, st) for sid, st in self._sessions.items()
                if self._needs_tick(st, sid in final_ids)]
        if not work:
            return {}

        n_live = len(work)
        k = session_bucket(n_live)
        P = self.push_capacity
        # raw int16 upload when every queued piece is int16, else fp32 with
        # the int16 pieces widened on the host; an empty upload takes the
        # deployment's format
        pieces = [p for _, st in work for p in st.pending]
        use_i16 = (all(p.dtype == np.int16 for p in pieces) if pieces
                   else self._empty_i16)
        if not use_i16:
            for _, st in work:
                st.pending = [
                    p.astype(np.float32) / 32768.0 if p.dtype == np.int16
                    else p for p in st.pending]
        new = np.zeros((k, P), np.int16 if use_i16 else np.float32)
        # idx, shift, buf_len, new_len, feat_start; padding entries
        # (i >= n_live) carry idx K_cap and are never written back
        ring = np.zeros((5, k), np.int64)
        ring[0] = self._kcap
        offsets, takes = [], []
        # fused decode entries: (work-row index, sid, plan) a ready window
        dec_entries: list[tuple[int, int, tuple]] = []

        for i, (sid, st) in enumerate(work):
            # trim first (frees intake room; renumbers the assembler)
            excess = st.asm.consumed - self.trim_margin
            sh = 0
            if excess >= self.trim_threshold:
                sh = excess * self._frame_samples
                st.asm.shift(excess)
            # intake: what fits this tick; the rest stays queued
            room = self._s_avail - (st.buf_len - sh)
            take = 0
            if st.pending:
                queued = np.concatenate(st.pending)
                take = min(len(queued), P, max(0, room))
                if take:
                    new[i, :take] = queued[:take]
                st.pending = [queued[take:]] if take < len(queued) else []
            fs_req = max(0, st.asm.consumed)
            fs_eff = min(fs_req, self._t60_cap - self.f_win)
            ring[:, i] = (st.row, sh, st.buf_len, take, fs_eff)
            offsets.append(fs_req - fs_eff)
            takes.append(take)
            # the shadow follows the ring (widened floats), so a recovery
            # keeps buffer-space indices and the emitted frames' continuity
            if sh or take:
                taken = new[i, :take]
                if taken.dtype == np.int16:
                    taken = taken.astype(np.float32) / 32768.0
                st.shadow = np.concatenate([st.shadow[sh:], taken])
            if fused:
                # one window from the post-intake state, decoded on the
                # card this tick (the assembler holds no features)
                t60_new = self._t60_valid(st.buf_len - sh + take)
                plan = st.asm.plan_next(
                    t60_new, final=(sid in final_ids and not st.pending))
                if plan is not None:
                    dec_entries.append((i, sid, plan))

        # the decode sub-batch: the ready count's bucket, under the cap;
        # rows past the cap stay ready (plan_next consumed nothing)
        dec = np.zeros((3, 0), np.int64)   # dec_idx, win_start, win_take
        if fused and dec_entries:
            dcap = min(self.decode_bucket_cap or k, k)
            if len(dec_entries) > dcap:
                # least recently decoded first; the stable sort keeps open
                # order among equals (round-robin in steady state)
                dec_entries.sort(key=lambda e: work[e[0]][1].last_dec)
                dec_entries = dec_entries[:dcap]
            dec = np.zeros((3, session_bucket(len(dec_entries))), np.int64)
            for j, (i, _sid, plan) in enumerate(dec_entries):
                dec[:, j] = (i, plan[0], plan[1])
        d = dec.shape[1]

        before = {sid: st.asm.frames_ready for sid, st in work}
        t0 = time.perf_counter()
        try:
            decoded, wins = self._dispatch(fused, new, ring, dec, n_live)
        except Exception as e:  # noqa: BLE001 — rebuild, retry once, re-raise
            if not _retry:
                raise
            print(f"serving tick failed ({e!r}): rebuilding the rings from "
                  "the host shadows and retrying on the card")
            self._recover_rings()
            return self._tick_impl(final_ids=final_ids, _retry=False)

        dt = time.perf_counter() - t0
        # an intake-only tick downloads nothing, so a stall there shows at
        # (and is bounded by) the next decode tick's download
        sig = (k, new.dtype.str, d)
        first_use = fused and sig not in self._fused_seen
        if fused:
            self._fused_seen.add(sig)
        if (fused and not first_use and self.stall_watchdog_s is not None
                and dt > self.stall_watchdog_s):
            print(f"serving tick took {dt:.1f} s (watchdog budget "
                  f"{self.stall_watchdog_s:.0f} s): switching this streamer "
                  "to the two-dispatch tick family for later ticks")
            with self._metrics_lock:
                self._counters["watchdog_flips"] += 1
            self.fused = False

        if fused:
            for i, (sid, st) in enumerate(work):
                st.buf_len = int(ring[2, i]) - int(ring[1, i]) + takes[i]
            if dec_entries:
                self._dec_seq += 1
            for j, (i, sid, plan) in enumerate(dec_entries):
                work[i][1].asm.apply([plan], decoded[j][None])
                work[i][1].last_dec = self._dec_seq
            return {sid: st.asm.frames_ready - before[sid]
                    for sid, st in work}

        # two-dispatch: ingest the feature windows and plan each session,
        # then one batched decode across sessions
        all_windows, plan_of = [], []
        for i, (sid, st) in enumerate(work):
            st.buf_len = int(ring[2, i]) - int(ring[1, i]) + takes[i]
            t60 = self._t60_valid(st.buf_len)
            fs_req = int(ring[4, i]) + offsets[i]
            rows = min(self.f_win - offsets[i], t60 - fs_req)
            if rows > 0:
                st.asm.ingest(wins[i][offsets[i]: offsets[i] + rows],
                              base=fs_req)
            plans = st.asm.plan(final=(sid in final_ids
                                       and not st.pending
                                       and t60 - fs_req <= rows))
            if plans:
                all_windows.append(st.asm.windows(plans))
                plan_of.append((st, plans))

        if all_windows:
            decoded = decode_chunks_batched(
                self.model, np.concatenate(all_windows), self.cfg)
            at = 0
            for (st, plans), w in zip(plan_of, all_windows):
                st.asm.apply(plans, decoded[at: at + len(w)])
                at += len(w)
        return {sid: st.asm.frames_ready - before[sid] for sid, st in work}

    @torch.inference_mode()
    def _dispatch(self, fused: bool, new: np.ndarray, ring: np.ndarray,
                  dec: np.ndarray, n_live: int):
        """Upload the tick's samples and its index vectors (two copies) and
        run one tick family. Returns (decoded [D, frame, out] float64 or
        None, feature windows [k, f_win, 256] float32 or None) on the host.
        """
        dev = self._device
        ints = torch.from_numpy(
            np.concatenate([ring.ravel(), dec.ravel()])).to(dev)
        idx, shift, buf_len, new_len, feat_start = ints[: ring.size].view(
            ring.shape)
        new_t = torch.from_numpy(new).to(dev)
        if fused and dec.shape[1] == 0:
            # intake-only: no row has a window ready
            _tick_ring_only(self._buf, idx, new_t, shift, buf_len, new_len,
                            n_live=n_live)
            return None, None
        if fused:
            dec_idx, win_start, win_take = ints[ring.size:].view(dec.shape)
            out = _tick_fused(self.model, self._buf, idx, new_t, shift,
                              buf_len, new_len, dec_idx, win_start, win_take,
                              n_live=n_live, sr=self.cfg.sr,
                              frame_size=self.cfg.frame_size)
            return out.cpu().numpy().astype(np.float64), None
        wins = _tick_program(self._buf, idx, new_t, shift, buf_len, new_len,
                             feat_start, n_live=n_live, sr=self.cfg.sr,
                             f_win=self.f_win, feat_dtype=self._feat_dtype)
        # bf16 downloads as bf16 (half the bytes), widened on the host
        return None, wins.cpu().float().numpy()

    def _recover_rings(self) -> None:
        """Rebuild after a device fault: fresh zero rings, and every
        session's shadow (its exact pre-fault ring content, so buffer-space
        indices and the consumption cursor stay valid) queued ahead of its
        pending audio, to upload through the normal intake."""
        with self._metrics_lock:
            self._counters["ring_recoveries"] += 1
        self._buf = self._zero_rings()
        for st in self._sessions.values():
            if len(st.shadow):
                st.pending = [st.shadow] + st.pending
                st.shadow = np.zeros(0, np.float32)
            st.buf_len = 0

    def flush(self, sid: int, *, max_ticks: int = 1000) -> int:
        """Finalise everything the session buffered; returns frames added."""
        st = self._sessions[sid]
        before = st.asm.frames_ready
        for _ in range(max_ticks):
            self.tick(final_ids=(sid,))
            if (not st.pending
                    and self._t60_valid(st.buf_len) <= st.asm.consumed):
                break
        else:
            raise RuntimeError("flush did not converge")
        ready_pre_finish = st.asm.frames_ready
        st.asm.finish()
        # frames released by finish() (a smooth session's lookahead frame)
        # bypass tick()'s counts
        with self._metrics_lock:
            self._counters["frames_out"] += (st.asm.frames_ready
                                             - ready_pre_finish)
        return st.asm.frames_ready - before

    # -- warmup --------------------------------------------------------------

    def warmup(self, warm_fallback: bool = True,
               push_dtypes: tuple | None = None,
               background_fallback: bool = False,
               serve_buckets: int | None = None) -> int:
        """Build the CUDA kernels (on the card) and run, on noise in a
        scratch ring buffer, every tick a deployment can reach: per session
        bucket and push dtype, the fused tick at each decode bucket up to
        the cap and the intake-only tick, and (warm_fallback, or in
        two-dispatch mode) the two-dispatch tick and decode_chunks_batched
        at each window bucket its flushes reach. The first live session
        then pays no cuBLAS or allocator first use, and the watchdog guards
        the fused signatures run here from the first live tick. Returns the
        number of runs.

        push_dtypes: "f32" and/or "s16"; None takes push_formats.
        background_fallback and serve_buckets (the JAX package's deferred
        and progressive warmups) have nothing to defer here, where nothing
        compiles: they are accepted, serve_buckets validated, and the whole
        warmup runs before this returns."""
        push_dtypes = _validate_formats(
            "push_dtypes", self.push_formats if push_dtypes is None
            else push_dtypes)
        if serve_buckets is not None and (
                not isinstance(serve_buckets, int) or serve_buckets < 1):
            raise ValueError(
                f"serve_buckets={serve_buckets!r}: must be a positive int "
                "(the session count to warm first)")
        if self._device.type == "cuda":
            kernels.build()
        rng = np.random.default_rng(0)
        cfg = self.cfg
        dev = self._device
        scratch = self._zero_rings()
        runs, sigs = [], []

        def ints(values):
            return torch.tensor(list(values), dtype=torch.int64, device=dev)

        k = 1
        while True:
            noise = rng.standard_normal((k, self.push_capacity))
            variants = []
            if "f32" in push_dtypes:
                variants.append(np.asarray(noise * 0.1, np.float32))
            if "s16" in push_dtypes:
                variants.append(np.asarray(noise * 3000, np.int16))
            # rows 0..k-1: nothing to trim, empty rings, full pushes
            idx, zeros = ints(range(k)), ints([0] * k)
            full = ints([self.push_capacity] * k)
            for new in variants:
                new_t = torch.from_numpy(new).to(dev)
                if self.fused:
                    dmax = session_bucket(min(self.decode_bucket_cap or k, k))
                    d = 1
                    while True:
                        runs.append(functools.partial(
                            _tick_fused, self.model, scratch, idx, new_t,
                            zeros, zeros, full, ints(i % k for i in range(d)),
                            ints([0] * d), ints([cfg.frame_size] * d),
                            n_live=k, sr=cfg.sr, frame_size=cfg.frame_size))
                        sigs.append((k, new.dtype.str, d))
                        if d >= dmax:
                            break
                        d = session_bucket(d + 1)
                    runs.append(functools.partial(
                        _tick_ring_only, scratch, idx, new_t, zeros, zeros,
                        full, n_live=k))
                    sigs.append((k, new.dtype.str, 0))
                if not self.fused or warm_fallback:
                    runs.append(functools.partial(
                        _tick_program, scratch, idx, new_t, zeros, zeros,
                        full, zeros, n_live=k, sr=cfg.sr, f_win=self.f_win,
                        feat_dtype=self._feat_dtype))
            if k >= self._kcap:
                break
            k = session_bucket(k + 1)

        if not self.fused or warm_fallback:
            # a flush of a full f_win backlog plans ceil((f_win - overlap) /
            # stride) windows plus the tail a session; every power-of-two
            # window count up to all sessions doing so at once
            stride = cfg.frame_size - cfg.overlap
            per_session = max(1, -(-(self.f_win - cfg.overlap) // stride) + 1)
            m = 1
            while m <= pow2_bucket(self._kcap * per_session):
                chunk = rng.standard_normal(
                    (m, cfg.frame_size, cfg.input_dim)).astype(np.float32)
                runs.append(functools.partial(decode_chunks_batched,
                                              self.model, chunk, cfg))
                m *= 2

        with torch.inference_mode():
            for run in runs:
                run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        # committed only once every run has finished
        self._fused_seen.update(sigs)
        return len(runs)

    def wait_background_warmup(self, timeout: float | None = None) -> bool:
        """True: warmup() runs everything before it returns, so there is no
        background warmup to wait for (kept for the JAX package's API)."""
        return True

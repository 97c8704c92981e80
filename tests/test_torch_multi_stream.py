"""The port's multi-session serving: K batched live sessions against K
independent port BlendshapeStreamers, against the JAX package's
MultiStreamer, and the behaviours of tests/test_multi_stream.py.

Geometry of tests/test_multi_stream.py (hidden 32, 1 layer, 2 heads, fp32,
trim 64 / 16, max_buffer_seconds 4.0), the JAX weights carried into the
port. A session and its oracle see identical buffers at every extraction,
but in other pad buckets: the features agree to fp32 summation order, and
the frames to atol 2e-4, rtol 2e-3 (tests/test_multi_stream.py:71).
"""

import numpy as np
import pytest
import torch

import jax

from neurosync_trainer_lite_tpu.config import Config as JConfig
from neurosync_trainer_lite_tpu.inference.multi_stream import (
    MultiStreamer as JMultiStreamer,
)
from neurosync_trainer_lite_tpu.models.seq2seq import init_seq2seq as j_init
from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.inference import multi_stream as M
from neurosync_trainer_lite_tpu_torch.inference.api import (
    smooth_by_averaging_pairs,
)
from neurosync_trainer_lite_tpu_torch.inference.multi_stream import (
    MultiStreamer,
    session_bucket,
)
from neurosync_trainer_lite_tpu_torch.inference.streaming import (
    BlendshapeStreamer,
)
from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq
from neurosync_trainer_lite_tpu_torch.utils.weights import params_from_jax

GEOM = dict(hidden_dim=32, n_layers=1, num_heads=2, dropout=0.0,
            use_amp=False)
TRIM_THRESHOLD, TRIM_MARGIN = 64, 16
TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test files at once, one a worker process, on
    the host's cores: torch's own pool of a thread a core in each worker
    would oversubscribe them many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_model(params, cfg):
    model = Seq2Seq(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def same_weights():
    jcfg = JConfig(**GEOM)
    params = j_init(jax.random.PRNGKey(0), jcfg)
    cfg = Config(**GEOM)
    return jcfg, params, cfg, _port_model(params, cfg)


@pytest.fixture(scope="module")
def setup(same_weights):
    _, _, cfg, model = same_weights
    return cfg, model


def _single(model, cfg):
    s = BlendshapeStreamer(model, cfg, device="cpu")
    s.TRIM_THRESHOLD_FRAMES = TRIM_THRESHOLD
    s.TRIM_MARGIN_FRAMES = TRIM_MARGIN
    return s


def _multi(model, cfg, **kw):
    kw.setdefault("trim_threshold", TRIM_THRESHOLD)
    kw.setdefault("trim_margin", TRIM_MARGIN)
    kw.setdefault("max_buffer_seconds", 4.0)
    return MultiStreamer(model, cfg, device="cpu", **kw)


def _noise(rng, seconds, sr=88200):
    return (rng.standard_normal(int(sr * seconds)) * 0.4).astype(np.float32)


def _assert_streams_equal(got, want, tol=TOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)


def test_geometry_of_the_defaults(setup):
    """The full-width defaults: a 2^20-sample ring (4 MiB a session in
    fp32), 131,072 samples a tick, 713 feature rows a ring and a 256-row
    feature window; the rows are num_frames_120(S_cap) // 2 (an odd last
    frame dropped), not num_frames_60."""
    cfg, model = setup
    ms = MultiStreamer(model, cfg, device="cpu")
    assert ms._s_cap == 1 << 20 and ms._buf.shape == (8, 1 << 20)
    assert ms._buf.dtype == torch.float32
    assert ms.push_capacity == 131_072
    assert ms._t60_cap == 713 and ms.f_win == 256
    assert ms.decode_bucket_cap == 8
    assert [session_bucket(n) for n in (1, 3, 5, 9, 17, 25, 33)] == [
        1, 4, 8, 16, 24, 32, 48]


@pytest.mark.parametrize("fused", [True, False])
def test_multi_matches_independent_single_streamers(setup, fused):
    """K batched sessions produce what K independent streamers produce from
    the same pushes at the same cadence, in both tick families."""
    cfg, model = setup
    rng = np.random.default_rng(1)
    audios = [_noise(rng, s) for s in (5.0, 6.0, 4.2)]
    ms = _multi(model, cfg, max_sessions=4, fused_decode=fused)
    sids = [ms.open() for _ in audios]
    singles = [_single(model, cfg) for _ in audios]
    step = cfg.sr // 3
    for r in range(max(len(a) for a in audios) // step + 1):
        for sid, single, audio in zip(sids, singles, audios):
            chunk = audio[r * step: (r + 1) * step]
            if chunk.size:
                ms.push_audio(sid, chunk)
                single.push_audio(chunk)
        ms.tick()
    for sid, single in zip(sids, singles):
        ms.flush(sid)
        single.flush()
        _assert_streams_equal(ms.pop_frames(sid), single.pop_frames())


def test_schedule_matches_the_jax_multistreamer(same_weights):
    """One schedule through the JAX package's MultiStreamer and the port's
    (fused, the default): staggered opens, mixed int16 and float32 pushes,
    a flush and close mid-run, the frames of every tick compared."""
    jcfg, params, cfg, model = same_weights
    rng = np.random.default_rng(3)
    pcm = [(rng.standard_normal(int(cfg.sr * s)) * 9000).astype(np.int16)
           for s in (4.0, 3.0, 3.5)]
    kw = dict(max_sessions=4, trim_threshold=TRIM_THRESHOLD,
              trim_margin=TRIM_MARGIN, max_buffer_seconds=4.0)
    ours = MultiStreamer(model, cfg, device="cpu", **kw)
    theirs = JMultiStreamer(params, jcfg, **kw)
    step = cfg.sr // 2
    opened = {}
    for r in range(10):
        if r in (0, 1, 3):
            j = len(opened)
            opened[j] = (ours.open(), theirs.open())
        for j, (a, b) in opened.items():
            chunk = pcm[j][(r - (0, 1, 3)[j]) * step:][:step]
            if chunk.size == 0 or not ours.has_session(a):
                continue
            if j == 1:
                chunk = chunk.astype(np.float32) / 32768.0
            ours.push_audio(a, chunk)
            theirs.push_audio(b, chunk)
        assert ours.tick() == theirs.tick()
        for a, b in opened.values():
            if ours.has_session(a):
                _assert_streams_equal(ours.pop_frames(a),
                                      theirs.pop_frames(b))
        if r == 6:
            a, b = opened[0]
            assert ours.flush(a) == theirs.flush(b)
            _assert_streams_equal(ours.pop_frames(a), theirs.pop_frames(b))
            ours.close(a)
            theirs.close(b)
    for j in (1, 2):
        a, b = opened[j]
        assert ours.flush(a) == theirs.flush(b)
        _assert_streams_equal(ours.pop_frames(a), theirs.pop_frames(b))
    m, jm = ours.metrics_snapshot(), theirs.metrics_snapshot()
    for key in ("ticks", "decode_ticks", "frames_out", "watchdog_flips",
                "ring_recoveries", "live_sessions", "max_sessions",
                "fused_decode"):
        assert m[key] == jm[key], key
    assert set(m) == set(jm)


def test_decode_bucket_cap_defers_to_next_tick_and_matches_oracle(setup):
    """When more sessions are ready than decode_bucket_cap, the surplus
    decodes on a later tick (plan_next consumed nothing for it)."""
    cfg, model = setup
    rng = np.random.default_rng(31)
    audios = [_noise(rng, 3.0) for _ in range(5)]
    ms = _multi(model, cfg, max_sessions=8, decode_bucket_cap=2)
    sids = [ms.open() for _ in audios]
    singles = [_single(model, cfg) for _ in audios]
    for sid, single, audio in zip(sids, singles, audios):
        ms.push_audio(sid, audio)
        single.push_audio(audio)
    out = ms.tick()
    assert sum(1 for v in out.values() if v > 0) <= 2
    for _ in range(6):
        if not ms.tick():
            break
    for sid, single in zip(sids, singles):
        ms.flush(sid)
        single.flush()
        _assert_streams_equal(ms.pop_frames(sid), single.pop_frames())


def test_decode_cap_is_fair_under_sustained_overload(setup):
    """Every session ready on every tick, cap 1: service rotates least
    recently decoded first (work order would give (8, 0, 0, 0))."""
    cfg, model = setup
    rng = np.random.default_rng(7)
    ms = _multi(model, cfg, max_sessions=8, decode_bucket_cap=1)
    sids = [ms.open() for _ in range(4)]
    for sid in sids:
        ms.push_audio(sid, _noise(rng, 8.0))
    decodes = {sid: 0 for sid in sids}
    for _ in range(8):
        out = ms.tick()
        assert sum(1 for v in out.values() if v > 0) <= 1
        for sid, v in out.items():
            decodes[sid] += v > 0
    assert all(v >= 1 for v in decodes.values()), decodes
    assert max(decodes.values()) - min(decodes.values()) <= 1, decodes


def test_invalid_arguments_are_rejected(setup):
    """The liveness floor (a ring below trim_threshold + trim_margin +
    frame_size frames deadlocks a backlogged session), decode caps other
    than an int ≥ 1, None or 'auto', non-positive push_seconds, and upload
    formats outside ('f32', 's16')."""
    cfg, model = setup
    with pytest.raises(ValueError, match="deadlock"):
        MultiStreamer(model, cfg, max_sessions=4, trim_threshold=256,
                      trim_margin=64, max_buffer_seconds=4.0, device="cpu")
    for bad in (0, -1, 2.5, True, "Auto", "none"):
        with pytest.raises(ValueError, match="decode_bucket_cap"):
            _multi(model, cfg, max_sessions=4, decode_bucket_cap=bad)
    for bad in (0.0, -0.5):
        with pytest.raises(ValueError, match="push_seconds"):
            _multi(model, cfg, max_sessions=4, push_seconds=bad)
    ms = _multi(model, cfg, max_sessions=4)
    for bad in ((), ("f32", "int16"), ("i2",)):
        with pytest.raises(ValueError, match="push_formats"):
            _multi(model, cfg, max_sessions=4, push_formats=bad)
        with pytest.raises(ValueError, match="push_dtypes"):
            ms.warmup(push_dtypes=bad)
    with pytest.raises(ValueError, match="serve_buckets"):
        ms.warmup(serve_buckets=0)


def test_auto_decode_cap_scales_with_session_count(setup):
    cfg, model = setup
    for k, want in ((4, 8), (8, 8), (16, 8), (24, 8), (32, 16)):
        ms = _multi(model, cfg, max_sessions=k)
        assert ms.decode_bucket_cap == want, (k, ms.decode_bucket_cap)


def test_deep_backlog_flush_converges_under_decode_cap(setup):
    cfg, model = setup
    rng = np.random.default_rng(11)
    ms = _multi(model, cfg, max_sessions=8, decode_bucket_cap=2)
    sids = [ms.open() for _ in range(3)]
    for sid in sids:
        ms.push_audio(sid, _noise(rng, 12.0))
    for _ in range(4):
        ms.tick()
    for sid in sids:
        ms.flush(sid)
        assert ms.pop_frames(sid).shape[0] >= 12 * 60 - 2
        ms.close(sid)


def _mirror_intake(ms, sid, audio, single, max_ticks=200):
    """Tick until the session took all of `audio`, feeding the oracle what
    the session took each tick (identical buffers)."""
    fed = 0
    for _ in range(max_ticks):
        counts = ms.tick(final_ids=(sid,) if fed >= len(audio) else ())
        pending = ms._sessions[sid].pending
        taken = len(audio) - (len(pending[0]) if pending else 0)
        assert taken - fed <= ms.push_capacity
        if taken > fed:
            single.push_audio(audio[fed:taken])
        fed = taken
        if not counts and fed >= len(audio):
            break


def test_push_seconds_shrinks_upload_width_and_matches_oracle(setup):
    cfg, model = setup
    wide = _multi(model, cfg, max_sessions=2)
    narrow = _multi(model, cfg, max_sessions=2, push_seconds=0.5)
    assert int(0.5 * cfg.sr) <= narrow.push_capacity < wide.push_capacity
    audio = _noise(np.random.default_rng(33), 4.0)
    sid = narrow.open()
    single = _single(model, cfg)
    narrow.push_audio(sid, audio)
    _mirror_intake(narrow, sid, audio, single, max_ticks=100)
    narrow.flush(sid)
    single.flush()
    _assert_streams_equal(narrow.pop_frames(sid), single.pop_frames())


@pytest.mark.parametrize("fused", [True, False])
def test_oversized_push_backpressures_and_catches_up(setup, fused):
    """A push far past the intake capacity waits on the host and drains
    over ticks; the fused tick decodes one window a tick."""
    cfg, model = setup
    audio = _noise(np.random.default_rng(3), 12.0)
    ms = _multi(model, cfg, max_sessions=2, fused_decode=fused)
    sid = ms.open()
    ms.push_audio(sid, audio)
    assert len(audio) > ms.push_capacity
    single = _single(model, cfg)
    _mirror_intake(ms, sid, audio, single)
    ms.flush(sid)
    single.flush()
    _assert_streams_equal(ms.pop_frames(sid), single.pop_frames())


@pytest.mark.parametrize("seed", [21, 22])
def test_randomized_schedule_matches_oracle(setup, seed):
    """Random push sizes (empty ticks too), mixed int16 and float32 pushes
    and session churn: every stream equals its own oracle, and the metrics
    count what the surface delivered."""
    cfg, model = setup
    rng = np.random.default_rng(seed)
    ms = _multi(model, cfg, max_sessions=3)
    active, done_frames = {}, []

    def open_session():
        active[ms.open()] = (_single(model, cfg), int(rng.integers(6, 14)))

    open_session()
    open_session()
    for _ in range(20):
        for sid in list(active):
            single, ttl = active[sid]
            n = int(rng.integers(0, cfg.sr // 2))
            if n:
                if rng.random() < 0.5:
                    chunk = (rng.standard_normal(n) * 9000).astype(np.int16)
                    ms.push_audio(sid, chunk)
                    single.push_audio(chunk.astype(np.float32) / 32768.0)
                else:
                    chunk = (rng.standard_normal(n) * 0.3).astype(np.float32)
                    ms.push_audio(sid, chunk)
                    single.push_audio(chunk)
            active[sid] = (single, ttl - 1)
        ms.tick()
        for sid in [s for s, (_, ttl) in active.items() if ttl <= 0]:
            single, _ = active.pop(sid)
            ms.flush(sid)
            single.flush()
            got = ms.pop_frames(sid)
            ms.close(sid)
            _assert_streams_equal(got, single.pop_frames())
            done_frames.append(len(got))
            if len(active) < 2:
                open_session()
    for sid, (single, _) in active.items():
        ms.flush(sid)
        single.flush()
        got = ms.pop_frames(sid)
        _assert_streams_equal(got, single.pop_frames())
        done_frames.append(len(got))
    m = ms.metrics_snapshot()
    assert m["frames_out"] == sum(done_frames)
    assert 0 < m["decode_ticks"] <= m["ticks"]
    assert m["watchdog_flips"] == 0 and m["ring_recoveries"] == 0
    assert m["tick_p95_ms"] >= m["tick_p50_ms"] > 0


def test_stall_watchdog_switches_to_two_dispatch_mid_session(setup):
    """A fused tick over the budget flips the streamer to the two-dispatch
    family, on the card's device, not the CPU; the session continues
    seamlessly (the assembler's pending tail is shared by both families)."""
    cfg, model = setup
    audio = _noise(np.random.default_rng(5), 6.0)
    ms = _multi(model, cfg, max_sessions=2, stall_watchdog_s=-1.0)
    ref = _multi(model, cfg, max_sessions=2, stall_watchdog_s=None)
    sid, rid = ms.open(), ref.open()
    step = cfg.sr // 3
    for r in range(len(audio) // step + 1):
        chunk = audio[r * step: (r + 1) * step]
        if chunk.size:
            ms.push_audio(sid, chunk)
            ref.push_audio(rid, chunk)
        ms.tick()
        ref.tick()
    assert ms.fused is False and ref.fused is True
    assert ms._buf.device == ref._buf.device
    m, mr = ms.metrics_snapshot(), ref.metrics_snapshot()
    assert m["watchdog_flips"] == 1 and mr["watchdog_flips"] == 0
    assert m["fused_decode"] is False
    ms.flush(sid)
    ref.flush(rid)
    _assert_streams_equal(ms.pop_frames(sid), ref.pop_frames(rid))


def test_stall_watchdog_exempts_first_use_and_warmed_signatures(setup):
    """The first tick on a fused signature (session bucket, dtype, decode
    bucket) is exempt; its second breach flips. warmup() runs every
    signature, so a warmed streamer flips at the first live breach."""
    cfg, model = setup
    chunk = _noise(np.random.default_rng(11), 0.5)
    ms = _multi(model, cfg, max_sessions=1, stall_watchdog_s=-1.0)
    sid = ms.open()
    ms.push_audio(sid, chunk)
    ms.tick()
    assert ms.fused is True
    ms.push_audio(sid, chunk)
    ms.tick()
    assert ms.fused is False

    ms2 = _multi(model, cfg, max_sessions=1, stall_watchdog_s=-1.0)
    n = ms2.warmup(warm_fallback=False)
    assert n == len(ms2._fused_seen) == 4   # (1, dtype, 1) and (1, dtype, 0)
    sid2 = ms2.open()
    ms2.push_audio(sid2, chunk)
    ms2.tick()
    assert ms2.fused is False


def test_warmup_runs_each_family_once_and_defers_nothing(setup):
    """warmup() returns its runs: the fused family (each decode bucket and
    the intake-only tick a session bucket and dtype), plus the two-dispatch
    fallback family; a single-format deployment runs half the fused family.
    background_fallback and serve_buckets have nothing to defer."""
    cfg, model = setup
    n_lean = _multi(model, cfg, max_sessions=2).warmup(warm_fallback=False)
    n_full = _multi(model, cfg, max_sessions=2).warmup(
        background_fallback=True, serve_buckets=1)
    two = _multi(model, cfg, max_sessions=2, fused_decode=False)
    n_unfused = two.warmup()
    assert n_lean == 2 * (3 + 2)           # k=1: d 1; k=2: d 1, 2; 2 rings
    assert n_full == n_lean + n_unfused
    s16 = _multi(model, cfg, max_sessions=2, push_formats=("s16",))
    assert s16.warmup(warm_fallback=False) == n_lean // 2
    assert all(sig[1] == "<i2" for sig in s16._fused_seen)
    assert two.wait_background_warmup(0.0) and not two._fused_seen


def test_stall_watchdog_disabled_with_none(setup):
    cfg, model = setup
    ms = _multi(model, cfg, max_sessions=1, stall_watchdog_s=None)
    sid = ms.open()
    ms.push_audio(sid, _noise(np.random.default_rng(6), 3.0))
    ms.tick()
    ms.flush(sid)
    assert ms.fused is True


def test_session_rows_are_isolated_and_reused(setup):
    """A closed session's row, reused, shows none of the old audio; the
    other row was untouched throughout."""
    cfg, model = setup
    rng = np.random.default_rng(2)
    ms = _multi(model, cfg, max_sessions=2)
    a, b = ms.open(), ms.open()
    with pytest.raises(RuntimeError):
        ms.open()
    audio_a, audio_b = _noise(rng, 3.0), _noise(rng, 3.0)
    ms.push_audio(a, audio_a)
    ms.push_audio(b, audio_b)
    ms.tick()
    ms.flush(a)
    frames_a = ms.pop_frames(a)
    row_a = ms._sessions[a].row
    ms.close(a)
    c = ms.open()
    assert ms._sessions[c].row == row_a
    ms.push_audio(c, audio_a)
    ms.tick()
    ms.flush(c)
    _assert_streams_equal(ms.pop_frames(c), frames_a)
    ms.flush(b)
    single_b = _single(model, cfg)
    single_b.push_audio(audio_b)
    single_b.flush()
    _assert_streams_equal(ms.pop_frames(b), single_b.pop_frames())


def test_device_fault_recovers_from_host_shadows(setup, monkeypatch):
    """A failed tick rebuilds the rings from the host shadows and retries
    once on the same device; the stream equals an uninterrupted run up to
    the CMVN drift of a ring being re-uploaded (5e-4 / 5e-3, as
    tests/test_multi_stream.py:706). A tick whose retry fails too raises."""
    cfg, model = setup
    audio = _noise(np.random.default_rng(9), 6.0)
    step = cfg.sr // 2
    real = {name: getattr(M, name)
            for name in ("_tick_fused", "_tick_ring_only")}

    def run(fail):
        calls = {"n": 0}

        def flaky(fn):
            def call(*a, **k):
                calls["n"] += 1
                if fail(calls["n"]):
                    raise RuntimeError("simulated device fault")
                return fn(*a, **k)
            return call

        for name, fn in real.items():
            monkeypatch.setattr(M, name, flaky(fn))
        ms = _multi(model, cfg, max_sessions=2)
        sid = ms.open()
        try:
            for i in range(0, len(audio), step):
                ms.push_audio(sid, audio[i: i + step])
                ms.tick()
            ms.flush(sid)
        finally:
            for name, fn in real.items():
                monkeypatch.setattr(M, name, fn)
        return ms.pop_frames(sid), ms.metrics_snapshot()

    want, m0 = run(lambda n: False)
    # call 8: the second decoding tick, after frames went out; its retry,
    # on empty rings, is an intake-only tick (call 9)
    got, m1 = run(lambda n: n == 8)
    assert m0["ring_recoveries"] == 0 and m1["ring_recoveries"] == 1
    _assert_streams_equal(got, want, dict(atol=5e-4, rtol=5e-3))
    with pytest.raises(RuntimeError, match="simulated"):
        run(lambda n: n in (8, 9))


def test_int16_pushes_match_widened_float_pushes(setup):
    """int16 pushes (uploaded raw, widened /32768 on the device) equal the
    same audio pushed pre-widened, also with a float piece mid-session
    (host widening for that tick)."""
    cfg, model = setup
    rng = np.random.default_rng(10)
    pcm = (rng.standard_normal(cfg.sr * 4) * 8000).astype(np.int16)
    widened = pcm.astype(np.float32) / 32768.0
    step = cfg.sr // 2

    def run(as_int16, mix_at=None):
        ms = _multi(model, cfg, max_sessions=2)
        sid = ms.open()
        for j, i in enumerate(range(0, len(pcm), step)):
            chunk = pcm[i: i + step] if as_int16 else widened[i: i + step]
            if j == mix_at:
                chunk = widened[i: i + step]
            ms.push_audio(sid, chunk)
            ms.tick()
        ms.flush(sid)
        return ms.pop_frames(sid)

    want = run(as_int16=False)
    tol = dict(atol=1e-5, rtol=1e-4)
    _assert_streams_equal(run(as_int16=True), want, tol)
    _assert_streams_equal(run(as_int16=True, mix_at=3), want, tol)


def test_open_caps_at_max_sessions_not_ring_capacity(setup):
    cfg, model = setup
    ms = _multi(model, cfg, max_sessions=3)
    assert ms._buf.shape[0] == 4
    for _ in range(3):
        ms.open()
    with pytest.raises(RuntimeError):
        ms.open()


def test_session_smoothing_matches_pair_average(setup):
    cfg, model = setup
    audio = _noise(np.random.default_rng(12), 4.0)
    step = cfg.sr // 2
    ms = _multi(model, cfg, max_sessions=2)
    raw, smooth = ms.open(), ms.open(smooth=True)
    for i in range(0, len(audio), step):
        ms.push_audio(raw, audio[i: i + step])
        ms.push_audio(smooth, audio[i: i + step])
        ms.tick()
    n_raw, n_smooth = ms.flush(raw), ms.flush(smooth)
    got_raw = ms.pop_frames(raw)
    np.testing.assert_allclose(ms.pop_frames(smooth),
                               smooth_by_averaging_pairs(got_raw),
                               atol=1e-12)
    assert ms.metrics_snapshot()["frames_out"] == 2 * len(got_raw)
    assert n_raw > 0 and n_smooth > 0


def test_bf16_feature_download_is_decode_identical():
    """With a bf16 model the two-dispatch tick downloads bf16 features: the
    decode rounds its input to bf16 anyway, so a session matches a single
    streamer (fp32 features) to the usual tolerance."""
    geom = dict(GEOM, use_amp=True)
    jparams = j_init(jax.random.PRNGKey(0), JConfig(**geom))
    cfg = Config(**geom)
    model = _port_model(jparams, cfg)
    audio = _noise(np.random.default_rng(13), 4.0)
    step = cfg.sr // 2
    ms = _multi(model, cfg, max_sessions=2, fused_decode=False)
    assert ms._feat_dtype == torch.bfloat16
    sid = ms.open()
    single = _single(model, cfg)
    for i in range(0, len(audio), step):
        ms.push_audio(sid, audio[i: i + step])
        single.push_audio(audio[i: i + step])
        ms.tick()
    ms.flush(sid)
    single.flush()
    _assert_streams_equal(ms.pop_frames(sid), single.pop_frames())


def test_intake_only_ticks_skip_decode(setup, monkeypatch):
    """Ticks with no window ready take the ring-only tick (no frontend, no
    decode, no download); the output is unchanged."""
    cfg, model = setup
    audio = _noise(np.random.default_rng(14), 5.0)
    step = cfg.sr // 4
    calls = {"full": 0, "ring": 0}
    real_fused, real_ring = M._tick_fused, M._tick_ring_only

    def fused(*a, **k):
        calls["full"] += 1
        return real_fused(*a, **k)

    def ring(*a, **k):
        calls["ring"] += 1
        return real_ring(*a, **k)

    monkeypatch.setattr(M, "_tick_fused", fused)
    monkeypatch.setattr(M, "_tick_ring_only", ring)
    ms = _multi(model, cfg, max_sessions=2)
    sid = ms.open()
    for i in range(0, len(audio), step):
        ms.push_audio(sid, audio[i: i + step])
        ms.tick()
    ms.flush(sid)
    got = ms.pop_frames(sid)
    assert calls["ring"] > calls["full"] > 0, calls
    single = _single(model, cfg)
    single.push_audio(audio)
    single.flush()
    _assert_streams_equal(got, single.pop_frames(),
                          dict(atol=5e-4, rtol=5e-3))


def test_a_tick_reads_back_only_its_one_download(setup, monkeypatch):
    """No per-row code reads a device value on the host: during a fused
    tick the only device → host read is the decoded windows' download, an
    intake-only tick reads nothing, and a two-dispatch tick reads its
    feature windows and (in its second dispatch) the decoded ones. Every
    way Python reads a tensor back is counted."""
    cfg, model = setup
    reads = []
    for name in ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **k):
            reads.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    rng = np.random.default_rng(15)
    for fused in (True, False):
        ms = _multi(model, cfg, max_sessions=4, fused_decode=fused)
        sids = [ms.open() for _ in range(3)]
        kinds = set()
        for _ in range(8):
            for sid in sids:
                ms.push_audio(sid, _noise(rng, 0.5))
            reads.clear()
            out = ms.tick()
            decoded = any(v > 0 for v in out.values())
            # .cpu() then .numpy() is one download
            downloads = reads.count("cpu")
            assert reads == ["cpu", "numpy"] * downloads, reads
            if fused:
                assert downloads == (1 if decoded else 0), (out, reads)
            else:
                assert downloads == (2 if decoded else 1), (out, reads)
            kinds.add(decoded)
        assert kinds == {True, False}


def test_tf32_stays_off(setup):
    """The frontend's fp32 products (batched over K rows too) need TF32
    off, PyTorch's default: nothing in live serving turns it on."""
    cfg, model = setup
    ms = _multi(model, cfg, max_sessions=2)
    ms.warmup(warm_fallback=False)
    sid = ms.open()
    ms.push_audio(sid, _noise(np.random.default_rng(16), 3.0))
    ms.flush(sid)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"

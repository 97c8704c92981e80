"""The port's live streamer (FrameAssembler, BlendshapeStreamer) against the
JAX package's, against the offline port path, and against a serial oracle.

Geometry of tests/test_streaming.py and tests/test_multi_stream.py (hidden
32, 1 layer, 2 heads, fp32), the JAX weights carried into the port.
"""

import numpy as np
import pytest
import torch

import jax

from neurosync_trainer_lite_tpu.config import Config as JConfig
from neurosync_trainer_lite_tpu.inference.streaming import (
    BlendshapeStreamer as JStreamer,
)
from neurosync_trainer_lite_tpu.models.seq2seq import init_seq2seq as j_init
from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.data.processing import (
    BLENDSHAPE_SCALE,
    extract_audio_features,
)
from neurosync_trainer_lite_tpu_torch.inference.api import (
    smooth_by_averaging_pairs,
)
from neurosync_trainer_lite_tpu_torch.inference.chunked import (
    blend_chunks,
    pad_audio_chunk,
    process_audio_features,
)
from neurosync_trainer_lite_tpu_torch.inference.streaming import (
    BlendshapeStreamer,
    FrameAssembler,
)
from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq
from neurosync_trainer_lite_tpu_torch.utils.weights import params_from_jax

GEOM = dict(hidden_dim=32, n_layers=1, num_heads=2, dropout=0.0,
            use_amp=False)


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
def oracle_setup():
    """frame_size 32, overlap 8, 16 features: tests/test_streaming.py's
    fake-frontend geometry."""
    geom = dict(GEOM, frame_size=32, overlap=8, input_dim=16)
    jcfg = JConfig(**geom)
    cfg = Config(**geom)
    return cfg, _port_model(j_init(jax.random.PRNGKey(0), jcfg), cfg)


def _feature_oracle(cfg):
    """Deterministic fake frontend: 60 fps features derived from samples."""
    def extract(y):
        n = len(y) // (cfg.sr // 60)
        if n == 0:
            return None
        t = np.arange(n, dtype=np.float32)[:, None]
        f = np.arange(cfg.input_dim, dtype=np.float32)[None, :]
        return np.sin(0.01 * t * (1 + f)).astype(np.float32)
    return extract


def test_streamer_matches_jax_push_for_push(same_weights):
    """The default (bucketed masked) frontend on both sides, 1/3 s pushes of
    4 s of audio, trimming on: the same frames finalised at every push.
    fp32 both sides; features agree to ~3e-6 and the frames, divided by
    100, within 1e-6 (tests/test_torch_inference.py's serving bound)."""
    jcfg, params, cfg, model = same_weights
    audio = (np.random.default_rng(5).standard_normal(cfg.sr * 4) * 0.4
             ).astype(np.float32)
    ours = BlendshapeStreamer(model, cfg, device="cpu")
    theirs = JStreamer(params, jcfg)
    for s in (ours, theirs):
        s.TRIM_THRESHOLD_FRAMES, s.TRIM_MARGIN_FRAMES = 64, 16
    step = cfg.sr // 3
    pushes = 0
    for i in range(0, len(audio), step):
        got = ours.push_audio(audio[i: i + step])
        assert got == theirs.push_audio(audio[i: i + step])
        pushes += got > 0
        np.testing.assert_allclose(ours.pop_frames(), theirs.pop_frames(),
                                   atol=1e-6, rtol=1e-4)
    assert pushes >= 2
    assert len(ours._audio) < len(audio)       # trimmed
    ours.flush()
    theirs.flush()
    np.testing.assert_allclose(ours.pop_frames(), theirs.pop_frames(),
                               atol=1e-6, rtol=1e-4)


def test_default_extractor_matches_offline_core(same_weights):
    """Core equality with the offline port path up to the CMVN drift of a
    re-extracted buffer: tests/test_streaming.py:212's 5e-4 / 5e-3."""
    _, _, cfg, model = same_weights
    audio = (np.random.default_rng(5).standard_normal(cfg.sr * 5) * 0.4
             ).astype(np.float32)
    feats, _ = extract_audio_features(audio, cfg.sr, device="cpu")
    offline = process_audio_features(np.asarray(feats), model, cfg)
    streamer = BlendshapeStreamer(model, cfg, device="cpu")
    step = cfg.sr // 3
    for i in range(0, len(audio), step):
        streamer.push_audio(audio[i: i + step])
    streamer.flush()
    streamed = streamer.pop_frames()
    assert streamed.shape == offline.shape
    core = len(offline) - cfg.frame_size
    np.testing.assert_allclose(streamed[:core], offline[:core],
                               atol=5e-4, rtol=5e-3)


def test_oracle_frontend_matches_offline_and_tail(oracle_setup):
    """With a deterministic fake frontend, chunk boundaries and blend math
    equal the offline path's on the core (tests/test_streaming.py:52's
    1e-5 / 1e-4); the tail, blended where the offline path concatenates,
    stays within 0.02 of LiveLink range."""
    cfg, model = oracle_setup
    extract = _feature_oracle(cfg)
    spf = cfg.sr // 60
    audio = np.random.default_rng(0).standard_normal(100 * spf).astype(
        np.float32)
    offline = process_audio_features(extract(audio), model, cfg)
    for step in (7 * spf, len(audio)):
        streamer = BlendshapeStreamer(model, cfg, extract_features=extract,
                                      device="cpu")
        for i in range(0, len(audio), step):
            streamer.push_audio(audio[i: i + step])
        streamer.flush()
        streamed = streamer.pop_frames()
        assert streamed.shape == offline.shape
        core = len(offline) - cfg.frame_size
        np.testing.assert_allclose(streamed[:core], offline[:core],
                                   atol=1e-5, rtol=1e-4)
        assert np.abs(streamed[core:] - offline[core:]).max() < 0.02


def test_empty_short_and_smoothed_streams(oracle_setup):
    cfg, model = oracle_setup
    extract = _feature_oracle(cfg)
    spf = cfg.sr // 60
    s = BlendshapeStreamer(model, cfg, extract_features=extract, device="cpu")
    assert s.push_audio(np.zeros(10, np.float32)) == 0
    s.flush()
    assert s.pop_frames().shape[0] == 0

    s2 = BlendshapeStreamer(model, cfg, extract_features=extract,
                            device="cpu")
    s2.push_audio(np.random.default_rng(2).standard_normal(10 * spf)
                  .astype(np.float32))
    s2.flush()
    assert s2.pop_frames().shape == (10, cfg.output_dim)

    audio = np.random.default_rng(11).standard_normal(90 * spf).astype(
        np.float32)
    raw = BlendshapeStreamer(model, cfg, extract_features=extract,
                             device="cpu")
    smooth = BlendshapeStreamer(model, cfg, extract_features=extract,
                                smooth=True, device="cpu")
    for i in range(0, len(audio), 11 * spf):
        raw.push_audio(audio[i: i + 11 * spf])
        smooth.push_audio(audio[i: i + 11 * spf])
        assert raw.frames_ready - smooth.frames_ready in (0, 1)
    raw.flush()
    smooth.flush()
    np.testing.assert_allclose(smooth.pop_frames(),
                               smooth_by_averaging_pairs(raw.pop_frames()),
                               atol=1e-12)


def test_trimming_bounds_the_buffer_and_keeps_the_output(oracle_setup):
    cfg, model = oracle_setup
    spf = cfg.sr // 60

    def run(threshold):
        s = BlendshapeStreamer(model, cfg, extract_features=lambda y: None,
                               device="cpu")
        s._can_trim = True
        s.TRIM_THRESHOLD_FRAMES = threshold
        s.TRIM_MARGIN_FRAMES = 16
        s._frame_samples = spf
        fed = {"n": 0}

        def extract_abs(y):    # features of absolute position: trim-proof
            n = len(y) // spf
            if n == 0:
                return None
            start = fed["n"] - len(s._audio)
            t = (np.arange(n, dtype=np.float32) + start / spf)[:, None]
            f = np.arange(cfg.input_dim, dtype=np.float32)[None, :]
            return np.sin(0.01 * t * (1 + f)).astype(np.float32)

        s._extract = extract_abs
        out = []
        for _ in range(20):
            fed["n"] += 20 * spf
            s.push_audio(np.zeros(20 * spf, np.float32))
            out.append(s.pop_frames())
        s.flush()
        out.append(s.pop_frames())
        return np.concatenate(out), len(s._audio)

    frames_trim, buf_trim = run(threshold=64)
    frames_none, buf_none = run(threshold=10**9)
    assert frames_trim.shape == frames_none.shape
    np.testing.assert_allclose(frames_trim, frames_none, atol=1e-5)
    assert buf_trim < buf_none


def test_warmup_runs_every_bucket_as_jax_counts_them(same_weights):
    jcfg, params, cfg, model = same_weights
    ours = BlendshapeStreamer(model, cfg, device="cpu").warmup(
        max_buffer_seconds=6.0)
    assert ours == JStreamer(params, jcfg).warmup(max_buffer_seconds=6.0) == 4


def test_frame_assembler_two_phase_matches_serial_oracle():
    """plan()/windows()/apply() against a literal serial drain (decode then
    blend one window at a time) over random feature arrival, overlaps and
    final flushes; a deterministic stand-in decode, so equality is exact
    (after tests/test_streaming.py:308)."""
    rng = np.random.default_rng(21)

    def fake_decode(window):
        w = window @ np.linspace(0.1, 1.0, window.shape[1])[:, None]
        return np.repeat(w, 61, axis=1) * 0.01

    for trial in range(8):
        frame_len = int(rng.integers(6, 20))
        overlap = int(rng.integers(0, frame_len))
        cfg = Config(frame_size=frame_len, overlap=overlap, input_dim=5,
                     output_dim=61)
        total = int(rng.integers(1, 150))
        feats = rng.standard_normal((total, 5)).astype(np.float32)

        pending, emitted, consumed = None, [], 0

        def finalize(frames):
            if len(frames):
                out = np.array(frames, np.float64)
                out[:, :61] /= BLENDSHAPE_SCALE
                emitted.append(out)

        def serial_drain(n_feat, final):
            nonlocal pending, consumed
            while True:
                avail = n_feat - consumed
                if avail <= 0 or (avail < frame_len and not final):
                    break
                take = min(frame_len, avail)
                dec = fake_decode(pad_audio_chunk(
                    feats[consumed: consumed + take], frame_len, 5))[:take]
                merged = dec if pending is None else blend_chunks(
                    pending, dec, overlap)
                if final and take >= avail:
                    finalize(merged)
                    pending = None
                    consumed += take
                    break
                hold = min(overlap, len(merged))
                finalize(merged[: len(merged) - hold])
                pending = merged[len(merged) - hold:]
                consumed += take - hold

        asm = FrameAssembler(cfg)
        n_seen = 0
        while n_seen < total:
            n_seen = min(total, n_seen + int(rng.integers(1, 40)))
            asm.ingest(feats[:n_seen], base=0)
            plans = asm.plan(final=False)
            nxt = asm.plan_next(n_seen, final=False)
            assert nxt == (plans[0] if plans else None)
            if plans:
                asm.apply(plans, np.stack(
                    [fake_decode(w) for w in asm.windows(plans)]))
            serial_drain(n_seen, final=False)
        plans = asm.plan(final=True)
        if plans:
            asm.apply(plans, np.stack(
                [fake_decode(w) for w in asm.windows(plans)]))
        serial_drain(total, final=True)

        got = asm.pop_frames()
        want = np.concatenate(emitted) if emitted else np.zeros((0, 61))
        assert got.shape == want.shape, (trial, frame_len, overlap, total)
        np.testing.assert_array_equal(got, want)


def test_frame_assembler_shift_keeps_the_plan():
    """shift(m) renumbers buffer space: the plan moves by -m, and a
    finished stream releases a smooth session's held-back frame."""
    cfg = Config(frame_size=8, overlap=2, input_dim=3, output_dim=61)
    feats = np.random.default_rng(0).standard_normal((30, 3)).astype(
        np.float32)
    a, b = FrameAssembler(cfg, smooth=True), FrameAssembler(cfg, smooth=True)
    for asm in (a, b):
        asm.ingest(feats)
        plans = asm.plan(final=False)
        asm.apply(plans, np.zeros((len(plans), 8, 61)))
    b.shift(5)
    b.ingest(feats[5:], base=0)
    assert [p[0] + 5 for p in b.plan(final=True)] == [
        p[0] for p in a.plan(final=True)]
    before = a.frames_ready
    a.finish()
    assert a.frames_ready == before + 1

"""The port's HTTP server and the rest of its inference CLI, driven for real
on the CPU (after tests/test_server_and_infer_cli.py).

Geometry: hidden 32, 1 layer, 2 heads, fp32, frame_size 32, overlap 8
(tests/test_server_and_infer_cli.py's short chunks), seeded weights.
"""

import io
import json
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pandas as pd
import pytest
import torch

from neurosync_trainer_lite_tpu.utils.stats import (
    save_comparison_stats as j_save_stats,
)
from neurosync_trainer_lite_tpu_torch import infer as tinfer
from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.inference import multi_stream as M
from neurosync_trainer_lite_tpu_torch.inference.api import (
    generate_facial_data_from_bytes,
)
from neurosync_trainer_lite_tpu_torch.inference.server import (
    serve,
    warmup_handler,
)
from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq
from neurosync_trainer_lite_tpu_torch.training.checkpoint import (
    save_checkpoint,
    save_final_model,
)
from neurosync_trainer_lite_tpu_torch.training.step import init_train_state

GEOM = dict(hidden_dim=32, n_layers=1, num_heads=2, dropout=0.0,
            use_amp=False, frame_size=32, overlap=8)
GEOM_FLAGS = ["--hidden_dim", "32", "--n_layers", "1", "--num_heads", "2",
              "--frame_size", "32", "--overlap", "8", "--use_amp", "false",
              "--device", "cpu"]
TEST_WAV = "dataset/test_set/audio.wav"
GROUND_TRUTH = "dataset/test_set/testset.csv"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test files at once, one a worker process, on
    the host's cores: torch's own pool of a thread a core in each worker
    would oversubscribe them many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _wav_bytes(sr, seconds=1.5):
    t = np.arange(int(sr * seconds)) / sr
    y = (0.3 * np.sin(2 * np.pi * 200 * t)).astype(np.float32)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((y * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def cfg_model():
    cfg = Config(**GEOM)
    return cfg, init_seq2seq(cfg, torch.Generator().manual_seed(0),
                             device="cpu").eval()


@pytest.fixture
def server(cfg_model):
    """A factory of started servers on ephemeral ports, all shut down."""
    started = []

    def start(**kw):
        cfg, model = cfg_model
        httpd = serve(model, cfg, port=0, device="cpu", **kw)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        started.append(httpd)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"

        def post(path, data=b"", headers=None):
            req = urllib.request.Request(base + path, data=data,
                                         method="POST", headers=headers or {})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.load(r)

        def get(path):
            with urllib.request.urlopen(base + path, timeout=30) as r:
                return json.load(r)

        return post, get

    yield start
    for httpd in started:
        httpd.shutdown()
        httpd.server_close()


def _code(call, *args, **kw):
    try:
        call(*args, **kw)
    except urllib.error.HTTPError as e:
        return e.code
    except urllib.error.URLError:
        return "cut"    # the server closed the connection after refusing
    return 200


def test_http_server_roundtrip(cfg_model, server):
    """Health, a lazy /metrics, the batch endpoint equal to the API, a
    too-short clip, a bad body (400) and bad lengths (413), still alive."""
    cfg, model = cfg_model
    post, get = server()
    assert get("/healthz") == {"ok": True}
    assert get("/metrics") == {"live_sessions": 0, "streamer_started": False}

    wav = _wav_bytes(cfg.sr)
    payload = post("/audio_to_blendshapes", wav)
    frames = np.asarray(payload["blendshapes"])
    assert payload["fps"] == 60 and frames.shape[1] == cfg.output_dim
    assert 80 <= frames.shape[0] <= 100
    np.testing.assert_array_equal(
        frames, generate_facial_data_from_bytes(wav, model, cfg,
                                                device="cpu"))
    assert post("/audio_to_blendshapes",
                _wav_bytes(cfg.sr, 0.02))["blendshapes"] == []
    assert _code(post, "/audio_to_blendshapes", b"not audio") == 400
    for bad_len in (str(10 ** 12), "-1"):
        assert _code(post, "/audio_to_blendshapes", b"x",
                     {"Content-Length": bad_len}) in (413, "cut")
    assert get("/healthz")["ok"]
    assert _code(get, "/nowhere") == 404


def test_live_session_endpoints(cfg_model, server):
    """open → pushes return frames as they finalise → flush → close; the
    whole stream has the batch path's frame count and equals a
    MultiStreamer fed the same pushes; /metrics counts the traffic."""
    cfg, model = cfg_model
    post, get = server(max_sessions=2)
    sid = post("/session/open")["session"]
    audio = (np.random.default_rng(0).standard_normal(cfg.sr * 4) * 0.4
             ).astype(np.float32)
    ms = M.MultiStreamer(model, cfg, max_sessions=2, device="cpu")
    ref = ms.open()
    got, want, step = [], [], cfg.sr // 2
    for i in range(0, len(audio), step):
        r = post(f"/session/{sid}/audio", audio[i: i + step].tobytes())
        assert r["n"] == len(r["blendshapes"])
        got.extend(r["blendshapes"])
        ms.push_audio(ref, audio[i: i + step])
        ms.tick()
        want.append(ms.pop_frames(ref))
    got.extend(post(f"/session/{sid}/flush")["blendshapes"])
    ms.flush(ref)
    want.append(ms.pop_frames(ref))
    assert post(f"/session/{sid}/close") == {"ok": True}
    frames = np.asarray(got)
    t120 = (len(audio) + 2 * (1470 // 2)) // (1470 // 2) - 1
    assert frames.shape == (t120 // 2 + t120 % 2, cfg.output_dim)
    np.testing.assert_array_equal(frames, np.concatenate(want))

    sid2 = post("/session/open?smooth=1")["session"]
    pcm = (audio[:step] * 32768).clip(-32768, 32767).astype("<i2")
    assert post(f"/session/{sid2}/audio", pcm.tobytes(),
                {"X-Audio-Format": "s16"})["n"] >= 0
    sid3 = post("/session/open")["session"]
    assert _code(post, "/session/open") == 503        # both slots busy
    post(f"/session/{sid2}/close")
    post(f"/session/{sid3}/close")
    assert _code(post, "/session/99999/audio", b"\x00" * 8) == 404
    assert _code(post, f"/session/{sid}/rewind") == 404

    m = get("/metrics")
    assert m["streamer_started"] is True
    assert m["ticks"] > 0 and m["decode_ticks"] > 0
    assert m["frames_out"] >= frames.shape[0]
    assert m["tick_p50_ms"] is not None
    assert m["tick_p95_ms"] >= m["tick_p50_ms"]
    assert m["watchdog_flips"] == 0 and m["ring_recoveries"] == 0
    assert m["live_sessions"] == 0


def test_single_format_server_rejects_other_format(cfg_model, server):
    cfg, _ = cfg_model
    post, _ = server(max_sessions=2, audio_format="s16")
    sid = post("/session/open")["session"]
    pcm = (np.random.default_rng(0).standard_normal(cfg.sr) * 8000
           ).astype("<i2")
    assert post(f"/session/{sid}/audio", pcm.tobytes(),
                {"X-Audio-Format": "s16"})["n"] >= 0
    assert _code(post, f"/session/{sid}/audio",
                 np.zeros(100, "<f4").tobytes()) == 415
    post(f"/session/{sid}/flush")
    assert post(f"/session/{sid}/close") == {"ok": True}
    with pytest.raises(ValueError, match="audio_format"):
        serve(cfg_model[1], cfg, port=0, device="cpu", audio_format="wav")


def test_server_warmup_plumbs_its_flags(cfg_model, monkeypatch):
    """--serve_buckets / --background_warmup reach MultiStreamer.warmup
    (where they have nothing to defer)."""
    cfg, model = cfg_model
    seen = {}

    def fake_warmup(self, **kw):
        seen.update(kw)
        return 7

    monkeypatch.setattr(M.MultiStreamer, "warmup", fake_warmup)
    httpd = serve(model, cfg, port=0, max_sessions=4, serve_buckets=2,
                  background_warmup=True, device="cpu")
    try:
        assert warmup_handler(httpd) == 7
        assert seen == {"background_fallback": True, "serve_buckets": 2}
    finally:
        httpd.server_close()


def test_infer_cli_ground_truth_stats(cfg_model, tmp_path):
    """--ground-truth writes the comparison statistics, the JAX package's
    text for the same two CSVs (to --stats, else <out>_stats.txt)."""
    cfg, model = cfg_model
    pth = str(tmp_path / "model.pth")
    save_final_model(model, cfg, pth)
    out = str(tmp_path / "out.csv")
    common = ["--wav", TEST_WAV, "--model", pth, "--out", out,
              "--ground-truth", GROUND_TRUTH, *GEOM_FLAGS]
    tinfer.main(common + ["--stats", str(tmp_path / "stats.txt")])
    tinfer.main(common)
    j_save_stats(out, GROUND_TRUTH, str(tmp_path / "jax_stats.txt"))
    want = (tmp_path / "jax_stats.txt").read_text()
    assert "Overall Comparison Statistics" in want
    assert (tmp_path / "stats.txt").read_text() == want
    assert (tmp_path / "out_stats.txt").read_text() == want


def test_infer_cli_from_checkpoint_dir(cfg_model, tmp_path):
    """--model takes the port's training checkpoint directory and writes
    the .pth route's CSV; an Orbax-style directory (no state.pt) is
    refused by name."""
    cfg, model = cfg_model
    state = init_train_state(cfg, 4, device="cpu",
                             state_dict=model.state_dict())
    ckpt = str(tmp_path / "ckpt" / "checkpoint")
    save_checkpoint(state, 0, 1, cfg, ckpt)
    pth = str(tmp_path / "model.pth")
    save_final_model(model, cfg, pth)
    a, b = str(tmp_path / "pth.csv"), str(tmp_path / "dir.csv")
    tinfer.main(["--wav", TEST_WAV, "--model", pth, "--out", a, *GEOM_FLAGS])
    tinfer.main(["--wav", TEST_WAV, "--model", ckpt, "--out", b,
                 *GEOM_FLAGS])
    da, db = pd.read_csv(a), pd.read_csv(b)
    assert len(db) > 0 and db.shape[1] == 2 + 61
    np.testing.assert_array_equal(da.to_numpy(), db.to_numpy())

    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "meta.json").write_text(json.dumps({"epoch": 0}))
    with pytest.raises(FileNotFoundError, match="Orbax"):
        tinfer.main(["--wav", TEST_WAV, "--model", str(orbax), "--out",
                     str(tmp_path / "x.csv"), *GEOM_FLAGS])

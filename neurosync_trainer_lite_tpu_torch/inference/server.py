"""HTTP serving front end of the audio → blendshape path, standard library
only.

Port of neurosync_trainer_lite_tpu/inference/server.py:

    python -m neurosync_trainer_lite_tpu_torch.inference.server \\
        --model out/model.pth --port 8200 [--device cpu]

    POST /audio_to_blendshapes   body: audio bytes (WAV, or what ffmpeg reads)
        → {"blendshapes": [[...61 floats...], ...], "fps": 60}
    GET  /healthz                → {"ok": true}
    GET  /metrics                → MultiStreamer.metrics_snapshot(): ticks,
        decode_ticks, frames_out, watchdog_flips, ring_recoveries,
        live_sessions, tick_p50/p95/max_ms

Live sessions, K streams batched on the card each tick
(inference/multi_stream.py):

    POST /session/open           → {"session": id}   (?smooth=1 smooths)
    POST /session/<id>/audio     body: raw mono PCM at cfg.sr, float32 LE
        by default, 16-bit LE with the header `X-Audio-Format: s16`
        → {"blendshapes": [...], "n": k, "fps": 60}  (frames finalised now)
    POST /session/<id>/flush     → the remaining frames (ends the stream)
    POST /session/<id>/close     → {"ok": true}   (frees the slot)

A format the deployment does not accept (--audio_format) is refused with
415. Requests run one at a time (HTTPServer): the card would serialise
them anyway. Every /audio request runs one serving tick, which also
advances the other sessions' queued audio; their frames come back on their
own next request.

--device (default cuda) takes the place of the JAX server's --platform.
--model takes a reference-format model.pth or one of the port's own
training-checkpoint directories (training/checkpoint.py:load_model); the
JAX package's Orbax checkpoint directories are not readable here (use
its model.pth export). Nothing compiles in eager PyTorch, so
--background_warmup and --serve_buckets have nothing to defer: the flags
are kept and the whole warmup runs before serving starts.
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.inference.api import (
    generate_facial_data_from_bytes,
)
from neurosync_trainer_lite_tpu_torch.utils.device import check_model_device

#: refuse request bodies larger than this before reading them: an hour of
#: 88.2 kHz 16-bit mono WAV (~635 MB) fits with room to spare
MAX_BODY_BYTES = 1024 * 1024 * 1024


def make_handler(model, cfg: Config, *, max_sessions: int = 8,
                 fused_ticks: bool = True, push_seconds: float | None = None,
                 audio_format: str = "both", background_warmup: bool = False,
                 serve_buckets: int | None = None, device=None):
    """The request handler class over `model`, which must live on `device`
    (the CUDA card unless device="cpu")."""
    device = check_model_device(model, device)
    if audio_format not in ("both", "f32", "s16"):
        raise ValueError(
            f"audio_format={audio_format!r}: must be 'both', 'f32' or 's16'")
    accepted = ("f32", "s16") if audio_format == "both" else (audio_format,)

    state = {"ms": None}

    def get_streamer():
        if state["ms"] is None:  # lazy: a batch-only server never builds it
            from neurosync_trainer_lite_tpu_torch.inference.multi_stream import (
                MultiStreamer)
            state["ms"] = MultiStreamer(model, cfg,
                                        max_sessions=max_sessions,
                                        fused_decode=fused_ticks,
                                        push_seconds=push_seconds,
                                        push_formats=accepted, device=device)
        return state["ms"]

    class Handler(BaseHTTPRequestHandler):
        @staticmethod
        def warmup() -> int:
            """Run the live-session ticks once before serving
            (MultiStreamer.warmup, the accepted formats only)."""
            return get_streamer().warmup(
                background_fallback=background_warmup,
                serve_buckets=serve_buckets)

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                self._do_get()
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._send(400, {"error": str(e)})

        def _do_get(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/metrics":
                # without building the streamer: a batch-only server stays
                # lazy and reports that it has not started one
                ms = state["ms"]
                if ms is None:
                    self._send(200, {"live_sessions": 0,
                                     "streamer_started": False})
                else:
                    self._send(200, {"streamer_started": True,
                                     **ms.metrics_snapshot()})
            else:
                self._send(404, {"error": "unknown path"})

        def _read_body(self) -> bytes | None:
            length = int(self.headers.get("Content-Length", "0"))
            if length < 0 or length > MAX_BODY_BYTES:
                # a negative length would make rfile.read() block to EOF
                # and wedge the one-request-at-a-time server
                self._send(413, {"error": f"invalid body size ({length} "
                                 f"bytes; cap {MAX_BODY_BYTES})"})
                return None
            return self.rfile.read(length)

        def do_POST(self):
            try:
                if self.path == "/audio_to_blendshapes":
                    self._post_batch()
                elif self.path.startswith("/session"):
                    self._post_session()
                else:
                    self._send(404, {"error": "unknown path"})
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._send(400, {"error": str(e)})

        def _post_batch(self):
            audio_bytes = self._read_body()
            if audio_bytes is None:
                return
            frames = generate_facial_data_from_bytes(audio_bytes, model, cfg,
                                                     device=device)
            # a too-short clip keeps the reference's empty tuple signature
            frames = [] if isinstance(frames, tuple) else frames.tolist()
            self._send(200, {"blendshapes": frames, "fps": cfg.frame_rate})

        def _post_session(self):
            url = urlparse(self.path)
            parts = url.path.strip("/").split("/")
            ms = get_streamer()
            if parts == ["session", "open"]:
                if self._read_body() is None:
                    return
                smooth = parse_qs(url.query).get(
                    "smooth", ["0"])[0] in ("1", "true")
                try:
                    self._send(200, {"session": ms.open(smooth=smooth)})
                except RuntimeError as e:  # all slots busy
                    self._send(503, {"error": str(e)})
                return
            if len(parts) != 3 or not parts[1].isdigit():
                self._send(404, {"error": "unknown path"})
                return
            sid, verb = int(parts[1]), parts[2]
            if not ms.has_session(sid):
                self._send(404, {"error": f"no session {sid}"})
                return
            if verb == "audio":
                body = self._read_body()
                if body is None:
                    return
                fmt = self.headers.get("X-Audio-Format", "f32")
                if fmt not in accepted:
                    self._send(415, {
                        "error": f"audio format {fmt!r} not accepted by "
                                 f"this server (accepts: {accepted})"})
                    return
                # s16 stays int16: MultiStreamer uploads it raw
                samples = np.frombuffer(body, "<i2" if fmt == "s16"
                                        else "<f4")
                ms.push_audio(sid, samples)
                ms.tick()
                frames = ms.pop_frames(sid)
                self._send(200, {"blendshapes": frames.tolist(),
                                 "n": len(frames), "fps": cfg.frame_rate})
            elif verb == "flush":
                if self._read_body() is None:
                    return
                ms.flush(sid)
                frames = ms.pop_frames(sid)
                self._send(200, {"blendshapes": frames.tolist(),
                                 "n": len(frames), "fps": cfg.frame_rate})
            elif verb == "close":
                if self._read_body() is None:
                    return
                ms.close(sid)
                self._send(200, {"ok": True})
            else:
                self._send(404, {"error": "unknown path"})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve(model, cfg: Config, host: str = "127.0.0.1", port: int = 8200,
          *, server_class=HTTPServer, max_sessions: int = 8,
          fused_ticks: bool = True, push_seconds: float | None = None,
          audio_format: str = "both", background_warmup: bool = False,
          serve_buckets: int | None = None, device=None):
    """A bound server (port 0: an ephemeral one); call serve_forever()."""
    return server_class((host, port),
                        make_handler(model, cfg, max_sessions=max_sessions,
                                     fused_ticks=fused_ticks,
                                     push_seconds=push_seconds,
                                     audio_format=audio_format,
                                     background_warmup=background_warmup,
                                     serve_buckets=serve_buckets,
                                     device=device))


def warmup_handler(httpd) -> int:
    """Run the live-session ticks once before accepting traffic; returns
    the number of runs."""
    return httpd.RequestHandlerClass.warmup()


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="neurosync_trainer_lite_tpu_torch.inference.server")
    parser.add_argument("--model", default="out/model.pth",
                        help="model.pth, or a training checkpoint directory "
                             "of this package (not an Orbax directory)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8200)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--max_sessions", type=int, default=8)
    parser.add_argument("--background_warmup", action="store_true",
                        help="kept for the JAX server's command line: "
                             "nothing compiles here, so nothing is deferred")
    parser.add_argument("--serve_buckets", type=int, default=4,
                        help="kept for the JAX server's command line (0: "
                             "none): nothing compiles here, so the whole "
                             "warmup runs before serving")
    parser.add_argument("--no_warmup", action="store_true",
                        help="skip the startup warmup (kernel build and one "
                             "run of each tick)")
    parser.add_argument("--two_dispatch_ticks", action="store_true",
                        help="feature-window download + a separate batched "
                             "decode (several windows a session a tick)")
    parser.add_argument("--audio_format", default="both",
                        choices=("both", "f32", "s16"),
                        help="push format(s) accepted (X-Audio-Format); "
                             "another is refused with 415")
    parser.add_argument("--push_capacity_s", type=float, default=None,
                        help="seconds of audio a session takes a tick "
                             "(default ≈1.5)")
    args = parser.parse_args(argv)

    from neurosync_trainer_lite_tpu_torch.training.checkpoint import load_model

    # "cuda" is the default: resolved to the card, and raising without one
    device = None if args.device == "cuda" else args.device
    cfg = Config()
    model = load_model(args.model, cfg, device=device)
    httpd = serve(model, cfg, args.host, args.port,
                  max_sessions=args.max_sessions,
                  fused_ticks=not args.two_dispatch_ticks,
                  push_seconds=args.push_capacity_s,
                  audio_format=args.audio_format,
                  background_warmup=args.background_warmup,
                  serve_buckets=args.serve_buckets or None, device=device)
    if not args.no_warmup:
        print("warming up the live-session ticks (kernel build, one run of "
              "each)…")
        print(f"warmed {warmup_handler(httpd)} runs")
    print(f"serving audio→blendshapes on http://{args.host}:{args.port}")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()

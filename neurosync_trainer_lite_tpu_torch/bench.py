"""Headline benchmark of the PyTorch port: 228M-model training samples/s on
one card (the port's counterpart of the repo root's bench.py, which drives
the JAX package).

    python -m neurosync_trainer_lite_tpu_torch.bench
    python -m neurosync_trainer_lite_tpu_torch.bench --mode infer|stream|frontend
    python -m neurosync_trainer_lite_tpu_torch.bench --device cpu --tiny

Measures the bf16 training step (forward + backward + Adam update,
global-norm clip 2.0) of the flagship 8+8-layer/16-head/hidden-1024 model at
the reference's production geometry: batch 128 windows x 128 frames x 256
features → 61 blendshapes (reference: config.py:30-35). Runs on the CUDA
card unless --device names another device; without a card and without
--device it raises. --tiny takes config.tiny_config's geometry (the CPU
tests' size).

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline"}.
The train mode prints its dropout-0 line first, on stderr, and which remat
plan each configuration got, on stderr too.

The timed loops read the clock after one host read of the last loss
(`.item()`): the step itself reads nothing on the host (its clip factor
and its dropout seeds stay off the card's queue), so 20 unsynchronised
steps queue back to back and the one read waits for all of them.

Baseline: the reference publishes no numbers (BASELINE.md). The comparison
point is the root bench.py's estimate of the reference's single-process
4-GPU replicated-DP fp16 throughput, ~550 samples/s.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from neurosync_trainer_lite_tpu_torch.config import Config, full_config, tiny_config
from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device

REFERENCE_4GPU_SAMPLES_PER_SEC = 550.0
#: warm-up steps, timed steps of _measure_train
TRAIN_WARMUP, TRAIN_TIMED = 3, 20
#: the timed request's seconds of seeded audio (bench_inference)
REQUEST_SECONDS = 30
#: bench_stream: sessions, seconds a push, seconds of audio a session
STREAM_SESSIONS, STREAM_PUSH_S, STREAM_SECONDS = 4, 0.5, 20
#: bench_frontend: sample rate and seconds of int16 PCM
FRONTEND_SR, FRONTEND_SECONDS = 88200, 60


def seeded_model(cfg: Config, device: torch.device):
    """The serving modes' model: seeded random weights, eval mode."""
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq

    return init_seq2seq(cfg, torch.Generator(device).manual_seed(0),
                        device=device).eval()


def seeded_wav(cfg: Config, seconds: int = REQUEST_SECONDS) -> bytes:
    """The timed request: `seconds` of seeded noise as a 16-bit PCM WAV
    (the capture format)."""
    from neurosync_trainer_lite_tpu_torch.utils.audio_io import audio_to_bytes

    rng = np.random.default_rng(0)
    audio = rng.standard_normal(cfg.sr * seconds).astype(np.float32) * 0.3
    return audio_to_bytes(audio, cfg.sr)


def bench_inference(cfg: Config | None = None, device=None) -> dict:
    """--mode infer: wav-bytes→blendshape frames/sec through the serving API
    (BASELINE config #5): int16 WAV upload + the device pipeline (frontend
    + batched chunked decode on the card, overlap blend on the host —
    inference/device_pipeline.py). One warm request, then one timed
    request. Baseline = 60 fps real-time."""
    from neurosync_trainer_lite_tpu_torch.inference.api import (
        generate_facial_data_from_bytes,
    )

    cfg = Config(dropout=0.0) if cfg is None else cfg
    device = resolve_device(device)
    model = seeded_model(cfg, device)
    wav = seeded_wav(cfg)

    generate_facial_data_from_bytes(wav, model, cfg, device=device)  # warm
    t0 = time.perf_counter()
    # the frames come back to the host: the call ends synchronised
    out = generate_facial_data_from_bytes(wav, model, cfg, device=device)
    dt = time.perf_counter() - t0
    fps = len(out) / dt
    return _emit({
        "metric": "audio_to_blendshape_frames_per_sec",
        "value": round(fps, 1), "unit": "frames/s",
        "vs_baseline": round(fps / 60.0, 2),  # 60 fps = real-time
    })


def bench_stream(cfg: Config | None = None, device=None) -> dict:
    """--mode stream: K=4 concurrent live sessions through MultiStreamer
    (BASELINE config #5: real-time 60 fps streaming), int16 pushes at 0.5 s
    cadence, one tick a round. Baseline = the 500 ms per-push latency
    budget; vs_baseline is budget/p95 (>1 means every push cadence is met
    with headroom)."""
    from neurosync_trainer_lite_tpu_torch.inference.multi_stream import (
        MultiStreamer,
    )

    cfg = Config(dropout=0.0) if cfg is None else cfg
    device = resolve_device(device)
    model = seeded_model(cfg, device)
    rng = np.random.default_rng(0)
    K, push_s, seconds = STREAM_SESSIONS, STREAM_PUSH_S, STREAM_SECONDS
    push = int(cfg.sr * push_s)

    ms = MultiStreamer(model, cfg, max_sessions=K, device=device)
    ms.warmup()
    audios = [(rng.standard_normal(cfg.sr * seconds) * 8000).astype(np.int16)
              for _ in range(K)]
    sids = [ms.open() for _ in range(K)]
    lat = []
    for r in range(int(seconds / push_s)):
        t0 = time.perf_counter()
        for sid, a in zip(sids, audios):
            ms.push_audio(sid, a[r * push:(r + 1) * push])
        ms.tick()   # a decode tick downloads its frames: synced
        lat.append(time.perf_counter() - t0)
    for sid in sids:
        ms.flush(sid)
        if ms.pop_frames(sid).shape[0] == 0:
            raise RuntimeError(f"live session {sid} produced no frames")
        ms.close(sid)
    p95 = float(np.percentile(np.array(lat) * 1e3, 95))
    return _emit({
        "metric": f"live_stream_tick_p95_ms_k{K}",
        "value": round(p95, 1), "unit": "ms",
        "vs_baseline": round(500.0 / p95, 2),  # 500 ms push budget
    })


def bench_frontend(cfg: Config | None = None, device=None) -> dict:
    """--mode frontend: device feature-extraction throughput in audio-seconds
    processed per second (BASELINE config #3's hot half). Input is int16 PCM
    (the capture format), uploaded raw and widened/normalized on the device
    (half the transfer bytes of fp32; see ops/frontend.py). The features'
    download ends the timed call."""
    from neurosync_trainer_lite_tpu_torch.ops.frontend import (
        extract_audio_features,
    )

    device = resolve_device(device)
    sr = FRONTEND_SR if cfg is None else cfg.sr
    seconds = FRONTEND_SECONDS
    y = (np.random.default_rng(0).standard_normal(sr * seconds) * 12000
         ).astype(np.int16)
    feats, _ = extract_audio_features(y, sr, device=device)  # warm
    t0 = time.perf_counter()
    feats, _ = extract_audio_features(y, sr, device=device)
    dt = time.perf_counter() - t0   # numpy features: synced
    return _emit({
        "metric": "frontend_audio_seconds_per_sec",
        "value": round(seconds / dt, 1), "unit": "audio_s/s",
        "vs_baseline": round((seconds / dt) / 1.0, 2),  # 1x = real-time
    })


def train_batch(cfg: Config, device: torch.device):
    """The timed batch: seeded standard normals src [B, T, input_dim] and
    trg [B, T, output_dim], drawn from one generator on the device."""
    gen = torch.Generator(device).manual_seed(0)
    B, T = cfg.batch_size, cfg.micro_batch_size
    src = torch.randn(B, T, cfg.input_dim, generator=gen, device=device)
    trg = torch.randn(B, T, cfg.output_dim, generator=gen, device=device)
    return src, trg


def _measure_train(cfg: Config, n_steps: int = TRAIN_TIMED, *, device=None,
                   state_dict=None, losses: list | None = None) -> float:
    """samples/s of the train step at cfg's geometry: TRAIN_WARMUP steps,
    then n_steps timed steps, the clock read after the last loss's
    `.item()`. Step i's dropout generator is training/loop.py's
    step_generator(0, i), as the JAX bench folds i into one key.

    state_dict: start from these weights instead of the seeded init;
    losses: a list that receives every step's loss tensor (no sync)."""
    from neurosync_trainer_lite_tpu_torch.training.loop import step_generator
    from neurosync_trainer_lite_tpu_torch.training.step import (
        init_train_state,
        make_train_step,
    )

    device = resolve_device(device)
    B = cfg.batch_size
    generator = (None if state_dict is not None
                 else torch.Generator(device).manual_seed(0))
    state = init_train_state(cfg, 100, generator=generator, device=device,
                             state_dict=state_dict)
    train_step = make_train_step(cfg)
    src, trg = train_batch(cfg, device)

    def run(n):
        loss = None
        for i in range(n):
            _, loss, _ = train_step(state, src, trg, step_generator(0, i))
            if losses is not None:
                losses.append(loss)
        return loss

    run(TRAIN_WARMUP).item()
    t0 = time.perf_counter()
    run(n_steps).item()
    return n_steps * B / (time.perf_counter() - t0)


def main(cfg: Config | None = None, device=None) -> list[dict]:
    """--mode train (the default): THE headline measures the reference's
    training configuration, dropout 0.3 (reference config.py:33), batch 128
    x 128 frames, the full fwd+bwd+Adam step, remat as the port's memory
    planner decides (training/loop.py:_maybe_auto_remat). The dropout-0
    line goes first, to stderr; the headline last, on stdout. Returns
    both records, dropout 0 first."""
    from neurosync_trainer_lite_tpu_torch.training.loop import _maybe_auto_remat

    base = full_config() if cfg is None else cfg
    device = resolve_device(device)
    records = []
    for rate, where in ((0.0, sys.stderr), (base.dropout, sys.stdout)):
        c = _maybe_auto_remat(base.replace(dropout=rate), 1, verbose=False,
                              device=device)
        print(f"remat plan at dropout {rate}: remat={c.remat}, scope "
              f"{c.remat_scope!r}, layers {c.remat_layers}, policy "
              f"{c.remat_policy!r}", file=sys.stderr, flush=True)
        sps = _measure_train(c, device=device)
        records.append(_emit({
            "metric": f"228M_train_samples_per_sec_per_chip_dropout{rate:g}",
            "value": round(sps, 2), "unit": "samples/s",
            "vs_baseline": round(sps / REFERENCE_4GPU_SAMPLES_PER_SEC, 3),
        }, where))
    return records


def _emit(record: dict, file=None) -> dict:
    print(json.dumps(record), file=file or sys.stdout, flush=True)
    return record


MODES = {"train": main, "infer": bench_inference,
         "frontend": bench_frontend, "stream": bench_stream}


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", default="train", choices=tuple(MODES))
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; raises "
                        "without one)")
    p.add_argument("--tiny", action="store_true",
                   help="config.tiny_config's geometry (CPU smoke runs)")
    args = p.parse_args(argv)
    MODES[args.mode](tiny_config(dropout=Config().dropout) if args.tiny
                     else None, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a), the CUDA toolkit (nvcc) and PyTorch built
for CUDA; imports nothing of JAX. Every phase must pass, else the script
exits non-zero before its result line.

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from neurosync_trainer_lite_tpu_torch/csrc, one
   nvcc per source, in parallel, and prints the build time.
3. Checks two rounding contracts of ops/attention.py on the card: the bf16
   batched products (_matmul_round_once) equal the fp32 product rounded
   once to bf16 at the serving and training attention shapes, and
   _linear's bf16 gradients (torch.mm with an fp32 output has no
   derivative, so _linear is an autograd Function) equal autograd of the
   widened-operand formula, to one bf16 rounding.
4. Holds each kernel against its plain PyTorch version on the card: K1
   forward and transpose, bf16 and fp32, global and head-tiled tables
   (bitwise), and the K4 forward in bf16 (one bf16 ulp) and fp32, at the
   serving shape [17, 128, 1024] (the 30 s request's 17 chunks) and the
   training shape [128, 128, 1024]; the K4 backward at the training shape
   in bf16 and fp32 (the forward's bound plus 1e-4 of the largest
   gradient).
5. Times each kernel and its plain version (median of CUDA graph replays,
   so host launch overhead is excluded) beside the least time the card
   could take for the same work: K1 and the K4 forward at the serving
   shape, the K4 backward at the training shape.
6. Reproduces the reference goldens on the card in fp32 with TF32 off:
   tests/fixtures/reference_tiny forward (2e-5), chunked decode
   (2e-6 / 1e-4) and the reference loss (rel 1e-5).
7. Serves the full-width 228M model (Config(): hidden 1024, 8+8 layers,
   16 heads, bf16) on seeded random weights from WAV bytes:
   dataset/test_set/audio.wav and a 30 s seeded int16 WAV, at
   attention_impl 'auto' and 'pallas'. Checks the shape [T, 61], finite
   values, the kernel launch counts of one forward (K1 = 50 at 'auto';
   K1 = 2 and K4 = 24 at 'pallas') and that the two impls agree within
   5% of the output's largest magnitude (bf16 roundings at other places
   over 16 layers). Prints the 30 s request's frames/s (median and
   quartiles of 11), its stages, and the card's busy share and top kernels
   from torch.profiler.
8. Trains the full-width model (batch 128 windows x 128 frames, seeded
   random features and targets, the same seeded weights) at (a) Config():
   'auto', dropout 0.3, and (b) 'pallas', dropout 0, which runs the K4
   forward and backward. Checks a finite loss and grad norm at every step,
   the fixed batch's loss (dropout off) lower after the steps than before,
   and the kernel launch counts of one step (K1 = 100 at (a); K1 = 52, K4
   forward = 24, K4 backward = 24 at (b)). Prints samples/s (median and
   quartiles of 10 steps after 3 warm-up steps), peak device memory, and
   the card's busy share and top kernels of one profiled step. Then K4's
   gradients inside the model: one step at dropout 0 at 'auto' and at
   'pallas' from the same weights and batch agree within 1e-3 in loss and
   1e-2 in the pre-clip grad norm, and no attention q/k/v weight gradient
   at 'pallas' lies further from the fp32 step than at 'auto' by more than
   EXCESS_LIMIT (k4_gradients_in_model); a K4 backward with a planted
   fault (head 0's dq lost) must exceed that limit.

The line before the last holds the card's name and power limit; the line
before that the kernels' JSON record (launches: the sum over the main path
runs, the serving run and one training step at each configuration, each
counted from zero; launches_by_path: each run's own count); the last line
the result.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
SERVE_SECONDS = 30             # the timed request: a seeded int16 WAV
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
EXCESS_LIMIT = 0.05            # k4_gradients_in_model


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"ok: {what}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Median device time of one call: `iters` calls captured in a CUDA
    graph and replayed between two events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def eager_ms(fn, iters: int = 50) -> float:
    """Wall time of one eager call, launch overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def serving_shape() -> tuple[int, int, int, int]:
    """(B, T, H, heads) the 30 s request gives the kernels: B its chunk
    count (the decode batch), T the chunk length, H the hidden width."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.inference.chunked import chunk_plan
    from neurosync_trainer_lite_tpu_torch.ops.frontend import num_frames_60

    cfg = Config()
    frames = num_frames_60(cfg.sr * SERVE_SECONDS, int(0.01667 * cfg.sr))
    starts, _, remaining = chunk_plan(frames, cfg.frame_size, cfg.overlap)
    return (len(starts) + (remaining > 0), cfg.frame_size, cfg.hidden_dim,
            cfg.num_heads)


def print_ptxas_summary(log: str) -> None:
    """One line per compiled kernel: registers and spills (nvcc -Xptxas -v)."""
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = f"{m.group(1)}/{m.group(2)} bytes spill stores/loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            short = re.sub(r"^.*?\d+(rope_rows|attn_fwd_kernel|attn_bwd_kernel)",
                           r"\1", name)
            print(f"ptxas: {short[:48]}: {m.group(1)} registers, {spills}",
                  flush=True)
            name = None


def rounding_contracts(torch):
    """Phase 3: the bf16 rounding contracts of ops/attention.py on the card."""
    from neurosync_trainer_lite_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16 = torch.bfloat16

    def held(out, ref, what):
        # one rounding of the same fp32 value: equal, or the neighbouring
        # bf16 value (one ulp, at most 2^-7 of the value) where the fp32
        # sums, taken in another order, straddle a rounding boundary; where
        # the sum cancels, the fp32 rounding of its terms (1e-5 of the
        # largest value) decides. The tensor cores' fp32 accumulation is not
        # IEEE round-to-nearest, so over 16,384 terms about 1% of the
        # elements straddle; partial sums kept in bf16 (a reduced-precision
        # reduction) would move most elements, by more than one ulp.
        ref = ref.float()
        diff = (out.float() - ref).abs()
        limit = 2.0 ** -7 * ref.abs() + 1e-5 * ref.abs().max()
        ulps = bool((diff <= limit).all())
        share = (diff > 0).float().mean().item()
        check(ulps and share < 0.05,
              f"{what}: within one bf16 rounding of the fp32 product "
              f"rounded once ({share:.2e} of the elements differ, max abs "
              f"diff {diff.max().item():.3e}, max|ref| "
              f"{ref.abs().max().item():.3e})")

    serving = serving_shape()[0]
    for batch in (serving, 128):
        q, k, v, do = (torch.randn(batch, 16, 128, 64, device="cuda",
                                   generator=gen).to(bf16) for _ in range(4))
        p = torch.softmax(torch.randn(batch, 16, 128, 128, device="cuda",
                                      generator=gen), -1).to(bf16)
        products = {"q·kᵀ": (q, k.transpose(-1, -2)), "p·v": (p, v)}
        if batch == 128:   # the lean core's backward products
            products.update({"pᵀ·do": (p.transpose(-1, -2), do),
                             "do·vᵀ": (do, v.transpose(-1, -2)),
                             "ds·k": (p, k), "dsᵀ·q": (p.transpose(-1, -2), q)})
        for name, (a, b) in products.items():
            held(attn._matmul_round_once(a, b),
                 torch.matmul(a.float(), b.float()).to(bf16),
                 f"_matmul_round_once {name} at batch {batch}")

    x = torch.randn(128 * 128, 1024, device="cuda", generator=gen).to(bf16)
    w = torch.randn(1024, 1024, device="cuda", generator=gen) * 0.02
    try:
        torch.mm(x.requires_grad_(True), w.to(bf16).t(),
                 out_dtype=torch.float32).sum().backward()
        print("torch.mm(..., out_dtype=float32) has a derivative here",
              flush=True)
    except RuntimeError as err:
        print(f"torch.mm(..., out_dtype=float32) has no derivative here "
              f"({str(err).splitlines()[0][:100]}): _linear is an autograd "
              f"Function", flush=True)
    b = torch.randn(1024, device="cuda", generator=gen)
    dy = torch.randn(128 * 128, 1024, device="cuda", generator=gen).to(bf16)
    ours = [t.detach().clone().requires_grad_(True) for t in (x, w, b)]
    attn._linear(*ours).backward(dy)
    ref = [t.detach().clone().requires_grad_(True) for t in (x, w, b)]
    ((ref[0].float() @ ref[1].to(bf16).float().t() + ref[2]).to(bf16)
     ).backward(dy)
    held(ours[0].grad, ref[0].grad, "_linear dx [16384, 1024]")
    held(ours[1].grad, ref[1].grad, "_linear dw [1024, 1024] (bf16, widened)")
    e = (ours[2].grad - ref[2].grad).abs().max().item()
    check(e <= 1e-5 * ref[2].grad.abs().max().item(),
          f"_linear db summed in fp32 (max abs diff {e:.3e})")


def kernel_checks(torch, records):
    """Phases 4 and 5: each kernel against its plain version, then timed."""
    from neurosync_trainer_lite_tpu_torch.ops import fused_attention as fua
    from neurosync_trainer_lite_tpu_torch.ops import rope_kernel as rk
    from neurosync_trainer_lite_tpu_torch.ops.rope import rope_tables

    from neurosync_trainer_lite_tpu_torch.config import Config

    B, T, H, n = serving_shape()
    hd = H // n
    gen = torch.Generator(device="cuda").manual_seed(1)
    err = {"rope_rotate": 0.0, "fused_rope_attention": 0.0}
    table_sets = {"global": rope_tables(T, H, "cuda"),
                  "tiled": rope_tables(T, hd, "cuda", tile=n)}
    # the serving batch (the 30 s request's chunks) and the training batch
    for batch in (B, Config().batch_size):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(batch, T, H, device="cuda",
                            generator=gen).to(dtype)
            for kind, tables in table_sets.items():
                for transpose in (False, True):
                    out = rk.rope_rotate_cuda(x, *tables, transpose=transpose)
                    torch.cuda.synchronize()
                    ref = rk.rope_rotate_plain(x, *tables, transpose=transpose)
                    e = (out.float() - ref.float()).abs().max().item()
                    err["rope_rotate"] = max(err["rope_rotate"], e)
                    check(torch.equal(out, ref),
                          f"K1 rope_rotate [{batch}, {T}, {H}] {dtype} {kind} "
                          f"transpose={transpose} bitwise equal to the plain "
                          f"version (max abs err {e})")

            q, k, v = (torch.randn(batch, T, H, device="cuda", generator=gen)
                       .to(dtype) for _ in range(3))
            tables = fua.make_tables(T, T, hd, n, "cuda")
            with torch.no_grad():
                out = fua.fused_rope_attention_cuda(q, k, v, tables, n,
                                                    hd ** -0.5)
                torch.cuda.synchronize()
                ref = fua.fused_rope_attention_plain(q, k, v, tables, n,
                                                     hd ** -0.5)
            diff = (out.float() - ref.float()).abs()
            # bf16: one bf16 rounding apart at most (2^-7 relative); fp32:
            # the same fp32 math summed in another order
            rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
            limit = rel * ref.float().abs() + 1e-6
            e = diff.max().item()
            err["fused_rope_attention"] = max(err["fused_rope_attention"], e)
            check(bool((diff <= limit).all()),
                  f"K4 fused_rope_attention [{batch}, {T}, {H}] {dtype} "
                  f"within {rel:g}·|plain| + 1e-6 of the plain version (max "
                  f"abs err {e})")
            del x, q, k, v, out, ref, diff, limit

    # timing at the serving shape in bf16, the serving dtype
    x = torch.randn(B, T, H, device="cuda", generator=gen).to(torch.bfloat16)
    tiled = table_sets["tiled"]
    item = x.element_size()
    with torch.no_grad():
        k1 = dict(ms=device_ms(lambda: rk.rope_rotate_cuda(x, *tiled)),
                  plain_ms=device_ms(lambda: rk.rope_rotate_plain(x, *tiled)),
                  eager_ms=eager_ms(lambda: rk.rope_rotate_cuda(x, *tiled)))
        b_ms, b_by = bound(2 * x.numel() * item + 3 * T * H * 4, 5 * x.numel())
        k1.update(bound_ms=b_ms, bound_by=b_by)

        q, k, v = (torch.randn(B, T, H, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        tables = fua.make_tables(T, T, hd, n, "cuda")
        k4 = dict(
            ms=device_ms(lambda: fua.fused_rope_attention_cuda(
                q, k, v, tables, n, hd ** -0.5)),
            plain_ms=device_ms(lambda: fua.fused_rope_attention_plain(
                q, k, v, tables, n, hd ** -0.5)),
            eager_ms=eager_ms(lambda: fua.fused_rope_attention_cuda(
                q, k, v, tables, n, hd ** -0.5)))
        # rotations (5 flops per element of q and k), q·kᵀ and p·v
        # (2·T·T·H each), softmax (~5 per score)
        flops = (10 * B * T * H + 4 * B * T * T * H + 5 * B * n * T * T)
        b_ms, b_by = bound(4 * B * T * H * item + 6 * T * H * 4, flops)
        k4.update(bound_ms=b_ms, bound_by=b_by)

    records["rope_rotate"].update(k1, max_abs_err=err["rope_rotate"],
                                  shape=[B, T, H])
    records["fused_rope_attention"].update(
        k4, max_abs_err=err["fused_rope_attention"], shape=[B, T, H])
    records["fused_rope_attention_bwd"].update(k4_backward(torch, gen))
    for name, r in records.items():
        print(f"time {name} at {r['shape']} bf16: {r['ms']:.6f} ms on the "
              f"card (CUDA graph), {r['eager_ms']:.6f} ms eager, plain "
              f"{r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']})", flush=True)


def k4_backward(torch, gen):
    """The K4 backward at the training shape: against its plain version in
    bf16 and fp32, then timed in bf16."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.ops import fused_attention as fua

    cfg = Config()
    B, T, H, n = cfg.batch_size, cfg.micro_batch_size, cfg.hidden_dim, \
        cfg.num_heads
    hd, scale = H // n, (H // n) ** -0.5
    tables = fua.make_tables(T, T, hd, n, "cuda")
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.randn(B, T, H, device="cuda", generator=gen)
                       .to(dtype) for _ in range(4))
        out = fua.fused_rope_attention_bwd_cuda(q, k, v, do, tables, n, scale)
        torch.cuda.synchronize()
        ref = fua.fused_rope_attention_bwd_plain(q, k, v, do, tables, n,
                                                 scale)
        # the forward's bound, plus 1e-4 of the largest gradient: ds =
        # p·(dp − D) cancels, so a small element carries the fp32 rounding
        # of the terms it sums (about T·2^-24 of the largest)
        rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        for name, a, b in zip(("dq", "dk", "dv"), out, ref):
            diff = (a.float() - b.float()).abs()
            limit = rel * b.float().abs() + 1e-4 * b.float().abs().max()
            e = diff.max().item()
            worst = max(worst, e)
            check(a.dtype == dtype and bool((diff <= limit).all()),
                  f"K4 backward {name} {dtype} within {rel:g}·|plain| + "
                  f"1e-4·max|plain| of the plain version (max abs err {e}, "
                  f"max|plain| {b.float().abs().max().item():.4f})")
        again = fua.fused_rope_attention_bwd_cuda(q, k, v, do, tables, n,
                                                  scale)
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"K4 backward {dtype} bitwise repeatable")
        del q, k, v, do, out, ref, again

    q, k, v, do = (torch.randn(B, T, H, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    rec = dict(
        ms=device_ms(lambda: fua.fused_rope_attention_bwd_cuda(
            q, k, v, do, tables, n, scale), iters=5),
        plain_ms=device_ms(lambda: fua.fused_rope_attention_bwd_plain(
            q, k, v, do, tables, n, scale), iters=5),
        eager_ms=eager_ms(lambda: fua.fused_rope_attention_bwd_cuda(
            q, k, v, do, tables, n, scale), iters=10))
    # five T·T·hd products per head (2 flops each), the rotation of q and k
    # and the transpose rotation of dq and dk (5 flops per element each),
    # softmax, D and ds (~10 per score); q, k, v, dO read, dq, dk, dv
    # written once, six fp32 tables
    flops = 10 * B * T * T * H + 20 * B * T * H + 10 * B * n * T * T
    b_ms, b_by = bound(7 * B * T * H * 2 + 6 * T * H * 4, flops)
    rec.update(bound_ms=b_ms, bound_by=b_by, max_abs_err=worst,
               shape=[B, T, H])
    return rec


def reference_goldens(torch, np):
    """Phase 6: the reference implementation's own outputs, on the card."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.inference.chunked import (
        process_audio_features)
    from neurosync_trainer_lite_tpu_torch.models.loss import loss_fn
    from neurosync_trainer_lite_tpu_torch.utils.weights import load_model

    fixture = REPO / "tests" / "fixtures" / "reference_tiny"
    geometry = json.loads((fixture / "meta.json").read_text())["geometry"]
    goldens = np.load(fixture / "goldens.npz")
    for impl in ("auto", "pallas"):
        cfg = Config(**geometry, use_amp=False, attention_impl=impl)
        model = load_model(str(fixture / "model.pth"), cfg, device="cuda")
        with torch.no_grad():
            out = model(torch.from_numpy(goldens["src"]).cuda()).cpu().numpy()
        e = float(np.abs(out - goldens["fwd_out"]).max())
        check(np.allclose(out, goldens["fwd_out"], atol=2e-5, rtol=2e-5),
              f"reference forward on the card at '{impl}' within 2e-5 "
              f"(max abs err {e})")
        ours = process_audio_features(goldens["feats"].copy(), model, cfg)
        e = float(np.abs(ours - goldens["chunked_out"]).max())
        check(ours.shape == goldens["chunked_out"].shape and np.allclose(
            ours, goldens["chunked_out"], atol=2e-6, rtol=1e-4),
            f"reference chunked decode on the card at '{impl}' within "
            f"2e-6/1e-4 (max abs err {e})")
    loss = float(loss_fn(torch.from_numpy(goldens["fwd_out"]).cuda(),
                         torch.from_numpy(goldens["trg"]).cuda()))
    want = float(goldens["loss"])
    check(abs(loss - want) <= 1e-5 * abs(want),
          f"reference loss on the card within rel 1e-5 ({loss} vs {want})")


def serve(torch, np):
    """Phase 7: the full-width model from WAV bytes at 'auto' and 'pallas'."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.inference.api import (
        generate_facial_data_from_bytes)
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import (
        Seq2Seq, init_seq2seq)
    from neurosync_trainer_lite_tpu_torch.ops import kernels
    from neurosync_trainer_lite_tpu_torch.utils.audio_io import audio_to_bytes

    cfg = Config(dropout=0.0)
    models = {"auto": init_seq2seq(cfg, torch.Generator(device="cuda")
                                   .manual_seed(0), device="cuda").eval()}
    models["pallas"] = Seq2Seq(cfg.replace(attention_impl="pallas"), "cuda")
    models["pallas"].load_state_dict(models["auto"].state_dict())
    models["pallas"].eval()
    n_params = sum(p.numel() for p in models["auto"].parameters())
    print(f"model: {n_params} parameters, hidden {cfg.hidden_dim}, "
          f"{cfg.n_layers}+{cfg.n_layers} layers, {cfg.num_heads} heads, "
          f"bf16 over fp32", flush=True)

    rng = np.random.default_rng(0)
    clips = {
        "test_set/audio.wav": (REPO / "dataset" / "test_set"
                               / "audio.wav").read_bytes(),
        "30 s seeded": audio_to_bytes(   # as bench.py --mode infer
            rng.standard_normal(cfg.sr * SERVE_SECONDS).astype(np.float32)
            * 0.3, cfg.sr),
    }
    expected = {"auto": {"rope_rotate": 50},
                "pallas": {"rope_rotate": 2, "fused_rope_attention": 24}}
    for impl, model in models.items():     # warm-up: cuBLAS, constants
        generate_facial_data_from_bytes(clips["30 s seeded"], model, cfg)
    torch.cuda.synchronize()

    # the main path run: one 30 s request per impl, counts from zero
    kernels.reset_launches()
    launches, outputs = {}, {}
    for impl, model in models.items():
        before = dict(kernels.LAUNCHES)
        out = generate_facial_data_from_bytes(clips["30 s seeded"], model, cfg)
        launches[impl] = {name: count - before.get(name, 0)
                          for name, count in kernels.LAUNCHES.items()
                          if count - before.get(name, 0)}
        outputs[("30 s seeded", impl)] = out
    main_path = dict(kernels.LAUNCHES)
    for impl in models:
        check(launches[impl] == expected[impl],
              f"kernel launches of one forward at '{impl}': "
              f"{launches[impl]} == {expected[impl]}")
    check(all(main_path.get(name, 0) > 0
              for name in ("rope_rotate", "fused_rope_attention")),
          f"every kernel of the path ran in the main path run: {main_path}")

    outputs.update({("test_set/audio.wav", impl): generate_facial_data_from_bytes(
        clips["test_set/audio.wav"], model, cfg)
        for impl, model in models.items()})
    for (clip, impl), out in outputs.items():
        check(isinstance(out, np.ndarray) and out.ndim == 2
              and out.shape[1] == 61 and out.shape[0] > 0
              and bool(np.isfinite(out).all()),
              f"{clip} at '{impl}': {out.shape} finite frames")
    for clip in clips:
        a, p = outputs[(clip, "auto")], outputs[(clip, "pallas")]
        e, scale = float(np.abs(a - p).max()), float(np.abs(a).max())
        check(a.shape == p.shape and e <= 0.05 * scale,
              f"{clip}: 'auto' and 'pallas' agree within 5% of max|out| "
              f"(max abs diff {e}, max|out| {scale})")

    for impl, model in models.items():
        request_timing(torch, np, model, cfg, clips["30 s seeded"], impl)
    return main_path


def request_timing(torch, np, model, cfg, wav: bytes, impl: str) -> None:
    """The 30 s request's frames/s, its stages, and the card's busy share."""
    from neurosync_trainer_lite_tpu_torch.inference.api import (
        generate_facial_data_from_bytes)
    from neurosync_trainer_lite_tpu_torch.inference.device_pipeline import (
        decode_bytes_to_waveform)
    from neurosync_trainer_lite_tpu_torch.ops.frontend import (
        extract_features, widen_and_normalize)

    def wall_ms(fn, reps=11):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        q1, med, q3 = statistics.quantiles(times, n=4)
        return out, med, q1, q3

    out, med, q1, q3 = wall_ms(
        lambda: generate_facial_data_from_bytes(wav, model, cfg))
    print(f"30 s request at '{impl}': {len(out)} frames, median {med:.3f} ms "
          f"(quartiles {q1:.3f}, {q3:.3f}) of 11, "
          f"{len(out) / med * 1e3:.1f} frames/s", flush=True)

    y, _ = decode_bytes_to_waveform(wav, cfg)
    with torch.inference_mode():
        pcm = torch.from_numpy(y.copy())
        feats, fe_ms, _, _ = wall_ms(lambda: extract_features(
            widen_and_normalize(pcm.cuda()), cfg.sr))
        batch = serving_shape()[0]
        chunks = feats[:cfg.frame_size].expand(batch, -1, -1).contiguous()
        _, dec_ms, _, _ = wall_ms(lambda: model(chunks))
    _, wav_ms, _, _ = wall_ms(lambda: decode_bytes_to_waveform(wav, cfg))
    print(f"stages of the request at '{impl}' (median of 11, host clock, "
          f"synchronised): WAV decode {wav_ms:.3f} ms, upload + frontend "
          f"{fe_ms:.3f} ms, decode forward [{batch}, {cfg.frame_size}, "
          f"{cfg.input_dim}] {dec_ms:.3f} ms",
          flush=True)

    profile_once(torch, lambda: generate_facial_data_from_bytes(wav, model, cfg),
                 f"request at '{impl}'", top=8)


def train(torch):
    """Phase 8: the full-width training step at (a) 'auto', dropout 0.3 and
    (b) 'pallas', dropout 0, from the same seeded weights and batch."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq
    from neurosync_trainer_lite_tpu_torch.ops import kernels
    from neurosync_trainer_lite_tpu_torch.training.step import (
        init_train_state, make_eval_step, make_train_step)

    configs = {"a": Config(), "b": Config(attention_impl="pallas",
                                          dropout=0.0)}
    expected = {"a": {"rope_rotate": 100},
                "b": {"rope_rotate": 52, "fused_rope_attention": 24,
                      "fused_rope_attention_bwd": 24}}
    base = configs["a"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    weights = init_seq2seq(base, gen, device="cuda").state_dict()
    B, T = base.batch_size, base.micro_batch_size
    # random features and blendshape-range targets, never zeros (an
    # all-zero batch gives every LayerNorm a zero variance)
    src = torch.randn(B, T, base.input_dim, device="cuda", generator=gen)
    trg = torch.rand(B, T, base.output_dim, device="cuda", generator=gen)
    print(f"train: batch {B} x {T} frames x {base.input_dim} → "
          f"{base.output_dim}, bf16 over fp32, lr {base.learning_rate}, clip "
          f"{base.grad_clip}, {TRAIN_WARMUP} warm-up + {TRAIN_TIMED} timed "
          f"steps", flush=True)

    main_path = {}
    for name, cfg in configs.items():
        label = (f"({name}) '{cfg.attention_impl}', dropout {cfg.dropout}")
        state = init_train_state(cfg, 1000, device="cuda",
                                 state_dict=weights)
        step, evaluate = make_train_step(cfg), make_eval_step(cfg)
        steps = torch.Generator().manual_seed(4)
        before = float(evaluate(state.model, src, trg))
        torch.cuda.reset_peak_memory_stats()

        def one_step():
            _, loss, norm = step(state, src, trg, steps)
            loss, norm = float(loss), float(norm)
            check(math.isfinite(loss) and math.isfinite(norm),
                  f"train {label}: finite loss {loss:.6f} and grad norm "
                  f"{norm:.6f}")
            return loss, norm

        for _ in range(TRAIN_WARMUP):
            one_step()
        torch.cuda.synchronize()
        kernels.reset_launches()
        one_step()
        torch.cuda.synchronize()
        main_path[name] = dict(kernels.LAUNCHES)
        check(main_path[name] == expected[name],
              f"kernel launches of one training step at {label}: "
              f"{main_path[name]} == {expected[name]}")
        times = []
        for _ in range(TRAIN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        q1, med, q3 = statistics.quantiles(times, n=4)
        print(f"train {label}: step median {med * 1e3:.3f} ms (quartiles "
              f"{q1 * 1e3:.3f}, {q3 * 1e3:.3f}) of {TRAIN_TIMED}, "
              f"{B / med:.1f} samples/s (quartiles {B / q3:.1f}, "
              f"{B / q1:.1f}), peak device memory {peak} bytes "
              f"({peak / 2 ** 30:.3f} GiB)", flush=True)
        profile_once(torch, lambda: step(state, src, trg, steps),
                     f"step at {label}", top=10)
        after = float(evaluate(state.model, src, trg))
        check(after < before, f"train {label}: the fixed batch's loss "
              f"(dropout off) fell from {before:.6f} to {after:.6f}")
        del state, step, evaluate
        torch.cuda.empty_cache()

    k4_gradients_in_model(torch, configs["b"], weights, src, trg)
    return main_path


def k4_gradients_in_model(torch, cfg, weights, src, trg) -> None:
    """K4's gradients inside the model: one step of cfg (dropout 0) at
    'auto', where attention takes the lean composed core, and at 'pallas',
    where it takes K4 forward and backward, from the same weights and
    batch, each also held against the same step in fp32 at 'auto' (plain
    autograd, TF32 off). Their loss and pre-clip grad norm must agree.

    Per leaf, err = ‖g − g_fp32‖/‖g_fp32‖ of each attention q/k/v weight
    gradient. bf16 elsewhere in the model sets a leaf's err at either impl
    (up to ~0.15 where a small gradient cancels), so the check reads the
    excess err('pallas') − err('auto'): K4 does its math in fp32, so no leaf
    may lie further from fp32 at 'pallas' than at 'auto' by more than
    EXCESS_LIMIT. A planted fault, a K4 backward that loses head 0's dq,
    must exceed it; the global grad norm hides such a fault."""
    from neurosync_trainer_lite_tpu_torch.ops import fused_attention as fua
    from neurosync_trainer_lite_tpu_torch.training.step import (
        init_train_state, make_train_step)

    def one_step(impl, use_amp=True):
        c = cfg.replace(attention_impl=impl, use_amp=use_amp)
        state = init_train_state(c, 1000, device="cuda", state_dict=weights)
        _, loss, norm = make_train_step(c)(state, src, trg,
                                           torch.Generator().manual_seed(4))
        loss, norm = float(loss), float(norm)
        # the step clipped every gradient by min(1, clip / norm): undo it
        unclip = max(1.0, norm / c.grad_clip)
        grads = {name: p.grad * unclip
                 for name, p in state.model.named_parameters()
                 if re.search(r"\.[qkv]_linear\.weight$", name)}
        del state
        torch.cuda.empty_cache()
        return loss, norm, grads

    fp32 = one_step("auto", use_amp=False)
    runs = {"'auto'": one_step("auto"), "'pallas'": one_step("pallas")}
    sound = fua.fused_rope_attention_bwd_cuda

    def planted(q, k, v, do, tables, num_heads, scale):
        dq, dk, dv = sound(q, k, v, do, tables, num_heads, scale)
        dq[..., :q.shape[-1] // num_heads] = 0
        return dq, dk, dv

    fua.fused_rope_attention_bwd_cuda = planted
    try:
        runs["'pallas', planted fault"] = one_step("pallas")
    finally:
        fua.fused_rope_attention_bwd_cuda = sound

    err = {label: {n: float((grads[n] - g).norm() / g.norm())
                   for n, g in fp32[2].items()}
           for label, (_, _, grads) in runs.items()}
    excess = {}
    for label, (loss, norm, _) in runs.items():
        worst = max(err[label], key=err[label].get)
        excess[label] = max((e - err["'auto'"][n], n)
                            for n, e in err[label].items())
        print(f"one step at dropout 0, bf16 at {label}: loss {loss:.6f}, "
              f"grad norm {norm:.6f} (fp32: {fp32[0]:.6f}, {fp32[1]:.6f}); "
              f"attention q/k/v weight gradients against fp32: worst err "
              f"{err[label][worst]:.3e} ({worst}), worst excess over 'auto' "
              f"{excess[label][0]:.3e} ({excess[label][1]})", flush=True)
    (la, na, _), (lp, np_, _) = runs["'auto'"], runs["'pallas'"]
    loss_gap, norm_gap = abs(lp - la) / abs(la), abs(np_ - na) / na
    check(loss_gap <= 1e-3 and norm_gap <= 1e-2,
          f"one step at dropout 0: 'auto' and 'pallas' agree within 1e-3 in "
          f"loss ({loss_gap:.3e}) and 1e-2 in grad norm ({norm_gap:.3e})")
    sound_gap = excess["'pallas'"][0]
    check(sound_gap <= EXCESS_LIMIT,
          f"one step at dropout 0: no attention q/k/v weight gradient lies "
          f"further from fp32 at 'pallas' than at 'auto' by more than "
          f"{EXCESS_LIMIT:g} ({sound_gap:.3e})")
    fault_gap = excess["'pallas', planted fault"][0]
    fault_norm = runs["'pallas', planted fault"][1]
    check(fault_gap > EXCESS_LIMIT,
          f"a K4 backward that loses head 0's dq fails that check "
          f"({fault_gap:.3e}; its grad norm moves "
          f"{abs(fault_norm - np_) / np_:.3e})")


def profile_once(torch, fn, label: str, top: int) -> None:
    """The card's busy share and top kernels of one call (profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's self device time repeats the time
    # of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profiled {label}: {wall:.3f} ms wall, card busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%, profiler on)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from neurosync_trainer_lite_tpu_torch.ops import kernels

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, TF32 off", flush=True)

    t0 = time.perf_counter()
    built = kernels.build()
    print(f"build: {time.perf_counter() - t0:.3f} s for "
          f"{', '.join(f'{n} ({s:.3f} s)' for n, (s, _) in built.items())}",
          flush=True)
    for _, log in built.values():
        print_ptxas_summary(log)

    records = {
        "rope_rotate": dict(
            route="cuda", source="neurosync_trainer_lite_tpu_torch/csrc/rope.cu",
            replaces="neurosync_trainer_lite_tpu/ops/rope_pallas.py:51",
            tolerance="bitwise"),
        "fused_rope_attention": dict(
            route="cuda",
            source="neurosync_trainer_lite_tpu_torch/csrc/fused_attention.cu",
            replaces="neurosync_trainer_lite_tpu/ops/fused_attention.py:169",
            tolerance="2^-7*|plain|+1e-6 (bf16), 1e-5*|plain|+1e-6 (fp32)"),
        "fused_rope_attention_bwd": dict(
            route="cuda",
            source="neurosync_trainer_lite_tpu_torch/csrc/fused_attention.cu",
            replaces="neurosync_trainer_lite_tpu/ops/fused_attention.py:186",
            tolerance="2^-7*|plain|+1e-4*max|plain| (bf16), "
                      "1e-5*|plain|+1e-4*max|plain| (fp32)"),
    }
    rounding_contracts(torch)
    kernel_checks(torch, records)
    reference_goldens(torch, np)
    paths = {"serve": serve(torch, np)}
    trained = train(torch)
    paths.update({f"train ({name})": counts for name, counts in trained.items()})
    for name in records:
        check(sum(counts.get(name, 0) for counts in paths.values()) > 0,
              f"{name} ran in the main path runs")

    kernel_line = {"kernels": [
        {"name": name, "route": r["route"], "source": r["source"],
         "replaces": r["replaces"],
         "launches": sum(counts.get(name, 0) for counts in paths.values()),
         "launches_by_path": {path: counts.get(name, 0)
                              for path, counts in paths.items()},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": None,
         "shape": r["shape"], "tolerance": r["tolerance"]}
        for name, r in records.items()]}
    print(json.dumps(kernel_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only serve-s2   # phases 1, 2 and 7b alone

Needs one NVIDIA H100 (sm_90a), the CUDA toolkit (nvcc) and PyTorch built
for CUDA; imports nothing of JAX. Every phase must pass, else the script
exits non-zero before its result line.

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from neurosync_trainer_lite_tpu_torch/csrc, one
   nvcc per source, in parallel, and prints the build time, each kernel's
   registers and spills, and the count of HGMMA and UTMALDG instructions
   in K2's wgmma kernel and of HMMA in the K4 forward's and backward's
   tensor-core kernels (cuobjdump -sass); a count of zero fails the run.
3. Checks two rounding contracts of ops/attention.py on the card: the bf16
   batched products (_matmul_round_once) equal the fp32 product rounded
   once to bf16 at the serving and training attention shapes, and
   _linear's bf16 gradients (torch.mm with an fp32 output has no
   derivative, so _linear is an autograd Function) equal autograd of the
   widened-operand formula, to one bf16 rounding.
4. Holds each kernel against its plain PyTorch version on the card: K1
   forward and transpose, bf16 and fp32, global and head-tiled tables
   (bitwise), and the K4 forward in bf16 (the tensor-core kernel; one bf16
   ulp plus 1e-4 of the largest output, fua.fwd_limit) and fp32 (the
   CUDA-core one; 1e-5 relative), bitwise repeatable, at the serving shape
   [17, 128, 1024] (the 30 s request's 17 chunks) and the training shape
   [128, 128, 1024]; the K4 backward at the training shape in bf16 (the
   tensor-core kernel) and fp32 (the CUDA-core one), one bf16 ulp plus
   1e-4 of the largest gradient, bitwise repeatable; the K4 forward and
   backward at head widths 48 ([4, 128, 768], 16 heads) and 128 ([4, 128,
   1024], 8 heads), where the gate refuses the fp32 backward.
   K1 again at the long windows' [32, 512, 1024] and [8, 2048, 1024]
   (bitwise); K3 forward and backward at (c) [32, 16, 512, 64], (d)
   [8, 16, 2048, 64], (s2) [4, 16, 512, 64], a ragged cross-length
   [2, 4, 96 | 192, 32] and a width off the powers of two [4, 16, 512, 48],
   bf16 (the tensor-core kernels; 2^-7·|plain| + 2^-9·max|plain|) and fp32
   (the CUDA-core ones; 1e-5·max|plain|), the backward bitwise repeatable;
   K2 (the fused FFN backward) at step (a)'s [16384, 1024, 4096] at scale 1
   and 256/179, the ragged [96, 64, 192] and [1000, 1024, 4096] (the wgmma
   kernel) and [33, 20, 70] (the WMMA kernel), dh1 2^-7·|plain| +
   1e-5·max|plain|, db2 and db1 2e-4·max|plain|, bitwise repeatable.
5. Times each kernel and its plain version (median of CUDA graph replays,
   so host launch overhead is excluded) beside the least time the card
   could take for the same work: K1 and the K4 forward at the serving and
   the training shape (K1 also as the K4 backward's fp32 transpose there),
   the K4 backward at the training shape, K3 at (c), (d) and (s2)
   with scaled_dot_product_attention (forward; backward alone, and forward
   + backward beside it) as the library yardstick, which the port never
   calls, and K2 at (a)'s shape beside cuBLAS's dy·W alone. A bound
   charges the products a kernel runs on the tensor cores at their peak
   (K3's and the K4 backward's: all five, split-bf16; the K4 forward's
   two, whose split-bf16 count as executed is printed beside it) and all
   other operations at the fp32 CUDA cores'; K3 also prints its exps' time
   on the MUFU.
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
   from torch.profiler. Then (s2) the same request at frame_size=512
   (4 chunks): K3 forward 24 and K1 50 launches a request at 'auto' and
   'pallas', [1801, 61] finite, within 5% of 'xla' (the composed path),
   with the same timings, 'xla' timed too: the same request without K3.
8. Trains the full-width model (16,384 frames a step, seeded random
   features and targets, the same seeded weights): (a) Config(): 'auto',
   dropout 0.3; (b) 'pallas', dropout 0, which runs the K4 forward and
   backward; (c) window 512 x batch 32, dropout 0, 'auto', which runs K3.
   Checks a finite loss and grad norm at every step, the fixed batch's
   loss (dropout off) lower after the steps than before, and the kernel
   launch counts of one step (K1 = 100 at (a); K1 = 52, K4 forward = 24,
   K4 backward = 24 at (b); K1 = 100, K3 forward 24 and backward 24 + 24
   at (c)). Prints samples/s (median and quartiles of 10 steps after 3
   warm-up steps), peak device memory, and the card's busy share and top
   kernels of one profiled step; at (b) the K4 backward's, the K4
   forward's and K1's shares of the device time, the forward's and the
   backward's all the tensor-core kernels'; at (c) K3's, all the
   tensor-core kernels'. Then
   each attention
   kernel's gradients inside the model (attention_gradients_in_model):
   one step at dropout 0
   with the kernel and with the composed path ((b) against 'auto', (c)
   against 'xla') from the same weights and batch agree within 1e-3 in
   loss and 1e-2 in the pre-clip grad norm, and no attention q/k/v weight
   gradient lies further from the fp32 step with the kernel than without
   by more than EXCESS_LIMIT; a kernel backward with a planted fault (head
   0's dq lost) must exceed that limit.
9. Trains (d) window 2048 x batch 8, dropout 0, 'auto' (K3) without remat
   and with remat=True (1 warm-up, 1 counted and 3 timed steps each), and
   one step each at remat_policy='dots' and remat_scope='decoder',
   remat_layers=2. Every remat run's losses and grad norms equal the
   no-remat run's (relative 1e-6; bitwise printed), full remat lowers the
   peak device memory, and the launch counts include the rematted layers'
   forward kernels launched again in the backward (K3 forward 48, K1 148
   at remat 'all' and 'dots'; 28 and 108 at two decoder layers).
10. (e) Step (a) with seq2seq._ffn rebound to ops/ffn_bwd.py:ffn_fused, so
   that every FFN backward runs K2: K2 = 16 and K1 = 100 launches a step
   (K2 = 0 with the default _ffn again), samples/s, peak memory and busy
   share beside (a), K2's share of the device time (all the wgmma
   kernel's); one dropout-0 step against the default path and fp32
   per FFN weight and bias leaf, with a planted fault (db1 zeroed) that the
   check must catch.
11. (f) The training entry point at full width on the repo's real capture:
   train_model on a temporary copy of dataset/data (features from the
   device frontend), validating on dataset/test_set, 2 epochs and a resume
   for a third; losses finite and falling, batch_step and Adam's count
   continuing, checkpoints, backups, validation CSVs and stats written,
   model.pth serving the test clip; then the CLI
   (python -m neurosync_trainer_lite_tpu_torch.train) for 2 steps.

The line before the last holds the card's name and power limit; the line
before that the kernels' JSON record (launches: the sum over the main path
runs, the serving runs and one training step at each configuration, each
counted from zero; launches_by_path: each run's own count); the last line
the result.
"""

from __future__ import annotations

import argparse
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
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
#: exp2 on the MUFU: 132 SMs x 16 a clock x 1.98 GHz boost (H100 SXM)
EXP_PER_S = 132 * 16 * 1.98e9
SERVE_SECONDS = 30             # the timed request: a seeded int16 WAV
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
EXCESS_LIMIT = 0.05            # attention_gradients_in_model
#: (B, N, T, h) K3 gets at (c) window 512 x batch 32, (d) 2048 x 8, and
#: (s2) the 30 s request at frame_size 512 (4 chunks)
K3_SHAPES = {"c": (32, 16, 512, 64), "d": (8, 16, 2048, 64),
             "s2": (4, 16, 512, 64)}
#: (M, H, F) K2 gets at step (a) (128 x 128 rows, hidden 1024, FFN 4096),
#: the JAX test's ragged shape and M off the 128-row tile (the wgmma
#: kernel), and H, F not multiples of 8 (the WMMA kernel)
K2_SHAPES = [(16384, 1024, 4096), (96, 64, 192), (1000, 1024, 4096),
             (33, 20, 70)]


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


def device_ms(fn, iters: int = 20, reps: int = 7, stream=None) -> float:
    """Median device time of one call: `iters` calls captured in a CUDA
    graph (on `stream` if given, else on a stream of its own) and replayed
    between two events."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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


def event_ms(fn, iters: int) -> float:
    """Device time of one call from CUDA events around `iters` eager calls,
    after a warm-up: for calls whose device time dwarfs their launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float,
          bf16_flops: float = 0.0) -> tuple[float, str]:
    """The least time of the work: `flops` on fp32 operands at the CUDA
    cores' peak and `bf16_flops` (products with bf16 operands) at the tensor
    cores', which run alongside each other and alongside the memory."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = max(flops / FP32_FLOP_PER_S, bf16_flops / BF16_FLOP_PER_S) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def serving_shape(cfg=None) -> tuple[int, int, int, int]:
    """(B, T, H, heads) the 30 s request gives the kernels: B its chunk
    count (the decode batch), T the chunk length, H the hidden width."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.inference.chunked import chunk_plan
    from neurosync_trainer_lite_tpu_torch.ops.frontend import num_frames_60

    cfg = cfg or Config()
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
            short = re.sub(r"^.*?\d+(rope_rows|attn_fwd_kernel|attn_bwd_kernel|"
                           r"attn_fwd_mma_kernel|attn_bwd_mma_kernel|"
                           r"flash_fwd_kernel|flash_bwd_dq_kernel|"
                           r"flash_bwd_dkdv_kernel|flash_fwd_mma_kernel|"
                           r"flash_bwd_dq_mma_kernel|"
                           r"flash_bwd_dkdv_mma_kernel|ffn_bwd_wgmma_kernel|"
                           r"ffn_bwd_wmma_kernel)",
                           r"\1", name)
            print(f"ptxas: {short[:48]}: {m.group(1)} registers, {spills}",
                  flush=True)
            name = None


def sass_counts(kernels) -> None:
    """The tensor-core and TMA instructions in the compiled kernels
    (cuobjdump -sass of each library): HGMMA and UTMALDG in K2's wgmma
    kernel, HMMA in the K4 backward's tensor-core kernel. Fails if a count
    is zero."""
    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    wanted = {("ffn_bwd", "ffn_bwd_wgmma_kernel"): ("HGMMA", "UTMALDG"),
              ("fused_attention", "attn_fwd_mma_kernel"): ("HMMA",),
              ("fused_attention", "attn_bwd_mma_kernel"): ("HMMA",)}
    for (lib, symbol), opcodes in wanted.items():
        sass = subprocess.run(
            [str(tool), "-sass", str(kernels.library_path(lib))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        # one section a function, headed "Function : <mangled name>"
        body = "".join(sec for sec in re.split(r"\n\s*Function : ", sass)[1:]
                       if symbol in sec.split("\n", 1)[0])
        counts = {op: len(re.findall(rf"\b{op}\b", body)) for op in opcodes}
        check(bool(body) and all(counts.values()),
              f"SASS of {symbol} (lib{lib}): "
              + ", ".join(f"{op} x{n}" for op, n in counts.items()))


def kernel_shares(label: str, times: dict[str, float],
                  kernels: dict[str, tuple[str, str]]) -> None:
    """Each kernel's share of a profiled step's device time (`times`:
    device ms by kernel name). `kernels`: {label: (pattern of the symbol
    that must have run, pattern of one that must not, or None)}."""
    busy = sum(times.values())
    for what, (ran, idle) in kernels.items():
        ours = sum(t for name, t in times.items() if re.search(ran, name))
        wrong = sorted({name[:60] for name in times
                        if idle and re.search(idle, name)})
        print(f"profiled {label}: {what} {ours:.3f} ms of {busy:.3f} ms "
              f"device time ({100 * ours / busy:.1f}%)", flush=True)
        check(ours > 0 and not wrong,
              f"{label}: {what} ran as {ran} (and not {idle}: {wrong})")


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
    train_batch_size = Config().batch_size
    gen = torch.Generator(device="cuda").manual_seed(1)
    err = {"rope_rotate": 0.0, "fused_rope_attention": 0.0}
    table_sets = {"global": rope_tables(T, H, "cuda"),
                  "tiled": rope_tables(T, hd, "cuda", tile=n)}
    # the serving batch (the 30 s request's chunks) and the training batch
    for batch in (B, train_batch_size):
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
            err["fused_rope_attention"] = max(
                err["fused_rope_attention"],
                k4_forward_check(torch, fua, q, k, v, tables, n))
            del x, q, k, v
    err["fused_rope_attention"] = max(err["fused_rope_attention"],
                                      k4_widths(torch, gen))

    # timing in bf16, the serving and training dtype, at the serving and the
    # training shape; K1 also as the K4 backward's fp32 transpose at (b)
    tiled = table_sets["tiled"]
    tables = fua.make_tables(T, T, hd, n, "cuda")
    k1_by, k4_by = {}, {}
    with torch.no_grad():
        for label, batch, dtype, transpose in (
                ("serving", B, torch.bfloat16, False),
                ("training", train_batch_size, torch.bfloat16, False),
                ("training, fp32 transpose", train_batch_size, torch.float32,
                 True)):
            x = torch.randn(batch, T, H, device="cuda", generator=gen).to(
                dtype)
            item = x.element_size()
            rec = dict(
                ms=device_ms(lambda: rk.rope_rotate_cuda(
                    x, *tiled, transpose=transpose)),
                plain_ms=device_ms(lambda: rk.rope_rotate_plain(
                    x, *tiled, transpose=transpose)),
                eager_ms=eager_ms(lambda: rk.rope_rotate_cuda(
                    x, *tiled, transpose=transpose)),
                shape=[batch, T, H], dtype=str(dtype), transpose=transpose)
            # x read and out written once, the three fp32 tables once; 5
            # flops an element on the CUDA cores
            rec["bound_ms"], rec["bound_by"] = bound(
                2 * x.numel() * item + 3 * T * H * 4, 5 * x.numel())
            k1_by[label] = rec
            del x

            if dtype != torch.bfloat16:
                continue
            q, k, v = (torch.randn(batch, T, H, device="cuda", generator=gen)
                       .to(dtype) for _ in range(3))
            rec = dict(
                ms=device_ms(lambda: fua.fused_rope_attention_cuda(
                    q, k, v, tables, n, hd ** -0.5)),
                plain_ms=device_ms(lambda: fua.fused_rope_attention_plain(
                    q, k, v, tables, n, hd ** -0.5), iters=5),
                eager_ms=eager_ms(lambda: fua.fused_rope_attention_cuda(
                    q, k, v, tables, n, hd ** -0.5)),
                shape=[batch, T, H])
            # q·kᵀ and p·v (2·T·T·H each) with bf16 operands at the tensor
            # cores' peak, where the bf16 kernel runs them; the rotation of
            # q and k (5 flops an element each) and the softmax (~5 a score)
            # on the CUDA cores; q, k, v read and out written once, six fp32
            # tables. `split_ms`: the products as the kernel executes them,
            # split-bf16 (three mma for q·kᵀ, two for p·v: 10·B·T·T·H), at
            # the tensor cores' peak
            pairs = batch * T * T
            rec["bound_ms"], rec["bound_by"] = bound(
                4 * batch * T * H * item + 6 * T * H * 4,
                10 * batch * T * H + 5 * n * pairs, bf16_flops=4 * pairs * H)
            rec["split_ms"] = 10 * pairs * H / BF16_FLOP_PER_S * 1e3
            rec["fp32_bound_ms"] = bound(
                4 * batch * T * H * item + 6 * T * H * 4,
                10 * batch * T * H + 5 * n * pairs + 4 * pairs * H)[0]
            k4_by[label] = rec
            del q, k, v

    records["rope_rotate"].update(
        {key: k1_by["serving"][key] for key in (
            "ms", "plain_ms", "eager_ms", "bound_ms", "bound_by", "shape")},
        max_abs_err=err["rope_rotate"], by_shape=k1_by)
    records["fused_rope_attention"].update(
        {key: k4_by["serving"][key] for key in (
            "ms", "plain_ms", "eager_ms", "bound_ms", "bound_by", "shape")},
        max_abs_err=err["fused_rope_attention"], by_shape=k4_by)
    records["fused_rope_attention_bwd"].update(k4_backward(torch, gen))
    for name, by in (("rope_rotate", k1_by), ("fused_rope_attention", k4_by)):
        for label, r in by.items():
            print(f"time {name} ({label}) at {r['shape']} "
                  f"{r.get('dtype', 'torch.bfloat16')}: {r['ms']:.6f} ms on "
                  f"the card (CUDA graph), {r['eager_ms']:.6f} ms eager, "
                  f"plain {r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} "
                  f"ms ({r['bound_by']}; {r['ms'] / r['bound_ms']:.2f}x)"
                  + (f"; split-bf16 products as executed at the tensor "
                     f"cores' peak {r['split_ms']:.6f} ms; every operation on "
                     f"the fp32 CUDA cores {r['fp32_bound_ms']:.6f} ms"
                     if "split_ms" in r else ""), flush=True)
    r = records["fused_rope_attention_bwd"]
    print(f"time fused_rope_attention_bwd at {r['shape']} bf16: "
          f"{r['ms']:.6f} ms on the card (CUDA graph), {r['eager_ms']:.6f} ms "
          f"eager, plain {r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms "
          f"({r['bound_by']}); fp32-operand products on the CUDA cores "
          f"{r['fp32_bound_ms']:.6f} ms", flush=True)


def k4_forward_check(torch, fua, q, k, v, tables, n) -> float:
    """The K4 forward against its plain version within fua.fwd_limit and
    bitwise repeatable; prints how many elements lie beyond 2^-7·|plain| +
    1e-6 (the bf16 gate before the tensor-core kernel). Returns the max abs
    error."""
    hd = q.shape[-1] // n
    with torch.no_grad():
        out = fua.fused_rope_attention_cuda(q, k, v, tables, n, hd ** -0.5)
        torch.cuda.synchronize()
        ref = fua.fused_rope_attention_plain(q, k, v, tables, n, hd ** -0.5)
        again = fua.fused_rope_attention_cuda(q, k, v, tables, n, hd ** -0.5)
    diff = (out.float() - ref.float()).abs()
    e = diff.max().item()
    beyond = int((diff > 2.0 ** -7 * ref.float().abs() + 1e-6).sum())
    shape = list(q.shape)
    check(out.dtype == q.dtype
          and bool((diff <= fua.fwd_limit(ref, q.dtype)).all()),
          f"K4 fused_rope_attention {shape}, {n} heads of {hd}, {q.dtype} "
          f"within fwd_limit of the plain version (max abs err {e:.3e}, "
          f"max|plain| {ref.float().abs().max().item():.3e}, {beyond} of "
          f"{diff.numel()} elements beyond 2^-7·|plain| + 1e-6)")
    check(torch.equal(out, again),
          f"K4 fused_rope_attention {shape} {q.dtype} bitwise repeatable")
    return e


def k4_widths(torch, gen) -> float:
    """The K4 forward and backward at head widths off 64, [4, 128, 768] with
    16 heads (h = 48) and [4, 128, 1024] with 8 heads (h = 128), in bf16
    and fp32, against their plain versions; at h = 128 and T = 128 the fp32
    backward needs 263,680 B of shared memory, so the gate refuses it, and
    the wrapper raises. Returns the forward's max abs error."""
    from neurosync_trainer_lite_tpu_torch.ops import fused_attention as fua

    worst = 0.0
    for H, n in ((768, 16), (1024, 8)):
        hd = H // n
        scale = hd ** -0.5
        tables = fua.make_tables(128, 128, hd, n, "cuda")
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (torch.randn(4, 128, H, device="cuda",
                                       generator=gen).to(dtype)
                           for _ in range(4))
            worst = max(worst, k4_forward_check(torch, fua, q, k, v, tables,
                                                n))
            if not fua.fits_smem(128, 128, hd, q.element_size()):
                try:
                    fua.fused_rope_attention_bwd_cuda(q, k, v, do, tables, n,
                                                      scale)
                    refused = False
                except ValueError:
                    refused = True
                check(refused and hd == 128 and dtype == torch.float32,
                      f"K4 backward [4, 128, {H}], {n} heads of {hd}, {dtype}: "
                      f"refused by the shared-memory gate "
                      f"({fua.bwd_smem_bytes(128, 128, hd, 4)} B)")
                continue
            out = fua.fused_rope_attention_bwd_cuda(q, k, v, do, tables, n,
                                                    scale)
            torch.cuda.synchronize()
            ref = fua.fused_rope_attention_bwd_plain(q, k, v, do, tables, n,
                                                     scale)
            rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
            for name, a, b in zip(("dq", "dk", "dv"), out, ref):
                diff = (a.float() - b.float()).abs()
                limit = rel * b.float().abs() + 1e-4 * b.float().abs().max()
                check(a.dtype == dtype and bool((diff <= limit).all()),
                      f"K4 backward {name} [4, 128, {H}], {n} heads of {hd}, "
                      f"{dtype} within {rel:g}·|plain| + 1e-4·max|plain| (max "
                      f"abs err {diff.max().item():.3e})")
            again = fua.fused_rope_attention_bwd_cuda(q, k, v, do, tables, n,
                                                      scale)
            check(all(torch.equal(a, b) for a, b in zip(out, again)),
                  f"K4 backward [4, 128, {H}] {dtype} bitwise repeatable")
            del out, ref, again
        del q, k, v, do
    return worst


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
    # five T·T·hd products per head (2 flops each), all at the tensor cores'
    # peak, where the bf16 kernel runs them (the fp32 operands rotated q
    # and k, p and ds split into bf16 halves); the rotation of q and k and
    # the transpose rotation of dq and dk (5 flops per element each),
    # softmax, D and ds (~10 per score) on the CUDA cores; q, k, v, dO
    # read, dq, dk, dv written once, six fp32 tables. `fp32_bound_ms`: the
    # four products with an fp32 operand on the CUDA cores instead, as the
    # CUDA-core kernel (fp32) runs them.
    nbytes = 7 * B * T * H * 2 + 6 * T * H * 4
    cores = 20 * B * T * H + 10 * B * n * T * T
    b_ms, b_by = bound(nbytes, cores, bf16_flops=10 * B * T * T * H)
    rec.update(bound_ms=b_ms, bound_by=b_by, max_abs_err=worst,
               shape=[B, T, H],
               fp32_bound_ms=bound(nbytes, 8 * B * T * T * H + cores,
                                   bf16_flops=2 * B * T * T * H)[0])
    return rec


def k3_checks(torch, records):
    """Phases 4 and 5 for K3 (and K1 at its long-window shapes): against the
    plain versions at (c), (d) and a ragged cross-length shape, in bf16 and
    fp32, the backward bitwise repeatable; then timed in bf16 at (c) and
    (d) beside the plain versions, the bounds and SDPA."""
    import torch.nn.functional as F

    from neurosync_trainer_lite_tpu_torch.ops import flash_attention as fa
    from neurosync_trainer_lite_tpu_torch.ops import rope_kernel as rk
    from neurosync_trainer_lite_tpu_torch.ops.rope import rope_tables

    gen = torch.Generator(device="cuda").manual_seed(6)

    def randn(*shape, dtype):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    for B, N, T, h in K3_SHAPES.values():
        tables = rope_tables(T, h, "cuda", tile=N)
        for dtype in (torch.bfloat16, torch.float32):
            x = randn(B, T, N * h, dtype=dtype)
            for transpose in (False, True):
                out = rk.rope_rotate_cuda(x, *tables, transpose=transpose)
                torch.cuda.synchronize()
                check(torch.equal(out, rk.rope_rotate_plain(
                    x, *tables, transpose=transpose)),
                      f"K1 rope_rotate [{B}, {T}, {N * h}] {dtype} "
                      f"transpose={transpose} bitwise equal to the plain "
                      f"version")
            del x, out

    err = {"flash_attention": 0.0, "flash_attention_bwd": 0.0}
    shapes = [(B, N, T, T, h) for B, N, T, h in K3_SHAPES.values()]
    # a ragged cross-length shape, and a head width off the powers of two
    for B, N, Tq, Tk, h in shapes + [(2, 4, 96, 192, 32), (4, 16, 512, 512,
                                                           48)]:
        for dtype in (torch.bfloat16, torch.float32):
            q, do = (randn(B, N, Tq, h, dtype=dtype) for _ in range(2))
            k, v = (randn(B, N, Tk, h, dtype=dtype) for _ in range(2))
            scale = h ** -0.5
            got = {"out": fa.flash_attention_cuda(q, k, v, scale)}
            grads = fa.flash_attention_bwd_cuda(q, k, v, do, scale)
            got.update(zip(("dq", "dk", "dv"), grads))
            torch.cuda.synchronize()
            want = {"out": fa.flash_attention_plain(q, k, v, scale)}
            want.update(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_plain(
                q, k, v, do, scale)))
            for name, ref in want.items():
                diff = (got[name].float() - ref.float()).abs()
                e = diff.max().item()
                key = "flash_attention" if name == "out" else \
                    "flash_attention_bwd"
                err[key] = max(err[key], e)
                share = (diff > 2.0 ** -7 * ref.float().abs()).float().mean()
                check(got[name].dtype == dtype
                      and bool((diff <= fa.kernel_limit(ref, dtype)).all()),
                      f"K3 {name} [{B}, {N}, {Tq}, {Tk}, {h}] {dtype} within "
                      f"the limit of the plain version (max abs err {e:.3e}, "
                      f"max|plain| {ref.float().abs().max().item():.3e}, "
                      f"{share.item():.2e} of the elements beyond one ulp "
                      f"of their own value)")
            again = fa.flash_attention_bwd_cuda(q, k, v, do, scale)
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  f"K3 backward [{B}, {N}, {Tq}, {Tk}, {h}] {dtype} bitwise "
                  f"repeatable")
            del q, k, v, do, got, grads, want, again
            torch.cuda.empty_cache()

    timed = {}
    for label, (B, N, T, h) in K3_SHAPES.items():
        q, k, v, do = (randn(B, N, T, h, dtype=torch.bfloat16)
                       for _ in range(4))
        scale = h ** -0.5
        iters = 10 if T <= 512 else 4
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg)
            torch.autograd.grad(out, (qg, kg, vg), do)

        pairs = B * N * T * T
        item = q.element_size()
        # forward: q·kᵀ and p·v (2h flops a pair each) have bf16 operands,
        # p being rounded to v's type first; softmax ~5 a pair. Backward:
        # the five products (s = q·kᵀ, dp = dO·vᵀ, pᵀ·dO, ds·k, dsᵀ·q) all
        # at the tensor cores' peak, which the split-bf16 kernels run them
        # on; softmax, D and ds ~10 a pair. `split_bound_ms`: the three
        # fp32-operand products on the CUDA cores instead, as counted
        # before the tensor-core kernels. `exp_ms`: the exps the kernels
        # take (2 a pair forward, 3 backward) on the MUFU alone.
        with torch.no_grad():
            fwd = dict(
                ms=device_ms(lambda: fa.flash_attention_cuda(q, k, v, scale),
                             iters=iters),
                plain_ms=device_ms(lambda: fa.flash_attention_plain(
                    q, k, v, scale), iters=iters),
                library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v), iters=iters),
                bf16_flops=4 * pairs * h, flops=5 * pairs,
                bytes=4 * q.numel() * item, exps=2 * pairs)
            bwd = dict(
                ms=device_ms(lambda: fa.flash_attention_bwd_cuda(
                    q, k, v, do, scale), iters=iters),
                plain_ms=device_ms(lambda: fa.flash_attention_bwd_plain(
                    q, k, v, do, scale), iters=max(2, iters // 2)),
                bf16_flops=10 * pairs * h, flops=10 * pairs,
                bytes=7 * q.numel() * item, exps=3 * pairs,
                split_bound_ms=bound(7 * q.numel() * item,
                                     6 * pairs * h + 10 * pairs,
                                     4 * pairs * h)[0])
        # SDPA's backward alone, replayed like the kernel's: its kernels run
        # on the stream of their forward, so the forward runs on the stream
        # the graph captures
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            out = F.scaled_dot_product_attention(qg, kg, vg)
        bwd["library_ms"] = device_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), iters=iters,
            stream=stream)
        # and the library's whole VJP (CUDA events around an eager loop)
        bwd["library_fwd_bwd_ms"] = event_ms(sdpa_fwd_bwd, iters=iters)
        for rec in (fwd, bwd):
            rec["bound_ms"], rec["bound_by"] = bound(
                rec["bytes"], rec["flops"], rec["bf16_flops"])
            every = rec["flops"] + rec["bf16_flops"]
            rec["fp32_bound_ms"] = bound(rec["bytes"], every)[0]
            rec["tensor_core_bound_ms"] = every / BF16_FLOP_PER_S * 1e3
            rec["exp_ms"] = rec["exps"] / EXP_PER_S * 1e3
            rec["shape"] = [B, N, T, h]
        timed[label] = (fwd, bwd)
        for name, rec in (("flash_attention", fwd),
                          ("flash_attention_bwd", bwd)):
            print(f"time {name} ({label}) at {rec['shape']} bf16: "
                  f"{rec['ms']:.6f} ms on the card (CUDA graph), plain "
                  f"{rec['plain_ms']:.6f} ms, SDPA "
                  f"{'forward' if rec is fwd else 'backward'} "
                  f"{rec['library_ms']:.6f} ms"
                  + (f" (forward + backward {rec['library_fwd_bwd_ms']:.6f} "
                     f"ms, CUDA events)" if rec is bwd else "")
                  + f", bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}; "
                  f"products on tensor cores), every operation on fp32 "
                  f"CUDA cores {rec['fp32_bound_ms']:.6f} ms, on tensor cores "
                  f"{rec['tensor_core_bound_ms']:.6f} ms"
                  + (f", fp32-operand products on CUDA cores "
                     f"{rec['split_bound_ms']:.6f} ms" if rec is bwd else "")
                  + f"; exps on the MUFU {rec['exp_ms']:.6f} ms", flush=True)
        del q, k, v, do, qg, kg, vg, out
        torch.cuda.empty_cache()

    for i, name in enumerate(("flash_attention", "flash_attention_bwd")):
        first = timed["c"][i]
        records[name].update(
            {key: first[key] for key in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by", "shape")},
            max_abs_err=err[name],
            by_shape={label: {key: rec[i][key] for key in (
                "shape", "ms", "plain_ms", "library_ms", "library_fwd_bwd_ms",
                "bound_ms", "bound_by")
                if key in rec[i]} for label, rec in timed.items()})


def k2_checks(torch, records):
    """Phases 4 and 5 for K2: against its plain version at step (a)'s shape
    at scale 1 and 256/179 (dropout 0.3), the ragged JAX test shape and a
    row count off the tile, bitwise repeatable; then timed at (a)'s shape
    beside the plain version, the bound and cuBLAS's dy·W alone."""
    from neurosync_trainer_lite_tpu_torch.ops import ffn_bwd

    gen = torch.Generator(device="cuda").manual_seed(7)
    bf16 = torch.bfloat16

    def inputs(m, h, f):
        dy = torch.randn(m, h, device="cuda", generator=gen).to(bf16)
        w = (torch.randn(h, f, device="cuda", generator=gen) * 0.02).to(bf16)
        am = torch.relu(torch.randn(m, f, device="cuda", generator=gen)
                        - 0.3).to(bf16)
        return dy, w, am

    worst = 0.0
    for m, h, f in K2_SHAPES:
        dy, w, am = inputs(m, h, f)
        scales = (1.0, 256 / 179) if m == K2_SHAPES[0][0] else (256 / 179,)
        for scale in scales:
            out = ffn_bwd.ffn_bwd_dh1_cuda(dy, w, am, scale=scale)
            torch.cuda.synchronize()
            ref = ffn_bwd.ffn_bwd_dh1_plain(dy, w, am, scale=scale)
            for name, a, b, limit in zip(("dh1", "db2", "db1"), out, ref,
                                         ffn_bwd.kernel_limits(ref)):
                diff = (a.float() - b.float()).abs()
                e = diff.max().item()
                worst = max(worst, e)
                share = (diff > 0).float().mean().item()
                check(a.dtype == b.dtype and a.shape == b.shape
                      and bool((diff <= limit).all()),
                      f"K2 {name} [{m}, {h}, {f}] scale {scale:.6f} within "
                      f"the limit of the plain version (max abs err {e:.3e}, "
                      f"max|plain| {b.float().abs().max().item():.3e}, "
                      f"{share:.2e} of the elements differ)")
            again = ffn_bwd.ffn_bwd_dh1_cuda(dy, w, am, scale=scale)
            check(all(torch.equal(a, b) for a, b in zip(out, again)),
                  f"K2 [{m}, {h}, {f}] scale {scale:.6f} bitwise repeatable")
        del dy, w, am, out, ref, again

    m, h, f = K2_SHAPES[0]
    dy, w, am = inputs(m, h, f)
    scale = 256 / 179
    rec = dict(
        ms=device_ms(lambda: ffn_bwd.ffn_bwd_dh1_cuda(dy, w, am, scale=scale),
                     iters=10),
        plain_ms=device_ms(lambda: ffn_bwd.ffn_bwd_dh1_plain(
            dy, w, am, scale=scale), iters=10),
        library_ms=device_ms(lambda: torch.mm(dy, w, out_dtype=torch.float32),
                             iters=10))
    # dy·W with bf16 operands on the tensor cores; the epilogue (compare,
    # scale, column sum: 3 a dh1 element) and dy's column sums on the CUDA
    # cores; dy, W, am read and dh1, db2, db1 written once
    rec["bound_ms"], rec["bound_by"] = bound(
        2 * (m * h + h * f + 2 * m * f) + 4 * (h + f), 3 * m * f + m * h,
        bf16_flops=2 * m * h * f)
    rec["tensor_core_bound_ms"] = 2 * m * h * f / BF16_FLOP_PER_S * 1e3
    rec["fp32_bound_ms"] = 2 * m * h * f / FP32_FLOP_PER_S * 1e3
    rec.update(max_abs_err=worst, shape=[m, h, f])
    records["ffn_bwd_dh1"].update(rec)
    print(f"time ffn_bwd_dh1 at [{m}, {h}, {f}] bf16: {rec['ms']:.6f} ms on "
          f"the card (CUDA graph), plain {rec['plain_ms']:.6f} ms, cuBLAS "
          f"dy·W alone {rec['library_ms']:.6f} ms, bound "
          f"{rec['bound_ms']:.6f} ms ({rec['bound_by']}; the product on fp32 "
          f"CUDA cores {rec['fp32_bound_ms']:.6f} ms)", flush=True)
    del dy, w, am
    torch.cuda.empty_cache()


def serve_long(torch, np):
    """Phase 7b (s2): the full-width model at frame_size=512 from WAV bytes,
    at 'auto' and 'pallas' (both take K3: kv_len 512, and K4's gate fails
    at T = 512) and at 'xla' (the composed path) for the comparison, of
    the outputs and of the request's time without K3."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.inference.api import (
        generate_facial_data_from_bytes)
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import (
        Seq2Seq, init_seq2seq)
    from neurosync_trainer_lite_tpu_torch.ops import kernels
    from neurosync_trainer_lite_tpu_torch.utils.audio_io import audio_to_bytes

    cfg = Config(dropout=0.0, frame_size=512)
    models = {"auto": init_seq2seq(cfg, torch.Generator(device="cuda")
                                   .manual_seed(0), device="cuda").eval()}
    for impl in ("pallas", "xla"):
        models[impl] = Seq2Seq(cfg.replace(attention_impl=impl), "cuda")
        models[impl].load_state_dict(models["auto"].state_dict())
        models[impl].eval()
    rng = np.random.default_rng(0)
    wav = audio_to_bytes(rng.standard_normal(cfg.sr * SERVE_SECONDS)
                         .astype(np.float32) * 0.3, cfg.sr)
    batch = serving_shape(cfg)[0]
    print(f"serve (s2): frame_size {cfg.frame_size}, overlap {cfg.overlap}: "
          f"the 30 s request decodes as [{batch}, {cfg.frame_size}]",
          flush=True)
    expected = {"auto": {"rope_rotate": 50, "flash_attention": 24},
                "pallas": {"rope_rotate": 50, "flash_attention": 24},
                "xla": {"rope_rotate": 50}}
    for model in models.values():
        generate_facial_data_from_bytes(wav, model, cfg)
    torch.cuda.synchronize()

    kernels.reset_launches()
    launches, outputs = {}, {}
    for impl, model in models.items():
        before = dict(kernels.LAUNCHES)
        outputs[impl] = generate_facial_data_from_bytes(wav, model, cfg)
        launches[impl] = {name: count - before.get(name, 0)
                          for name, count in kernels.LAUNCHES.items()
                          if count - before.get(name, 0)}
    main_path = dict(kernels.LAUNCHES)
    for impl, out in outputs.items():
        check(launches[impl] == expected[impl],
              f"(s2) kernel launches of one request at '{impl}': "
              f"{launches[impl]} == {expected[impl]}")
        check(out.shape == (1801, 61) and bool(np.isfinite(out).all()),
              f"(s2) 30 s request at '{impl}': {out.shape} finite frames")
    ref = outputs["xla"]
    for impl in ("auto", "pallas"):
        e, scale = float(np.abs(outputs[impl] - ref).max()), float(
            np.abs(ref).max())
        check(e <= 0.05 * scale,
              f"(s2) '{impl}' (K3) and 'xla' agree within 5% of max|out| "
              f"(max abs diff {e}, max|out| {scale})")
    for impl, model in models.items():
        request_timing(torch, np, model, cfg, wav, f"'{impl}', frame_size 512")
    del models
    torch.cuda.empty_cache()
    return main_path


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
        request_timing(torch, np, model, cfg, clips["30 s seeded"],
                       f"'{impl}'")
    return main_path


def request_timing(torch, np, model, cfg, wav: bytes, label: str) -> None:
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
    print(f"30 s request at {label}: {len(out)} frames, median {med:.3f} ms "
          f"(quartiles {q1:.3f}, {q3:.3f}) of 11, "
          f"{len(out) / med * 1e3:.1f} frames/s", flush=True)

    y, _ = decode_bytes_to_waveform(wav, cfg)
    with torch.inference_mode():
        pcm = torch.from_numpy(y.copy())
        feats, fe_ms, _, _ = wall_ms(lambda: extract_features(
            widen_and_normalize(pcm.cuda()), cfg.sr))
        batch = serving_shape(cfg)[0]
        chunks = feats[:cfg.frame_size].expand(batch, -1, -1).contiguous()
        _, dec_ms, _, _ = wall_ms(lambda: model(chunks))
    _, wav_ms, _, _ = wall_ms(lambda: decode_bytes_to_waveform(wav, cfg))
    print(f"stages of the request at {label} (median of 11, host clock, "
          f"synchronised): WAV decode {wav_ms:.3f} ms, upload + frontend "
          f"{fe_ms:.3f} ms, decode forward [{batch}, {cfg.frame_size}, "
          f"{cfg.input_dim}] {dec_ms:.3f} ms",
          flush=True)

    profile_once(torch, lambda: generate_facial_data_from_bytes(wav, model, cfg),
                 f"request at {label}", top=8)


def train_batch(torch, cfg, gen):
    """Seeded random features and blendshape-range targets, never zeros (an
    all-zero batch gives every LayerNorm a zero variance)."""
    B, T = cfg.batch_size, cfg.micro_batch_size
    return (torch.randn(B, T, cfg.input_dim, device="cuda", generator=gen),
            torch.rand(B, T, cfg.output_dim, device="cuda", generator=gen))


def train_config(torch, cfg, weights, src, trg, label, expected, *,
                 warmup, timed, profile=True, falls=True):
    """Steps of cfg from `weights` on one fixed batch: `warmup` steps, one
    step whose kernel launches are counted from zero (the main path run)
    and must equal `expected`, then `timed` steps. Every step's loss and
    grad norm must be finite. Returns (launches, [(loss, norm)] of every
    step, peak device memory in bytes, median step seconds or None, device
    ms by kernel name of the profiled step or None)."""
    from neurosync_trainer_lite_tpu_torch.ops import kernels
    from neurosync_trainer_lite_tpu_torch.training.step import (
        init_train_state, make_eval_step, make_train_step)

    B = src.shape[0]
    state = init_train_state(cfg, 1000, device="cuda", state_dict=weights)
    step, evaluate = make_train_step(cfg), make_eval_step(cfg)
    steps = torch.Generator().manual_seed(4)
    before = float(evaluate(state.model, src, trg)) if falls else None
    torch.cuda.reset_peak_memory_stats()
    history = []

    def one_step():
        _, loss, norm = step(state, src, trg, steps)
        loss, norm = float(loss), float(norm)
        check(math.isfinite(loss) and math.isfinite(norm),
              f"train {label}: finite loss {loss:.6f} and grad norm "
              f"{norm:.6f}")
        history.append((loss, norm))

    for _ in range(warmup):
        one_step()
    torch.cuda.synchronize()
    kernels.reset_launches()
    one_step()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(launches == expected, f"kernel launches of one training step at "
          f"{label}: {launches} == {expected}")
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    med = None
    if timed >= 2:
        q1, med, q3 = statistics.quantiles(times, n=4)
        print(f"train {label}: step median {med * 1e3:.3f} ms (quartiles "
              f"{q1 * 1e3:.3f}, {q3 * 1e3:.3f}) of {timed}, "
              f"{B / med:.1f} samples/s (quartiles {B / q3:.1f}, "
              f"{B / q1:.1f}), peak device memory {peak} bytes "
              f"({peak / 2 ** 30:.3f} GiB)", flush=True)
    else:
        print(f"train {label}: peak device memory {peak} bytes "
              f"({peak / 2 ** 30:.3f} GiB)", flush=True)
    profiled = profile_once(torch, lambda: step(state, src, trg, steps),
                            f"step at {label}", top=10) if profile else None
    if falls:
        after = float(evaluate(state.model, src, trg))
        check(after < before, f"train {label}: the fixed batch's loss "
              f"(dropout off) fell from {before:.6f} to {after:.6f}")
    del state, step, evaluate
    torch.cuda.empty_cache()
    return launches, history, peak, med, profiled


def train(torch):
    """Phase 8: the full-width training step at (a) 'auto', dropout 0.3 and
    (b) 'pallas', dropout 0, from the same seeded weights and batch; then
    (e) and the long windows. Returns (the main path's launch counts by
    run, {'samples_per_s', 'peak'} of (a))."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq
    from neurosync_trainer_lite_tpu_torch.ops import fused_attention as fua

    configs = {"a": Config(), "b": Config(attention_impl="pallas",
                                          dropout=0.0)}
    expected = {"a": {"rope_rotate": 100},
                "b": {"rope_rotate": 52, "fused_rope_attention": 24,
                      "fused_rope_attention_bwd": 24}}
    base = configs["a"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    weights = init_seq2seq(base, gen, device="cuda").state_dict()
    src, trg = train_batch(torch, base, gen)
    print(f"train: batch {base.batch_size} x {base.micro_batch_size} frames "
          f"x {base.input_dim} → {base.output_dim}, bf16 over fp32, lr "
          f"{base.learning_rate}, clip {base.grad_clip}, {TRAIN_WARMUP} "
          f"warm-up + {TRAIN_TIMED} timed steps", flush=True)

    main_path, step_a = {}, {}
    for name, cfg in configs.items():
        label = f"({name}) '{cfg.attention_impl}', dropout {cfg.dropout}"
        launches, _, peak, med, profiled = train_config(
            torch, cfg, weights, src, trg, label, expected[name],
            warmup=TRAIN_WARMUP, timed=TRAIN_TIMED)
        main_path[f"train ({name})"] = launches
        if name == "a":
            step_a = {"samples_per_s": cfg.batch_size / med, "peak": peak}
        else:
            kernel_shares(f"step at {label}", profiled, {
                "K4 backward": (r"attn_bwd_mma_kernel", r"attn_bwd_kernel<"),
                "K4 forward": (r"attn_fwd_mma_kernel", r"attn_fwd_kernel<"),
                "K1": (r"rope_rows", None)})

    sound = fua.fused_rope_attention_bwd_cuda

    def lose_head0_dq(q, k, v, do, tables, num_heads, scale):
        dq, dk, dv = sound(q, k, v, do, tables, num_heads, scale)
        dq[..., :q.shape[-1] // num_heads] = 0
        return dq, dk, dv

    attention_gradients_in_model(
        torch, configs["b"], weights, src, trg, composed="auto",
        kernel="pallas", module=fua, wrapper="fused_rope_attention_bwd_cuda",
        planted=lose_head0_dq, what="K4")
    main_path.update(train_ffn_fused(torch, configs["a"], weights, src, trg))
    main_path.update(train_long_windows(torch, weights))
    return main_path, step_a


def train_ffn_fused(torch, cfg, weights, src, trg):
    """Phase 10 (e): step (a) with the model's FFN routed through ffn_fused
    (seq2seq._ffn rebound, as tools/tpu_probe.py rebinds the JAX model's),
    so that the FFN backward runs K2: K2 = 16 (8 + 8 FFNs) and K1 = 100
    launches a step, samples/s, peak memory and busy share beside (a); one
    step with the default _ffn again runs no K2. Then K2's gradients inside
    the model at dropout 0 against the default path and fp32, with a
    planted fault (db1 zeroed) that the check must catch."""
    from neurosync_trainer_lite_tpu_torch.models import seq2seq
    from neurosync_trainer_lite_tpu_torch.ops import ffn_bwd

    default = seq2seq._ffn
    seq2seq._ffn = ffn_bwd.ffn_fused
    label = (f"(e) '{cfg.attention_impl}', dropout {cfg.dropout}, FFN "
             f"backward through K2")
    try:
        launches, *_, profiled = train_config(
            torch, cfg, weights, src, trg, label,
            {"rope_rotate": 100, "ffn_bwd_dh1": 16},
            warmup=TRAIN_WARMUP, timed=TRAIN_TIMED)
    finally:
        seq2seq._ffn = default
    kernel_shares(f"step at {label}", profiled, {
        "K2": (r"ffn_bwd_wgmma_kernel", r"ffn_bwd_wmma_kernel"),
        "K1": (r"rope_rows", None)})
    train_config(torch, cfg, weights, src, trg, "(e) with the default _ffn "
                 "again", {"rope_rotate": 100}, warmup=0, timed=0,
                 profile=False, falls=False)

    sound = ffn_bwd.ffn_bwd_dh1_cuda

    def zero_db1(dy, w2, am, *, scale):
        dh1, db2, db1 = sound(dy, w2, am, scale=scale)
        return dh1, db2, torch.zeros_like(db1)

    c0 = cfg.replace(dropout=0.0)
    fused = [(seq2seq, "_ffn", ffn_bwd.ffn_fused)]
    gradients_in_model(
        torch, weights, src, trg, fp32=(c0.replace(use_amp=False), []),
        baseline=("the default _ffn", c0, []),
        kernel=("ffn_fused", c0, fused),
        planted=(c0, fused + [(ffn_bwd, "ffn_bwd_dh1_cuda", zero_db1)]),
        leaves=r"\.ffn\.linear[12]\.(weight|bias)$",
        leaf_kind="FFN linear1/linear2 weight and bias", what="K2",
        fault="zeroes db1")
    return {"train (e)": launches}


def train_long_windows(torch, weights):
    """Phase 9: the full-width model at long windows, where 'auto' takes
    K3: (c) window 512, batch 32, no remat; (d) window 2048 (MAX_KV_LEN),
    batch 8, with and without remat, and one step each at remat_policy
    'dots' and at remat_scope='decoder', remat_layers=2. Each holds 16,384
    frames a step, as (a) and (b)."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    main_path = {}

    def k3(fwd, bwd=24, rope=100):
        return {"rope_rotate": rope, "flash_attention": fwd,
                "flash_attention_bwd_dq": bwd, "flash_attention_bwd_dkdv": bwd}

    cfg_c = Config(dropout=0.0, batch_size=32, micro_batch_size=512)
    src, trg = train_batch(torch, cfg_c, gen)
    print(f"train (c): batch 32 x 512 frames, 'auto', dropout 0, no remat, "
          f"{TRAIN_WARMUP} warm-up + {TRAIN_TIMED} timed steps", flush=True)
    label = "(c) window 512, 'auto'"
    main_path["train (c)"], *_, profiled = train_config(
        torch, cfg_c, weights, src, trg, label, k3(24),
        warmup=TRAIN_WARMUP, timed=TRAIN_TIMED)
    # K3's share, all of it the tensor-core kernels'
    kernel_shares(f"step at {label}", profiled, {
        f"K3 {part}": (rf"flash_{part}_mma_kernel", rf"flash_{part}_kernel")
        for part in ("fwd", "bwd_dq", "bwd_dkdv")})

    sound = fa.flash_attention_bwd_cuda

    def lose_head0_dq(q, k, v, do, scale):
        dq, dk, dv = sound(q, k, v, do, scale)
        dq[:, 0] = 0
        return dq, dk, dv

    attention_gradients_in_model(
        torch, cfg_c, weights, src, trg, composed="xla", kernel="auto",
        module=fa, wrapper="flash_attention_bwd_cuda", planted=lose_head0_dq,
        what="K3")
    del src, trg
    torch.cuda.empty_cache()

    cfg_d = Config(dropout=0.0, batch_size=8, micro_batch_size=2048)
    src, trg = train_batch(torch, cfg_d, gen)
    # the rematted layers launch their forward kernels again in the
    # backward: K3 forward once per attention, K1 twice (q and k)
    runs = {
        "no remat": (cfg_d, k3(24), 1, 3),
        "remat 'all'": (cfg_d.replace(remat=True), k3(48, rope=148), 1, 3),
        "remat 'dots'": (cfg_d.replace(remat=True, remat_policy="dots"),
                         k3(48, rope=148), 0, 0),
        "remat 'decoder', 2 layers": (
            cfg_d.replace(remat=True, remat_scope="decoder", remat_layers=2),
            k3(28, rope=108), 0, 0),
    }
    print("train (d): batch 8 x 2048 frames, 'auto', dropout 0", flush=True)
    results = {}
    for name, (cfg, expected, warmup, timed) in runs.items():
        launches, history, peak, *_ = train_config(
            torch, cfg, weights, src, trg, f"(d) window 2048, {name}",
            expected, warmup=warmup, timed=timed, profile=timed > 0,
            falls=False)
        main_path[f"train (d) {name}"] = launches
        results[name] = (history, peak)
    ref_history, ref_peak = results["no remat"]
    for name, (history, peak) in results.items():
        if name == "no remat":
            continue
        pairs = list(zip(history, ref_history))
        gap = max(max(abs(a - b) / abs(b) for a, b in zip(x, y))
                  for x, y in pairs)
        bitwise = all(x == y for x, y in pairs)
        check(gap <= 1e-6, f"train (d) {name}: loss and grad norm of "
              f"{len(pairs)} step(s) equal the no-remat run's (largest "
              f"relative difference {gap:.3e}, bitwise {bitwise})")
        what = (f"train (d) {name}: peak device memory "
                f"{peak / 2 ** 30:.3f} GiB against no remat's "
                f"{ref_peak / 2 ** 30:.3f} GiB")
        if "dots" in name:   # keeps the products' fp32 outputs: printed
            print(what, flush=True)
        else:
            check(peak < ref_peak, what)
    del src, trg
    torch.cuda.empty_cache()
    return main_path


def train_entry_point(torch, np, step_a) -> None:
    """Phase 11 (f): the training entry point at full width on the repo's
    real capture. train_model(Config(...)) on a temporary copy of
    dataset/data (its features extracted by the device frontend; nothing
    written into the checkout), validating on dataset/test_set each epoch:
    2 epochs, then a resume for a third. Checks finite losses, a lower mean
    loss in the third epoch than in the first, batch_step and Adam's step
    count continuing across the resume, the checkpoint directory (meta.json,
    backup_*), model.pth, the validation CSVs and stats, and that model.pth
    serves dataset/test_set/audio.wav to finite [T, 61] frames. Prints the
    loop's seconds and samples/s per epoch beside step (a)'s, the feature
    extraction time, the gather used, checkpoint save times and bytes, and
    the planner's estimate beside (a)'s measured peak. Then runs the CLI
    (python -m neurosync_trainer_lite_tpu_torch.train) for 1 epoch of 2
    steps in a subprocess."""
    import os
    import shutil
    import tempfile

    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.data import native
    from neurosync_trainer_lite_tpu_torch.data.processing import (
        extract_audio_features)
    from neurosync_trainer_lite_tpu_torch.inference.api import (
        generate_facial_data_from_bytes)
    from neurosync_trainer_lite_tpu_torch.training import checkpoint as ckpt
    from neurosync_trainer_lite_tpu_torch.training.loop import (
        estimate_step_hbm_bytes, train_model)
    from neurosync_trainer_lite_tpu_torch.training.step import opt_step_count
    from neurosync_trainer_lite_tpu_torch.utils.weights import load_model

    capture = REPO / "dataset" / "data"
    test_set = REPO / "dataset" / "test_set"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        data = os.path.join(tmp, "data")
        shutil.copytree(capture, data,
                        ignore=shutil.ignore_patterns("audio_features.csv"))
        out = os.path.join(tmp, "out")
        cfg = Config(root_dir=data, n_epochs=2,
                     audio_path=str(test_set / "audio.wav"),
                     ground_truth_path=str(test_set / "testset.csv"),
                     model_path=os.path.join(out, "model.pth"),
                     checkpoint_path=os.path.join(out, "checkpoints",
                                                  "checkpoint"),
                     plots_dir=os.path.join(tmp, "plots"))
        wav = next(capture.glob("*/audio.wav"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats, _ = extract_audio_features(str(wav), cfg.sr, device="cuda")
        torch.cuda.synchronize()
        print(f"(f) {wav.relative_to(REPO)}: features {feats.shape} from the "
              f"device frontend in {time.perf_counter() - t0:.3f} s (decode "
              f"+ upload + frontend + download); window gather on this "
              f"machine: "
              f"{'native' if native.load_library() is not None else 'numpy'}",
              flush=True)

        history = {}
        t0 = time.perf_counter()
        state, steps = train_model(cfg, device="cuda", history_out=history)
        first_run = time.perf_counter() - t0
        resumed, total = train_model(cfg.replace(mode="resume", n_epochs=3),
                                     device="cuda", history_out=history)
        torch.cuda.synchronize()
        per_epoch = steps // 2
        losses = history["train_losses"]
        check(len(losses) == total == 3 * per_epoch > 0
              and all(math.isfinite(x) for x in losses + history["val_losses"]
                      + history["grad_norms"]),
              f"(f) {total} finite training steps over 3 epochs "
              f"({per_epoch} a epoch), {len(history['val_losses'])} finite "
              f"validation losses")
        means = [float(np.mean(losses[i * per_epoch:(i + 1) * per_epoch]))
                 for i in range(3)]
        check(means[2] < means[0], f"(f) mean training loss by epoch "
              f"{[round(m, 6) for m in means]}: the third below the first")
        check(steps == 2 * per_epoch and opt_step_count(resumed) == total,
              f"(f) batch_step {steps} after 2 epochs continues to {total} "
              f"after the resume, Adam's step count "
              f"{opt_step_count(resumed)}")
        parent = os.path.dirname(cfg.checkpoint_path)
        backups = [d for d in os.listdir(parent) if d.startswith("backup_")]
        stats = os.listdir(os.path.join(cfg.plots_dir, "stats"))
        csvs = [f for f in os.listdir(cfg.plots_dir)
                if f.startswith("generated_facial_data_epoch_")]
        check(os.path.exists(os.path.join(cfg.checkpoint_path, "meta.json"))
              and len(backups) == 2 and os.path.exists(cfg.model_path)
              and len(stats) == len(csvs) == 3,
              f"(f) meta.json, {len(backups)} backups, model.pth, "
              f"{len(csvs)} validation CSVs and {len(stats)} stats files")
        model = load_model(cfg.model_path, Config(), device="cuda")
        frames = generate_facial_data_from_bytes(
            (test_set / "audio.wav").read_bytes(), model, Config())
        check(isinstance(frames, np.ndarray) and frames.ndim == 2
              and frames.shape[1] == 61 and bool(np.isfinite(frames).all()),
              f"(f) the exported model.pth loads strictly and serves "
              f"test_set/audio.wav: {frames.shape} finite frames")
        for i, (sec, n) in enumerate(zip(history["epoch_seconds"],
                                         history["epoch_samples"])):
            print(f"(f) epoch {i + 1}: {sec:.3f} s, {n} samples, "
                  f"{n / sec:.1f} samples/s as the loop counts them (step "
                  f"(a) alone: {step_a['samples_per_s']:.1f} samples/s)",
                  flush=True)
        print(f"(f) first train_model call (data, init, 2 epochs, "
              f"validation, checkpoints): {first_run:.3f} s", flush=True)

        for async_save in (False, True):
            path = os.path.join(tmp, f"save_{async_save}", "checkpoint")
            t0 = time.perf_counter()
            state_file = ckpt.save_checkpoint(resumed, 2, total, cfg, path,
                                              async_save=async_save)
            returned = time.perf_counter() - t0
            ckpt.wait_for_pending_saves()
            done = time.perf_counter() - t0
            print(f"(f) {'async' if async_save else 'sync'} checkpoint save: "
                  f"{os.path.getsize(state_file)} bytes, returned after "
                  f"{returned:.3f} s, on disk after {done:.3f} s", flush=True)
        print(f"(f) the planner's estimate for Config(): "
              f"{estimate_step_hbm_bytes(Config())} bytes; step (a)'s "
              f"measured peak {step_a['peak']} bytes", flush=True)
        del state, resumed, model
        torch.cuda.empty_cache()

        cli_out = os.path.join(tmp, "cli")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "neurosync_trainer_lite_tpu_torch.train",
             "--root_dir", data, "--n_epochs", "1",
             "--max_steps_per_epoch", "2",
             "--audio_path", cfg.audio_path,
             "--ground_truth_path", cfg.ground_truth_path,
             "--model_path", os.path.join(cli_out, "model.pth"),
             "--checkpoint_path", os.path.join(cli_out, "ck", "checkpoint"),
             "--plots_dir", os.path.join(cli_out, "plots")],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        print(proc.stdout[-1500:], flush=True)
        check(proc.returncode == 0
              and os.path.exists(os.path.join(cli_out, "model.pth")),
              f"(f) python -m neurosync_trainer_lite_tpu_torch.train, 1 epoch "
              f"of 2 steps: exit {proc.returncode}, model.pth written, "
              f"{time.perf_counter() - t0:.3f} s"
              + (f"\n{proc.stderr[-3000:]}" if proc.returncode else ""))


def attention_gradients_in_model(torch, cfg, weights, src, trg, *, composed,
                                 kernel, module, wrapper, planted,
                                 what) -> None:
    """An attention kernel's gradients inside the model: one step of cfg
    (dropout 0) at the `composed` impl, where attention takes the lean
    composed core, and at the `kernel` impl, where it takes the kernel
    (`what`) forward and backward, each held against the same step in fp32
    at `composed`; a planted fault, the kernel's backward (module.wrapper)
    losing head 0's dq, must be caught (gradients_in_model)."""
    gradients_in_model(
        torch, weights, src, trg,
        fp32=(cfg.replace(attention_impl=composed, use_amp=False), []),
        baseline=(f"'{composed}'", cfg.replace(attention_impl=composed), []),
        kernel=(f"'{kernel}'", cfg.replace(attention_impl=kernel), []),
        planted=(cfg.replace(attention_impl=kernel),
                 [(module, wrapper, planted)]),
        leaves=r"\.[qkv]_linear\.weight$",
        leaf_kind="attention q/k/v weight", what=what,
        fault="loses head 0's dq")


def gradients_in_model(torch, weights, src, trg, *, fp32, baseline, kernel,
                       planted, leaves, leaf_kind, what, fault) -> None:
    """A kernel's gradients inside the model: one step (dropout 0) on the
    `baseline` path, which does not run the kernel, and on the `kernel`
    path, which does, from the same weights and batch, each also held
    against the `fp32` step (plain autograd, TF32 off). Each path is (label,
    cfg, patches), patches being (object, attribute, value) set for that
    step only. Their loss and pre-clip grad norm must agree.

    Per leaf (parameter names matching `leaves`), err = ‖g − g_fp32‖ /
    ‖g_fp32‖. bf16 elsewhere in the model sets a leaf's err on either path
    (up to ~0.15 where a small gradient cancels), so the check reads the
    excess err(kernel) − err(baseline): the kernels do their math in fp32,
    so no leaf may lie further from fp32 with the kernel than without by
    more than EXCESS_LIMIT. The `planted` path (cfg, patches), a kernel
    with a planted fault, must exceed it; the global grad norm hides such
    a fault."""
    from neurosync_trainer_lite_tpu_torch.training.step import (
        init_train_state, make_train_step)

    def one_step(c, patches):
        saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
        for obj, name, value in patches:
            setattr(obj, name, value)
        try:
            state = init_train_state(c, 1000, device="cuda",
                                     state_dict=weights)
            _, loss, norm = make_train_step(c)(
                state, src, trg, torch.Generator().manual_seed(4))
            loss, norm = float(loss), float(norm)
        finally:
            for obj, name, value in saved:
                setattr(obj, name, value)
        # the step clipped every gradient by min(1, clip / norm): undo it
        unclip = max(1.0, norm / c.grad_clip)
        grads = {name: p.grad * unclip
                 for name, p in state.model.named_parameters()
                 if re.search(leaves, name)}
        del state
        torch.cuda.empty_cache()
        return loss, norm, grads

    lc, lk = baseline[0], kernel[0]
    ref = one_step(*fp32)
    runs = {lc: one_step(*baseline[1:]), lk: one_step(*kernel[1:]),
            f"{lk}, planted fault": one_step(*planted)}
    err = {label: {n: float((grads[n] - g).norm() / g.norm())
                   for n, g in ref[2].items()}
           for label, (_, _, grads) in runs.items()}
    excess = {}
    for label, (loss, norm, _) in runs.items():
        worst = max(err[label], key=err[label].get)
        excess[label] = max((e - err[lc][n], n)
                            for n, e in err[label].items())
        print(f"one step at dropout 0, bf16 at {label}: loss {loss:.6f}, "
              f"grad norm {norm:.6f} (fp32: {ref[0]:.6f}, {ref[1]:.6f}); "
              f"{leaf_kind} gradients against fp32: worst err "
              f"{err[label][worst]:.3e} ({worst}), worst excess over {lc} "
              f"{excess[label][0]:.3e} ({excess[label][1]})", flush=True)
    (la, na, _), (lp, np_, _) = runs[lc], runs[lk]
    loss_gap, norm_gap = abs(lp - la) / abs(la), abs(np_ - na) / na
    check(loss_gap <= 1e-3 and norm_gap <= 1e-2,
          f"one step at dropout 0: {lc} and {lk} agree within 1e-3 in "
          f"loss ({loss_gap:.3e}) and 1e-2 in grad norm ({norm_gap:.3e})")
    sound_gap = excess[lk][0]
    check(sound_gap <= EXCESS_LIMIT,
          f"one step at dropout 0: no {leaf_kind} gradient lies further "
          f"from fp32 at {lk} ({what}) than at {lc} by more than "
          f"{EXCESS_LIMIT:g} ({sound_gap:.3e})")
    fault_gap = excess[f"{lk}, planted fault"][0]
    fault_norm = runs[f"{lk}, planted fault"][1]
    check(fault_gap > EXCESS_LIMIT,
          f"a {what} backward that {fault} fails that check "
          f"({fault_gap:.3e}; its grad norm moves "
          f"{abs(fault_norm - np_) / np_:.3e})")


def profile_once(torch, fn, label: str, top: int) -> dict[str, float]:
    """The card's busy share and top kernels of one call (profiler on).
    Returns the call's device ms by kernel name."""
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
    return {e.key: e.self_device_time_total / 1e3 for e in events}


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--only", choices=("serve-s2",),
        help="build the kernels and run phase 7b alone, printing no result "
             "line: to time the (s2) request of two trees side by side")
    args = parser.parse_args()
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
    sass_counts(kernels)
    if args.only == "serve-s2":
        serve_long(torch, np)
        print(card, flush=True)
        return 0

    source = "neurosync_trainer_lite_tpu_torch/csrc/"
    records = {
        "rope_rotate": dict(
            route="cuda", source=source + "rope.cu",
            replaces="neurosync_trainer_lite_tpu/ops/rope_pallas.py:51",
            tolerance="bitwise"),
        "fused_rope_attention": dict(
            route="cuda", source=source + "fused_attention.cu",
            replaces="neurosync_trainer_lite_tpu/ops/fused_attention.py:169",
            tolerance="2^-7*|plain|+1e-4*max|plain| (bf16), "
                      "1e-5*|plain|+1e-6 (fp32)"),
        "fused_rope_attention_bwd": dict(
            route="cuda", source=source + "fused_attention.cu",
            replaces="neurosync_trainer_lite_tpu/ops/fused_attention.py:186",
            tolerance="2^-7*|plain|+1e-4*max|plain| (bf16), "
                      "1e-5*|plain|+1e-4*max|plain| (fp32)"),
        "flash_attention": dict(
            route="cuda", source=source + "flash_attention.cu",
            replaces="neurosync_trainer_lite_tpu/ops/flash_attention.py:71",
            tolerance="2^-7*|plain|+2^-9*max|plain| (bf16), "
                      "1e-5*max|plain| (fp32)"),
        "flash_attention_bwd": dict(
            route="cuda", source=source + "flash_attention.cu",
            replaces="neurosync_trainer_lite_tpu/ops/flash_attention.py:136",
            tolerance="2^-7*|plain|+2^-9*max|plain| (bf16), "
                      "1e-5*max|plain| (fp32)",
            launch_names=["flash_attention_bwd_dq",
                          "flash_attention_bwd_dkdv"]),
        "ffn_bwd_dh1": dict(
            route="cuda", source=source + "ffn_bwd.cu",
            replaces="neurosync_trainer_lite_tpu/ops/ffn_bwd_pallas.py:115",
            tolerance="dh1 2^-7*|plain|+1e-5*max|plain|; db2, db1 "
                      "2e-4*max|plain|"),
    }
    rounding_contracts(torch)
    kernel_checks(torch, records)
    k3_checks(torch, records)
    k2_checks(torch, records)
    reference_goldens(torch, np)
    paths = {"serve": serve(torch, np), "serve (s2)": serve_long(torch, np)}
    train_paths, step_a = train(torch)
    paths.update(train_paths)
    train_entry_point(torch, np, step_a)
    for counts in paths.values():   # the K3 backward's two kernels
        check(counts.get("flash_attention_bwd_dq", 0)
              == counts.get("flash_attention_bwd_dkdv", 0),
              "the K3 backward launched its two kernels alike")
        if "flash_attention_bwd_dq" in counts:
            counts["flash_attention_bwd"] = counts["flash_attention_bwd_dq"]
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
         "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
         "shape": r["shape"], "tolerance": r["tolerance"],
         **{key: r[key] for key in ("by_shape", "launch_names") if key in r}}
        for name, r in records.items()]}
    print(json.dumps(kernel_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

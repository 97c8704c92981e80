#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only serve-s2   # phases 1, 2 and 7b alone
    python3 chip_smoke.py --only live       # phases 1, 2 and 7c alone
    python3 chip_smoke.py --only parallel   # phases 1, 2 and 12 alone
    python3 chip_smoke.py --only tensor     # phases 1, 2 and 13 alone
    python3 chip_smoke.py --only compat     # phases 1, 2 and 14 alone
    python3 chip_smoke.py --only tools      # phases 1, 2 and 15 alone
    python3 chip_smoke.py --only ln         # phases 1, 2, 4 and 5 alone
    python3 chip_smoke.py --only la         # the same for the lean attention
    python3 chip_smoke.py --only ffn        # the same for the FFN epilogue

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
   on the MUFU. The LayerNorm and the lean attention kernels (ln_checks,
   la_checks) run both phases at their own shapes; la_checks holds the
   lean attention pair against its plain pair at every training site's
   [128, 16, 128, 64] and a tp = 2 rank's [128, 8, 128, 64] and times it
   beside SDPA with dropout_p 0.3 (the `lean_attention` record). The FFN
   epilogue kernels (ffn_checks) are held against their plain versions at
   the training FFNs' [16384, 4096] (ReLU q 77 and 0, GELU q 26 and 0) and
   a tp = 2 rank's column block, and each entry point timed at that shape
   (the `ffn_epilogue` record).
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
7c. Live serving at full width, 'auto' and 'pallas' (the same seeded
   weights): K1 and the K4 forward first at the live decode batches [1,
   128, 1024] and [8, 128, 1024] against their plain versions; then one
   MultiStreamer of 8 sessions (default trim settings, warmed up), each
   fed its own seeded 30 s clip in 0.5 s pushes (four int16, four
   float32), opened 3 ticks apart, one tick() a round of pushes, then
   flushed and closed: the main path run, launches counted from zero and
   asserted (K1 50 a decode forward at 'auto'; K1 2 and the K4 forward 24
   at 'pallas'). Prints the tick p50, p95 and max (metrics_snapshot),
   decode ticks, frames out and frames/s across the sessions. Checks
   ring_recoveries and watchdog_flips 0; each session's frames against an
   independent BlendshapeStreamer fed the same pushes (bf16: within 5% of
   max|out|, as 'auto' against 'pallas'; again in fp32 for two 10 s
   sessions: within 1e-4 of max|out|), against the offline API over its
   whole clip on the core rows (the CMVN drift of a trimmed buffer:
   correlation ≥ 0.98, mean abs error ≤ 5% of max|out|), and 'auto'
   against 'pallas' within 5%. Then the card's busy share and top kernels
   of a profiled repeat, one session at real-time cadence for 10 s (0.5 s
   pushes with sleeps: the push → frames time and how far the frames
   trail the audio), and the HTTP server on 127.0.0.1 in a thread: the
   batch endpoint equal to the API, an s16 session opened, pushed,
   flushed and closed, /metrics and /healthz.
8. Trains the full-width model (16,384 frames a step, seeded random
   features and targets, the same seeded weights): (a) Config(): 'auto',
   dropout 0.3; (b) 'pallas', dropout 0, which runs the K4 forward and
   backward; (c) window 512 x batch 32, dropout 0, 'auto', which runs K3.
   Checks a finite loss and grad norm at every step, the fixed batch's
   loss (dropout off) lower after the steps than before, and the kernel
   launch counts of one step (K1 = 100 and the lean attention forward and
   backward 24 each at (a); K1 = 52, K4 forward = 24,
   K4 backward = 24 at (b); K1 = 100, K3 forward 24 and backward 24 + 24
   at (c)). One step of (a) with remat=True launches the lean attention
   forward 48 times and its backward 24, and its loss, grad norm and
   every gradient equal the step's without remat (relative 1e-6).
   Prints samples/s (median and quartiles of 10 steps after 3
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
10. (e) Step (a) with seq2seq._ffn rebound to models/layers.py:ffn_fused, so
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
   model.pth serving the test clip; (c5) utils/epoch_stats.py reading the
   3 epochs' stats files (61 dimensions each) and its plot raising
   ImportError without matplotlib; then the CLI
   (python -m neurosync_trainer_lite_tpu_torch.train) for 2 steps.
12. Data parallelism (parallel/), every rank a subprocess of this script
   (--parallel-worker) with a deadline and a process-group timeout, the
   kernels built first by this process. (p1) One rank over NCCL: 3 steps
   of (a) through the group and its all-reduce equal 3 steps with no group
   bit for bit (losses, grad norms, every parameter); the same process
   also takes the one-process references of (p2). (p2) Two ranks on the
   one card over gloo (NCCL refuses two ranks on one card; gloo reduces
   CUDA tensors), 64 rows each: 3 steps at 'pallas', dropout 0 (K4
   forward and backward), at 'auto', dropout 0.3, and at 'auto', dropout
   0.3 with grad_accum_steps 2: the two ranks' losses, grad norms and
   parameter checksums bitwise equal, and within 1e-3 (loss) and 1e-2
   (grad norm) relative of one process on the whole batch. Prints step ms
   and peak memory per rank and the all-reduce's ms (the fp32 gradient
   through the host). (p3) MeshDecoder over the two ranks on the 30 s
   request's 17 chunks, 'auto' and 'pallas' in bf16 (5% of max|out|) and
   'auto' in fp32 (1e-4), standalone and through process_audio_features,
   against one rank's decode_chunks_batched. (p4) train_model at dp 2 on
   a copy of dataset/data: one epoch, a checkpoint and a resume for a
   second, the ranks' histories equal, rank 0's model.pth serving
   test_set/audio.wav; epoch seconds. (p2)-(p4) share one card, so they
   measure correctness and the reduction's cost, not scaling.
13. Tensor parallelism (parallel/tensor.py, the 'model' axis), every
   process a subprocess of this script. (t1) In a process of its own, the
   kernels at a tp = 2 rank's shapes of the full-width model (8 of the 16
   heads, 2048 of the 4096 FFN columns), against their plain versions and
   timed beside their bounds: K1 (bitwise) and the K4 forward at [17 |
   128, 128, 512], the K4 backward at [128, 128, 512], K3 forward and
   backward at [32, 8, 512, 64], K2 at [16384, 1024, 2048] (on the wgmma
   kernel); checked, untimed, at the other shapes the phase gives them
   (K1 at 32 and 8 rows in bf16 and 17 in fp32, K4 at 32, K2 at M = 4096
   and 1024 on the wgmma kernel). Then ranks as subprocesses over gloo on
   the one card, every rank at the full width with its shard: (t2) MeshDecoder at (dp, tp) =
   (1, 2) on the 30 s request's 17 chunks, bf16 within 5% and fp32 within
   TP_DECODE_FP32_LIMIT of max|out| of one process's decode; (t3) 3 steps
   at tp 2, batch 32 x 128, at 'pallas', dropout 0 (K4) and 'auto',
   dropout 0.3 with the FFN through K2 (K1, K2): per rank the launches of
   each step (K1 52, K4 24 + 24; K1 100, K2 16) and its 'model'
   all-reduces (40 forward, 88 backward, 1 for the grad norm) asserted,
   the first step within TP_FIRST_STEP_LIMITS of one process on the same
   weights and rows, which two planted faults (a column-parallel backward
   without its all-reduce; masks drawn at the local width) must exceed,
   the replicated leaves bitwise equal across the ranks; prints the step
   median a rank, the 'model' all-reduces' time in a timed step and their
   share, the peak memory a rank beside one process's; (t4) four ranks at
   (2, 2), batch 16, one step of the K2 configuration against one process;
   (t5) train_model at tp 2 on a copy of dataset/data (batch 32, 4 steps,
   a checkpoint), its model.pth equal to the gathered parameters and
   serving test_set/audio.wav, then a resume at tp 1 from its checkpoint.
   The ranks time-share the card and reduce through the host: correctness
   and the reduction's cost, not scaling.
14. The reference-name surface (compat.py and the tools) at full width.
   (c1) compat.build_model(training_config) on the card, count_parameters
   235,472,957, save_final_model then load_model(path, training_config,
   device="cuda") bitwise equal. (c2) The 30 s request through the
   reference's call shape, compat.generate_facial_data_from_bytes(wav,
   model, device=None), at 'auto' and 'pallas' (the main path run,
   launches counted from zero: K1 50; K1 2 and the K4 forward 24), bitwise
   equal to inference/api.py's and to generate_facial_data_from_bytes_device;
   compat.process_audio_features on compat.extract_audio_features'
   features bitwise equal to pipeline='host'. (c3) 11 steps of (a)'s
   configuration written as the reference's loop, from
   compat.prepare_training_components, under StepTimer(sync_every=5): the
   first 6 losses equal make_train_step's from the same weights and seeds,
   the timer's 10 steps' mean within 15% of phase 8's step (a) median, the
   scheduler's LR learning_rate * lr_factor. (c4) In a process of its own,
   two steps of (a) under profile_trace: trace.json names K1's rope_rows.
15. The port's runnable scripts (bench.py and tools/) at full width, as
   `tools` says: the four bench modes in this process (the main path runs,
   launches counted from zero: K1 100 a training step, 50 a request and a
   decode forward), the headline within 10% of phase 8's step (a) median;
   the bench CLI and --mode infer in processes of their own; serving_soak,
   serving_knee (--fused 0 and 1), warmup_probe, local_dispatch_probe
   --device cpu; step_probe at (a), (b), (e) and (c), each with phase 8's
   or 9's launches a step and within 10% of phase 8's median;
   data_scale_probe --generate and --measure, and train_scale_run
   for 20 steps over the generated data.

The line before the last holds the card's name and power limit; the line
before that the kernels' JSON record (launches: the sum over the main path
runs, the serving runs, the live runs, one training step at each
configuration, the parallel and tensor runs (every rank's launches) and
the compat requests and the bench modes, each counted from zero;
launches_by_path: each run's own count); the last line the result.
"""

from __future__ import annotations

import argparse
import gc
import itertools
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
#: the live phase: sessions, seconds of audio each, seconds a push, ticks
#: between two sessions' opens, and the real-time session's seconds
LIVE_SESSIONS, LIVE_SECONDS, LIVE_PUSH, LIVE_STAGGER = 8, 30, 0.5, 3
LIVE_LATENCY_SECONDS, LIVE_FP32_SECONDS = 10, 10
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
#: the parallel phase: steps a run, the seconds its ranks may take, the
#: seconds a collective may wait; (p2)'s runs at batch 128 x 128
DP_STEPS, DP_RUN_TIMEOUT, DP_GROUP_TIMEOUT = 3, 600, 300
#: (p2)'s first step against one process, relative, (loss, grad norm):
#: before Adam only the order of the sums differs. Set from the H100's
#: readings (PERF.md §6): loss 0 to 1.2e-7, the norm 1.8e-6 to 3.3e-5
#: (at 'pallas', whose bf16 gradients at 64 rows round apart from 128's);
#: the planted faults read 4.7e-4 and more in either
DP_FIRST_STEP_LIMITS = (1e-5, 2e-4)
#: the faults planted in (p2) that DP_FIRST_STEP_LIMITS must catch, each
#: beside the run it is compared with
DP_PLANTED = {"contiguous rows, accum 2": "'auto', dropout 0.3, accum 2",
              "masks over the local rows": "'auto', dropout 0.3"}
DP_CONFIGS = {"'pallas', dropout 0": dict(attention_impl="pallas",
                                          dropout=0.0),
              "'auto', dropout 0.3": {},
              "'auto', dropout 0.3, accum 2": dict(grad_accum_steps=2)}
#: the tensor phase (13): (t3)'s steps and batch, (t4)'s batch, (t5)'s
#: steps; the first step against one process, relative (loss, grad norm):
#: bf16 roundings flipped by the fp32 sums' order over 16 layers read
#: 4.8e-5 to 5.6e-5 in loss and 1.2e-4 to 5.7e-4 in norm on the H100
#: (PERF.md §6); the planted faults read 1.8e-3 (loss, masks at the
#: local width) and 1.7e-1 (norm, every column backward without its
#: all-reduce)
TP_STEPS, TP_BATCH, TP_DP_BATCH, TP_LOOP_STEPS = 3, 32, 16, 4
TP_FIRST_STEP_LIMITS = (2e-4, 2e-3)
#: (t3)'s configurations: Config overrides, and whether seq2seq._ffn
#: routes the FFN through K2; (t4) runs one of them, the faults another
TP_CONFIGS = {"'pallas', dropout 0": (dict(attention_impl="pallas",
                                           dropout=0.0), False),
              "'auto', dropout 0.3, FFN through K2": ({}, True)}
TP_DP_CONFIG = TP_PLANTED_CONFIG = "'auto', dropout 0.3, FFN through K2"
#: the bf16 LayerNorm kernels (csrc/layer_norm.cu) in one full-width
#: forward (8 + 8 layers: 2 an encoder layer, 3 a decoder layer, each
#: stack's final one), and in a training step, whose backward runs each
#: LayerNorm's once; a rank of tensor parallelism runs them all (replicated)
LN_FORWARD = {"layer_norm_fwd": 8 * 2 + 8 * 3 + 2}
LN_STEP = {**LN_FORWARD, "layer_norm_bwd": LN_FORWARD["layer_norm_fwd"]}
#: the lean attention kernels (csrc/lean_attention.cu) in a bf16 training
#: step at windows up to 128 off K4: a forward and a backward at each of
#: the 24 sites (8 encoder and 8 decoder self-attentions, 8
#: cross-attentions), at dropout 0 too; a rank of tensor parallelism runs
#: them over its heads
LA_STEP = {"lean_attention_fwd": 24, "lean_attention_bwd": 24}
#: the FFN epilogue kernels (csrc/ffn_epilogue.cu) in a bf16 training step
#: of the Seq2Seq: a forward and a backward at each of its 16 ReLU FFNs, at
#: dropout 0 too; a step routed through K2 keeps the forward alone; a
#: rematted layer launches its forward again in the backward; a rank of
#: tensor parallelism runs them over its columns
FFN_STEP = {"ffn_epi_fwd": 16, "ffn_epi_bwd": 16}
FFN_K2_STEP = {"ffn_epi_fwd": 16}
#: a step of (a) with every layer rematted: the backward launches the lean
#: attention forward again at each site, K1 again for q and k (48), and
#: the LayerNorm forward again for each LayerNorm inside a layer (40; the
#: stacks' final ones are outside the layers)
LA_REMAT_STEP = {"rope_rotate": 148, **LN_STEP,
                 "layer_norm_fwd": LN_STEP["layer_norm_fwd"] + 40,
                 "lean_attention_fwd": 48, "lean_attention_bwd": 24,
                 **FFN_STEP, "ffn_epi_fwd": 32}
#: kernel launches of one step at each, and the 'model' all-reduces of one
#: full-width step (8 + 8 layers): a row-parallel linear's forward (2 an
#: encoder layer, 3 a decoder layer), a column-parallel linear's backward
#: (4 and 7), the grad norm's
TP_LAUNCHES = {"'pallas', dropout 0": {"rope_rotate": 52,
                                       "fused_rope_attention": 24,
                                       "fused_rope_attention_bwd": 24,
                                       **LN_STEP, **FFN_STEP},
               "'auto', dropout 0.3, FFN through K2": {"rope_rotate": 100,
                                                       "ffn_bwd_dh1": 16,
                                                       **LN_STEP,
                                                       **LA_STEP,
                                                       **FFN_K2_STEP}}
TP_COLLECTIVES = {"forward": 8 * 2 + 8 * 3, "backward": 8 * 4 + 8 * 7,
                  "grad_norm": 1}
#: (t2)'s fp32 MeshDecoder against one process, a share of max|out|
TP_DECODE_FP32_LIMIT = 1e-5
#: the compat phase (14): the full-width parameter count (PERF.md §4);
#: (c3)'s StepTimer steps and cadence, the port's steps it is held against,
#: and how far the timer's mean may lie from step (a)'s median (the card
#: is ~97% busy at (a), so host and device time agree; a timer that did
#: not wait for the card would read far lower)
FULL_WIDTH_PARAMETERS = 235_472_957
COMPAT_TIMER_STEPS, COMPAT_SYNC_EVERY, COMPAT_REF_STEPS = 11, 5, 6
COMPAT_TIMER_LIMIT = 0.15
#: phase 15 (the runnable scripts): how far the bench headline and each
#: step_probe reading may lie from phase 8's synchronised step median of
#: the same configuration (the card is 88-97% busy there, so an
#: unsynchronised loop sees about the same device time); a tool's seconds
TOOLS_AGREEMENT, TOOL_TIMEOUT = 0.10, 600
TOOLS = "neurosync_trainer_lite_tpu_torch.tools."
#: step_probe's runs: phase 8's configuration → the probe's flags
STEP_PROBES = {
    "a": ["--remat", "0", "--dropout", "0.3"],
    "b": ["--remat", "0", "--dropout", "0", "--attn", "pallas"],
    "e": ["--remat", "0", "--dropout", "0.3", "--patch", "ffn-bwd-pallas"],
    "c": ["--remat", "0", "--dropout", "0", "--t", "512", "--b", "32"],
}
#: each step_probe run's kernel launches a step (phase 8's and 9's counts
#: of the same configuration), read from the probe's stderr
STEP_PROBE_LAUNCHES = {
    "a": {"rope_rotate": 100, **LN_STEP, **LA_STEP, **FFN_STEP},
    "b": {"rope_rotate": 52, "fused_rope_attention": 24,
          "fused_rope_attention_bwd": 24, **LN_STEP, **FFN_STEP},
    "e": {"rope_rotate": 100, "ffn_bwd_dh1": 16, **LN_STEP, **LA_STEP,
          **FFN_K2_STEP},
    "c": {"rope_rotate": 100, "flash_attention": 24,
          "flash_attention_bwd_dq": 24, "flash_attention_bwd_dkdv": 24,
          **LN_STEP, **FFN_STEP},
}
EXCESS_LIMIT = 0.05            # attention_gradients_in_model
#: (B, N, T, h) K3 gets at (c) window 512 x batch 32, (d) 2048 x 8, and
#: (s2) the 30 s request at frame_size 512 (4 chunks)
K3_SHAPES = {"c": (32, 16, 512, 64), "d": (8, 16, 2048, 64),
             "s2": (4, 16, 512, 64)}
#: (M, H, F) K2 gets at step (a) (128 x 128 rows, hidden 1024, FFN 4096),
#: the JAX test's ragged shape and M off the 128-row tile (the wgmma
#: kernel), and H, F not multiples of 8 (the WMMA kernel)
#: [rows, F] the FFN epilogue kernels get at step (a) and wav2vec2's cell
#: (128 x 128 rows, FFN 4096), and the share of the GELU's outputs that may
#: lie one bf16 rounding from the plain version's (erf and exp of the
#: card's math library, one fp32 ulp away, can flip a rounding)
FFN_SHAPE = (16384, 4096)
FFN_GELU_SHARE = 1e-3
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


def seeded_wav(np, sr: int) -> bytes:
    """The timed request: SERVE_SECONDS of seeded noise as a 16-bit WAV at
    sr, as bench.py --mode infer serves."""
    from neurosync_trainer_lite_tpu_torch.utils.audio_io import audio_to_bytes

    rng = np.random.default_rng(0)
    return audio_to_bytes(rng.standard_normal(sr * SERVE_SECONDS)
                          .astype(np.float32) * 0.3, sr)


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
    # the serving batch (the 30 s request's chunks), the training batch, and
    # a rank's share of them in phase 12 (two ranks): 64 rows ((p2), (p4)),
    # 32 a micro-batch under accumulation ((p2)), 9 of the 17 chunks ((p3))
    rank_batches = (train_batch_size // 2, train_batch_size // 4, -(-B // 2))
    for batch in (B, train_batch_size, *rank_batches):
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
            k1_by[label] = k1_timed(torch, x, tiled, transpose)
            del x

            if dtype != torch.bfloat16:
                continue
            q, k, v = (torch.randn(batch, T, H, device="cuda", generator=gen)
                       .to(dtype) for _ in range(3))
            k4_by[label] = k4_fwd_timed(torch, q, k, v, tables, n)
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
            print_timed(name, label, r)
    print_timed("fused_rope_attention_bwd", "training",
                records["fused_rope_attention_bwd"])


def print_timed(name: str, label: str, r: dict) -> None:
    """One timed kernel: its time beside its plain version's, the library
    call's where there is one, and its bound."""
    extra = {"eager_ms": "eager", "library_ms": "library call",
             "library_fwd_bwd_ms": "library forward + backward (CUDA "
                                   "events)",
             "split_ms": "split-bf16 products as executed at the tensor "
                         "cores' peak",
             "fp32_bound_ms": "every fp32-operand product on the fp32 CUDA "
                              "cores"}
    print(f"time {name} ({label}) at {r['shape']} "
          f"{r.get('dtype', 'torch.bfloat16')}: {r['ms']:.6f} ms on the card "
          f"(CUDA graph), plain {r['plain_ms']:.6f} ms, bound "
          f"{r['bound_ms']:.6f} ms ({r['bound_by']}; "
          f"{r['ms'] / r['bound_ms']:.2f}x)"
          + "".join(f"; {what} {r[key]:.6f} ms" for key, what in extra.items()
                    if key in r), flush=True)


def k1_timed(torch, x, tables, transpose: bool = False) -> dict:
    """K1 on x [B, T, H] beside its plain version and its bound."""
    from neurosync_trainer_lite_tpu_torch.ops import rope_kernel as rk

    _, T, H = x.shape
    rec = dict(
        ms=device_ms(lambda: rk.rope_rotate_cuda(x, *tables,
                                                 transpose=transpose)),
        plain_ms=device_ms(lambda: rk.rope_rotate_plain(
            x, *tables, transpose=transpose)),
        eager_ms=eager_ms(lambda: rk.rope_rotate_cuda(x, *tables,
                                                      transpose=transpose)),
        shape=list(x.shape), dtype=str(x.dtype), transpose=transpose)
    # x read and out written once, the three fp32 tables once; 5 flops an
    # element on the CUDA cores
    rec["bound_ms"], rec["bound_by"] = bound(
        2 * x.numel() * x.element_size() + 3 * T * H * 4, 5 * x.numel())
    return rec


def k4_fwd_timed(torch, q, k, v, tables, n: int) -> dict:
    """The K4 forward on [B, T, H] with n heads beside its plain version and
    its bound."""
    from neurosync_trainer_lite_tpu_torch.ops import fused_attention as fua

    batch, T, H = q.shape
    hd, item = H // n, q.element_size()
    with torch.no_grad():
        rec = dict(
            ms=device_ms(lambda: fua.fused_rope_attention_cuda(
                q, k, v, tables, n, hd ** -0.5)),
            plain_ms=device_ms(lambda: fua.fused_rope_attention_plain(
                q, k, v, tables, n, hd ** -0.5), iters=5),
            eager_ms=eager_ms(lambda: fua.fused_rope_attention_cuda(
                q, k, v, tables, n, hd ** -0.5)),
            shape=[batch, T, H])
    # q·kᵀ and p·v (2·T·T·H each) with bf16 operands at the tensor cores'
    # peak, where the bf16 kernel runs them; the rotation of q and k (5
    # flops an element each) and the softmax (~5 a score) on the CUDA cores;
    # q, k, v read and out written once, six fp32 tables. `split_ms`: the
    # products as the kernel executes them, split-bf16 (three mma for q·kᵀ,
    # two for p·v: 10·B·T·T·H), at the tensor cores' peak
    pairs = batch * T * T
    rec["bound_ms"], rec["bound_by"] = bound(
        4 * batch * T * H * item + 6 * T * H * 4,
        10 * batch * T * H + 5 * n * pairs, bf16_flops=4 * pairs * H)
    rec["split_ms"] = 10 * pairs * H / BF16_FLOP_PER_S * 1e3
    rec["fp32_bound_ms"] = bound(
        4 * batch * T * H * item + 6 * T * H * 4,
        10 * batch * T * H + 5 * n * pairs + 4 * pairs * H)[0]
    return rec


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
    """The K4 backward at the training shape and at a phase 12 rank's 64
    rows of it: against its plain version in bf16 and fp32, then timed in
    bf16 at the training shape."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.ops import fused_attention as fua

    cfg = Config()
    B, T, H, n = cfg.batch_size, cfg.micro_batch_size, cfg.hidden_dim, \
        cfg.num_heads
    hd, scale = H // n, (H // n) ** -0.5
    tables = fua.make_tables(T, T, hd, n, "cuda")
    worst = 0.0
    for rows, dtype in itertools.product((B, B // 2),
                                         (torch.bfloat16, torch.float32)):
        q, k, v, do = (torch.randn(rows, T, H, device="cuda", generator=gen)
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
                  f"K4 backward {name} [{rows}, {T}, {H}] {dtype} within "
                  f"{rel:g}·|plain| + 1e-4·max|plain| of the plain version "
                  f"(max abs err {e}, max|plain| "
                  f"{b.float().abs().max().item():.4f})")
        again = fua.fused_rope_attention_bwd_cuda(q, k, v, do, tables, n,
                                                  scale)
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"K4 backward [{rows}, {T}, {H}] {dtype} bitwise repeatable")
        del q, k, v, do, out, ref, again

    q, k, v, do = (torch.randn(B, T, H, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    return {**k4_bwd_timed(torch, q, k, v, do, tables, n),
            "max_abs_err": worst}


def k4_bwd_timed(torch, q, k, v, do, tables, n: int) -> dict:
    """The K4 backward on bf16 [B, T, H] with n heads beside its plain
    version and its bound."""
    from neurosync_trainer_lite_tpu_torch.ops import fused_attention as fua

    B, T, H = q.shape
    scale = (H // n) ** -0.5
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
    rec.update(bound_ms=b_ms, bound_by=b_by, shape=[B, T, H],
               fp32_bound_ms=bound(nbytes, 8 * B * T * T * H + cores,
                                   bf16_flops=2 * B * T * T * H)[0])
    return rec


def k3_checks(torch, records):
    """Phases 4 and 5 for K3 (and K1 at its long-window shapes): against the
    plain versions at (c), (d) and a ragged cross-length shape, in bf16 and
    fp32, the backward bitwise repeatable; then timed in bf16 at (c) and
    (d) beside the plain versions, the bounds and SDPA."""
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
        timed[label] = k3_timed(torch, q, k, v, do, label)
        del q, k, v, do
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


def k3_timed(torch, q, k, v, do, label: str):
    """K3's forward and backward on bf16 [B, N, T, h] beside their plain
    versions, their bounds and SDPA's forward and backward: (fwd, bwd)."""
    import torch.nn.functional as F

    from neurosync_trainer_lite_tpu_torch.ops import flash_attention as fa

    B, N, T, h = q.shape
    scale = h ** -0.5
    iters = 10 if T <= 512 else 4
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg)
        torch.autograd.grad(out, (qg, kg, vg), do)

    pairs = B * N * T * T
    item = q.element_size()
    # forward: q·kᵀ and p·v (2h flops a pair each) have bf16 operands, p
    # being rounded to v's type first; softmax ~5 a pair. Backward: the
    # five products (s = q·kᵀ, dp = dO·vᵀ, pᵀ·dO, ds·k, dsᵀ·q) all at the
    # tensor cores' peak, which the split-bf16 kernels run them on;
    # softmax, D and ds ~10 a pair. `split_bound_ms`: the three
    # fp32-operand products on the CUDA cores instead, as counted before
    # the tensor-core kernels. `exp_ms`: the exps the kernels take (2 a
    # pair forward, 3 backward) on the MUFU alone.
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
    return fwd, bwd


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

    dy, w, am = inputs(*K2_SHAPES[0])
    rec = k2_timed(torch, dy, w, am)
    records["ffn_bwd_dh1"].update(rec, max_abs_err=worst)
    print_timed("ffn_bwd_dh1", "(a)", rec)
    del dy, w, am
    torch.cuda.empty_cache()


def k2_timed(torch, dy, w, am, scale: float = 256 / 179) -> dict:
    """K2 on dy [M, H], W [H, F], am [M, F] beside its plain version, its
    bound and cuBLAS's dy·W alone (library_ms)."""
    from neurosync_trainer_lite_tpu_torch.ops import ffn_bwd

    (m, h), f = dy.shape, w.shape[1]
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
    rec["shape"] = [m, h, f]
    return rec


def ln_checks(torch, records):
    """Phases 4 and 5 for the bf16 LayerNorm kernels (csrc/layer_norm.cu):
    both against their plain version at the model's width, at the training
    step's rows and the 30 s request's, and at the wav2vec2 path's width
    512 (models/wav2vec2.py): the forward at the frozen frontend's largest
    channel LayerNorm (the first conv's frames of a batch) and both at the
    feature projection's rows; the backward bitwise repeatable; then timed
    at the training step's beside the plain version, the bound and
    PyTorch's own LayerNorm with bf16 weights (a yardstick of speed only:
    the port never calls it)."""
    import torch.nn.functional as F

    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.models import wav2vec2 as w2v
    from neurosync_trainer_lite_tpu_torch.ops import layer_norm_kernel as lnk

    cfg = Config()
    B, T, H, _ = serving_shape(cfg)
    rows = cfg.batch_size * cfg.micro_batch_size
    wcfg = Config(architecture="wav2vec2", sr=16000)
    w2v_width = wcfg.conv_dim[-1]
    frontend_rows = wcfg.batch_size * (
        (wcfg.window_samples - w2v.CONV_KERNEL[0]) // w2v.CONV_STRIDE[0] + 1)
    gen = torch.Generator(device="cuda").manual_seed(8)

    def inputs(n, h=H):
        x = torch.randn(n, h, device="cuda", generator=gen) * 2 + 0.5
        dout = torch.randn(n, h, device="cuda", generator=gen)
        return x.bfloat16(), dout.bfloat16()

    def params(h):
        return (torch.rand(h, device="cuda", generator=gen) + 0.5,
                torch.randn(h, device="cuda", generator=gen))

    weights = {H: params(H)}
    worst = 0.0
    for label, n, h, backward in (
            ("training", rows, H, True), ("serving", B * T, H, True),
            ("wav2vec2 frontend", frontend_rows, w2v_width, False),
            ("wav2vec2 projection", wcfg.batch_size * wcfg.micro_batch_size,
             w2v_width, True)):
        if h not in weights:
            weights[h] = params(h)
        w, b = weights[h]
        x, dout = inputs(n, h)
        out, mean, r = lnk.layer_norm_fwd_cuda(x, w, b)
        grads = lnk.layer_norm_bwd_cuda(dout, x, mean, r, w) if backward \
            else None
        torch.cuda.synchronize()
        ref, rmean, rr = lnk.layer_norm_plain_fwd(x, w, b)
        check(bool(((mean - rmean).abs() <= 1e-6 + 1e-5 * rmean.abs()).all())
              and bool(((r - rr).abs() <= 1e-5 * rr.abs()).all()),
              f"LN {label} [{n}, {h}] mean and r within 1e-5 of the plain "
              f"version's")
        # the fp32 size of the terms each output sums: a last-bit change of
        # mean or r (the row sums run in another order than PyTorch's)
        # moves an output by about that size's ulp, more than its own
        # where the terms cancel
        y = (x.float() - rmean) * rr
        outputs = [("out", out, ref, (y * w).abs() + b.abs())]
        if backward:
            want = lnk.layer_norm_plain_bwd(dout, x, mean, r, w)
            dy = dout.float() * w
            m1 = dy.mean(-1, keepdim=True)
            m2 = (dy * y).mean(-1, keepdim=True)
            outputs.append(("dx", grads[0], want[0],
                            rr * (dy.abs() + m1.abs() + (y * m2).abs())))
            del dy, m1, m2
        del y
        for name, got, exp, size in outputs:
            ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(
                size, exp.float().abs()).clamp_min(2.0 ** -100))) - 7)
            diff = (got.float() - exp.float()).abs()
            worst = max(worst, diff.max().item())
            same = (got == exp).float().mean().item()
            check(got.dtype == exp.dtype == torch.bfloat16
                  and got.shape == exp.shape and bool((diff <= ulp).all())
                  and same >= 0.99,
                  f"LN {label} {name} [{n}, {h}] within one bf16 ulp of its "
                  f"terms' size of the plain version, {same:.6f} of it "
                  f"bitwise (max abs err {diff.max().item():.3e})")
            del ulp, diff
        del outputs, size
        if backward:
            for name, got, exp in zip(("dweight", "dbias"), grads[1:],
                                      want[1:]):
                e = (got - exp).abs().max().item()
                worst = max(worst, e)
                check(got.dtype == torch.float32 and got.shape == exp.shape
                      and e <= 1e-5 * exp.norm().item(),
                      f"LN {label} {name} [{n}, {h}] within 1e-5 of the "
                      f"plain version's norm (max abs err {e:.3e})")
            again = lnk.layer_norm_bwd_cuda(dout, x, mean, r, w)
            check(all(torch.equal(a, e) for a, e in zip(grads, again)),
                  f"LN {label} backward [{n}, {h}] bitwise repeatable")
            del want, again
        del x, dout, out, mean, r, grads, ref, rmean, rr
        torch.cuda.empty_cache()

    w, b = weights[H]
    # four input sets taken in turn (2 x 33.5 MB each, past the 50 MB L2),
    # so that every replayed call reads its inputs from HBM
    sets = [inputs(rows) for _ in range(4)]
    stats = [lnk.layer_norm_fwd_cuda(x, w, b)[1:] for x, _ in sets]
    wb, bb = (t.bfloat16().requires_grad_(True) for t in (w, b))

    def rotating(fn):
        turn = itertools.count()
        return lambda: fn(next(turn) % len(sets))

    with torch.no_grad():
        fwd = dict(
            ms=device_ms(rotating(lambda i: lnk.layer_norm_fwd_cuda(
                sets[i][0], w, b))),
            plain_ms=device_ms(rotating(lambda i: lnk.layer_norm_plain_fwd(
                sets[i][0], w, b))),
            library_ms=device_ms(rotating(lambda i: F.layer_norm(
                sets[i][0], (H,), wb, bb, lnk.EPS))))
        bwd = dict(
            ms=device_ms(rotating(lambda i: lnk.layer_norm_bwd_cuda(
                sets[i][1], sets[i][0], *stats[i], w))),
            plain_ms=device_ms(rotating(lambda i: lnk.layer_norm_plain_bwd(
                sets[i][1], sets[i][0], *stats[i], w))))
    # the library's backward alone runs on the stream of its forward, so
    # the forwards run on the stream the graph captures; then its forward
    # and backward together
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        leaves = [x.detach().requires_grad_(True) for x, _ in sets]
        outs = [F.layer_norm(x, (H,), wb, bb, lnk.EPS) for x in leaves]
    bwd["library_ms"] = device_ms(rotating(lambda i: torch.autograd.grad(
        outs[i], (leaves[i], wb, bb), sets[i][1], retain_graph=True)),
        stream=stream)

    def library_fwd_bwd(i):
        out = F.layer_norm(leaves[i], (H,), wb, bb, lnk.EPS)
        torch.autograd.grad(out, (leaves[i], wb, bb), sets[i][1])

    library_pair = device_ms(rotating(library_fwd_bwd))
    # the least bytes: x read and out written in bf16 forward, x and dout
    # read and dx written backward (the per-row statistics, the weights
    # and the backward's scratch move under 1% of that); fp32 operations
    # an element: 7 forward, 12 backward
    n = rows * H
    fwd["bound_ms"], fwd["bound_by"] = bound(4 * n, 7 * n)
    bwd["bound_ms"], bwd["bound_by"] = bound(6 * n, 12 * n)
    for rec in (fwd, bwd):
        rec["shape"] = [rows, H]
    print_timed("layer_norm_fwd", "training", fwd)
    print_timed("layer_norm_bwd", "training", bwd)
    print(f"time layer_norm (training) forward + backward, library "
          f"{library_pair:.6f} ms (one CUDA graph)", flush=True)
    records["layer_norm"].update(
        {key: fwd[key] + bwd[key] for key in ("ms", "plain_ms", "bound_ms")},
        library_ms=library_pair, bound_by="bytes", shape=[rows, H],
        max_abs_err=worst, by_shape={"forward": fwd, "backward": bwd})
    check(fwd["bound_by"] == bwd["bound_by"] == "bytes",
          "LN bound by its bytes")
    del sets, stats, leaves, outs
    torch.cuda.empty_cache()


def la_checks(torch, records):
    """Phases 4 and 5 for the lean attention kernels
    (csrc/lean_attention.cu): both against the plain pair at every training
    site's [128, 16, 128, 64] (thresholds 0, 26 and 77: no dropout,
    wav2vec2's 0.1, the Seq2Seq's 0.3) and a tp = 2 rank's [128, 8, 128,
    64] (its heads' bits a strided block of the global draw), on the head
    split's strided views; each output within two bf16 roundings of its
    terms' size and 99% bitwise, both kernels bitwise repeatable; then
    timed at both shapes at 0.3 beside the plain pair, the bound and SDPA
    with dropout_p 0.3 (a yardstick of speed only: another mask, and the
    port never calls it)."""
    import torch.nn.functional as F

    from neurosync_trainer_lite_tpu_torch.ops import attention as attn
    from neurosync_trainer_lite_tpu_torch.ops import lean_attention as la

    gen = torch.Generator(device="cuda").manual_seed(9)
    B, T, h = 128, 128, 64

    def operands(n):
        def heads():
            return (torch.randn(B, T, n * h, device="cuda", generator=gen)
                    .bfloat16().reshape(B, T, n, h).transpose(1, 2))
        return heads(), heads(), heads(), heads()

    def terms(q, k, v, dout, bits, scale, qth):
        # each output's terms' size, from the plain pair's bf16
        # intermediates: a w, dw or ds a sum-order flip away from plain's
        # moves a term by one rounding, the output's own is the other
        w, wd, keep = attn._plain_weights(q, k, bits, scale, qth)
        dw = attn._matmul_round_once(dout, v.transpose(-1, -2))
        if keep is not None:
            dw = attn._drop(dw, keep, qth)
        wf, dwf = w.float(), dw.float()
        ds = scale * wf * (dwf.abs() + (dwf * wf).sum(-1, True).abs())
        a = wd.float().abs()
        return (a @ v.float().abs(), ds @ k.float().abs(),
                ds.transpose(-1, -2) @ q.float().abs(),
                a.transpose(-1, -2) @ dout.float().abs())

    worst = 0.0
    shapes = (("training", 16, None, (0, 26, 77)),
              ("tp = 2 rank", 8, (1, 0, 2, 1), (77,)))
    for label, n, blocks, thresholds in shapes:
        q, k, v, dout = operands(n)
        scale = h ** -0.5
        for qth in thresholds:
            with attn.dropout_rows(*(blocks or (1, 0))):
                bits = attn.draw_bits(11, q, k, qth)
            out = la.lean_attention_fwd_cuda(q, k, v, bits, scale, qth)
            grads = la.lean_attention_bwd_cuda(dout, q, k, v, bits, scale,
                                               qth)
            torch.cuda.synchronize()
            want = (attn.lean_attention_plain_fwd(q, k, v, bits, scale, qth),
                    *attn.lean_attention_plain_bwd(dout, q, k, v, bits, scale,
                                                 qth))
            got = (out, *grads)
            for name, a, e, size in zip(("out", "dq", "dk", "dv"), got, want,
                                        terms(q, k, v, dout, bits, scale,
                                              qth)):
                ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(
                    size, e.float().abs()).clamp_min(2.0 ** -100))) - 7)
                diff = (a.float() - e.float()).abs()
                worst = max(worst, diff.max().item())
                same = (a == e).float().mean().item()
                check(a.dtype == e.dtype == torch.bfloat16
                      and a.shape == e.shape
                      and bool((diff <= 2 * ulp).all()) and same >= 0.99,
                      f"LA {label} q={qth} {name} [{B}, {n}, {T}, {h}] within "
                      f"two bf16 roundings of its terms' size of the plain "
                      f"pair, {same:.6f} of it bitwise (max abs err "
                      f"{diff.max().item():.3e}, "
                      f"{(diff / ulp).max().item():.3f} roundings)")
                del ulp, diff, size
            again = (la.lean_attention_fwd_cuda(q, k, v, bits, scale, qth),
                     *la.lean_attention_bwd_cuda(dout, q, k, v, bits, scale,
                                                 qth))
            check(all(torch.equal(a, e) for a, e in zip(got, again)),
                  f"LA {label} q={qth}: both kernels bitwise repeatable")
            del out, grads, want, got, again
        torch.cuda.empty_cache()

    by_shape = {}
    for label, n, blocks, _ in shapes:
        # two operand sets taken in turn (4 x 16.8 MB and 33.6 MB of bits
        # each at 16 heads, past the 50 MB L2)
        sets = []
        for _ in range(2):
            ops = operands(n)
            with attn.dropout_rows(*(blocks or (1, 0))):
                sets.append((*ops, attn.draw_bits(12, ops[0], ops[1], 77)))
        scale, turn = h ** -0.5, itertools.count()

        def rotating(fn):
            return lambda: fn(*sets[next(turn) % 2])

        with torch.no_grad():
            fwd = dict(
                ms=device_ms(rotating(lambda q, k, v, do, bits:
                                      la.lean_attention_fwd_cuda(
                                          q, k, v, bits, scale, 77))),
                plain_ms=device_ms(rotating(lambda q, k, v, do, bits:
                                            attn.lean_attention_plain_fwd(
                                                q, k, v, bits, scale, 77))),
                library_ms=event_ms(rotating(
                    lambda q, k, v, do, bits: F.scaled_dot_product_attention(
                        q, k, v, dropout_p=0.3)), iters=20))
            bwd = dict(
                ms=device_ms(rotating(lambda q, k, v, do, bits:
                                      la.lean_attention_bwd_cuda(
                                          do, q, k, v, bits, scale, 77))),
                plain_ms=device_ms(rotating(lambda q, k, v, do, bits:
                                            attn.lean_attention_plain_bwd(
                                                do, q, k, v, bits, scale,
                                                77))))
        leaves = [[t.detach().requires_grad_(True) for t in ops[:3]]
                  for ops in sets]

        def sdpa_fwd_bwd(i=itertools.count()):
            j = next(i) % 2
            out = F.scaled_dot_product_attention(*leaves[j], dropout_p=0.3)
            torch.autograd.grad(out, leaves[j], sets[j][3])

        bwd["library_fwd_bwd_ms"] = event_ms(sdpa_fwd_bwd, iters=20)
        # the least bytes: q, k, v read and out written (forward), q, k, v,
        # dout read and dq, dk, dv written (backward), in bf16; the bits
        # (33.6 MB at 16 heads) are left out, as lattn_roofline_pct.train
        # leaves them out. Products: q·kᵀ and wd·v forward (4 B·n·T²·h),
        # q·kᵀ, dout·vᵀ, wdᵀ·dout, ds·k and dsᵀ·q backward, the recompute
        # not counted (8 B·n·T²·h)
        elems, pairs = B * n * T * h, B * n * T * T
        fwd["bound_ms"], fwd["bound_by"] = bound(4 * 2 * elems, 0,
                                                 4 * pairs * h)
        bwd["bound_ms"], bwd["bound_by"] = bound(7 * 2 * elems, 0,
                                                 8 * pairs * h)
        for rec in (fwd, bwd):
            rec["shape"] = [B, n, T, h]
        print_timed("lean_attention_fwd", label, fwd)
        print_timed("lean_attention_bwd", label, bwd)
        print(f"time lean_attention ({label}) SDPA with dropout 0.3: forward "
              f"{fwd['library_ms']:.6f} ms, forward + backward "
              f"{bwd['library_fwd_bwd_ms']:.6f} ms (CUDA events)", flush=True)
        by_shape[label] = {"forward": fwd, "backward": bwd}
        check(fwd["bound_by"] == bwd["bound_by"] == "bytes",
              f"LA {label} bound by its bytes")
        if label == "training":
            records["lean_attention"].update(
                {key: fwd[key] + bwd[key] for key in ("ms", "plain_ms",
                                                      "bound_ms")},
                library_ms=fwd["library_ms"], bound_by="bytes",
                shape=[B, n, T, h])
        del sets, leaves
        torch.cuda.empty_cache()
    records["lean_attention"].update(max_abs_err=worst, by_shape=by_shape)


def ffn_checks(torch, records):
    """Phases 4 and 5 for the FFN epilogue kernels (csrc/ffn_epilogue.cu):
    each entry point against its plain version at the training FFNs'
    [16,384 x 4,096] (ReLU at thresholds 77 and 0, the Seq2Seq's; GELU at
    26 and 0, wav2vec2's) and a tp = 2 rank's [16,384 x 2,048] (its bits a
    column block of the global draw, rows 4,096 apart): ReLU bitwise, h1
    bitwise, the GELU's a, dh1 and the backward's dw2 operand bitwise or
    one bf16 rounding away in
    at most FFN_GELU_SHARE of the elements, db1 within 1e-5 of its largest,
    every output bitwise repeatable; then each entry point timed at the
    training shape beside its plain version and its bound."""
    from neurosync_trainer_lite_tpu_torch.models import layers
    from neurosync_trainer_lite_tpu_torch.ops import attention as attn
    from neurosync_trainer_lite_tpu_torch.ops import ffn_epilogue as fe

    gen = torch.Generator(device="cuda").manual_seed(9)
    rows, width = FFN_SHAPE

    def operands(f, q, blocks):
        p32 = torch.randn(rows, f, device="cuda", generator=gen) * 2
        b1 = torch.randn(f, device="cuda", generator=gen) * 0.5
        da32 = torch.randn(rows, f, device="cuda", generator=gen)
        with attn.dropout_rows(*blocks):
            bits = layers._ffn_bits(13, q, (rows, f), f, "cuda")
        return p32, b1, da32, bits

    def compare(what, got, want, bitwise):
        g, w = got.float(), want.float()
        ulp = torch.exp2(torch.floor(torch.log2(
            w.abs().clamp_min(2.0 ** -126))) - 7)
        roundings = ((g - w).abs() / ulp).max().item()
        off = (got != want).float().mean().item()
        worst[0] = max(worst[0], (g - w).abs().max().item())
        ok = (got.dtype == want.dtype and got.shape == want.shape
              and (torch.equal(got, want) if bitwise else
                   roundings <= 1 and off <= FFN_GELU_SHARE))
        bar = "bitwise" if bitwise else "within one bf16 rounding"
        check(ok, f"FFN-E {what}: {bar} of the plain version ({off:.3e} of "
              f"the elements differ, at most {roundings:.3f} roundings)")
        return off

    shares, worst = {}, [0.0]
    cases = [("training", width, act, q, (1, 0)) for act, q in
             (("relu", 77), ("relu", 0), ("gelu", 26), ("gelu", 0))]
    cases += [("tp = 2 rank", width // 2, act, q, (1, 0, 2, 1)) for act, q
              in (("relu", 77), ("gelu", 26))]
    for label, f, act, q, blocks in cases:
        tag = f"{label} [{rows}, {f}] {act} q={q}"
        p32, b1, da32, bits = operands(f, q, blocks)
        check(fe.takes_kernel(p32), f"FFN-E {tag}: the kernels take the "
              f"operands")
        a, h1 = fe.ffn_epi_fwd_cuda(p32, b1, bits, q, act)
        want_a, want_h1 = fe.ffn_epi_fwd_plain(p32, b1, bits, q, act)
        r = want_a if act == "relu" else want_h1
        got = {"a": (a, want_a)}
        if act == "gelu":
            compare(f"{tag} h1", h1, want_h1, True)
        dh1, db1, a2 = fe.ffn_epi_bwd_cuda(da32, r, bits, q, act)
        want_dh1, want_db1, want_a2 = fe.ffn_epi_bwd_plain(da32, r, bits, q,
                                                           act)
        got["dh1"] = (dh1, want_dh1)
        if act == "gelu":
            got["dw2 operand"] = (a2, want_a2)
            check(torch.equal(a2, a), f"FFN-E {tag}: the backward's dw2 "
                  f"operand is the forward's a, bitwise")
        torch.cuda.synchronize()
        for name, (g, w) in got.items():
            shares[f"{tag} {name}"] = compare(f"{tag} {name}", g, w,
                                              act == "relu")
        gap = ((db1 - want_db1).abs().max()
               / want_db1.abs().max().clamp_min(1e-30)).item()
        check(gap <= 1e-5, f"FFN-E {tag} db1 within 1e-5 of its largest "
              f"({gap:.3e})")
        again = [fe.ffn_epi_fwd_cuda(p32, b1, bits, q, act)[0],
                 *fe.ffn_epi_bwd_cuda(da32, r, bits, q, act)]
        check(all(x is y or torch.equal(x, y)
                  for x, y in zip(again, (a, dh1, db1, a2))),
              f"FFN-E {tag}: forward and backward bitwise repeatable")
        del p32, b1, da32, bits, a, h1, want_a, want_h1, r, got, dh1, db1
        del a2, want_dh1, want_db1, want_a2, again
        torch.cuda.empty_cache()

    # the least bytes an element, as ffn_epi_roofline_pct.train counts
    # them (the bits, the GELU's writes of h1 and of dw2's operand and the
    # db1 scratch left out), and with all of them as the kernels move them
    least = {"fwd": 6, "bwd": 8}
    moved = {("relu", "fwd"): 7, ("relu", "bwd"): 8, ("gelu", "fwd"): 9,
             ("gelu", "bwd"): 11}
    by_entry, elements = {}, rows * width
    for act, q in (("relu", 77), ("gelu", 26)):
        p32, b1, da32, bits = operands(width, q, (1, 0))
        _, h1 = fe.ffn_epi_fwd_plain(p32, b1, bits, q, act)
        r = h1 if act == "gelu" else fe.ffn_epi_fwd_plain(p32, b1, bits, q,
                                                          act)[0]
        calls = {"fwd": (lambda: fe.ffn_epi_fwd_cuda(p32, b1, bits, q, act),
                         lambda: fe.ffn_epi_fwd_plain(p32, b1, bits, q, act)),
                 "bwd": (lambda: fe.ffn_epi_bwd_cuda(da32, r, bits, q, act),
                         lambda: fe.ffn_epi_bwd_plain(da32, r, bits, q,
                                                      act))}
        for entry, (kernel, plain) in calls.items():
            with torch.no_grad():
                rec = dict(ms=device_ms(kernel, iters=10),
                           plain_ms=device_ms(plain, iters=5, reps=5))
            rec["bound_ms"], rec["bound_by"] = bound(
                least[entry] * elements, 0)
            rec["moved_bound_ms"] = bound(moved[act, entry] * elements, 0)[0]
            rec["shape"] = [rows, width]
            print_timed(f"ffn_epi_{entry}", f"{act}, q={q}", rec)
            print(f"time ffn_epi_{entry} ({act}, q={q}): "
                  f"{100 * rec['bound_ms'] / rec['ms']:.2f}% of its least "
                  f"bytes' bound, {100 * rec['moved_bound_ms'] / rec['ms']:.2f}"
                  f"% of the bytes it moves", flush=True)
            by_entry[f"{act} {entry}"] = rec
        del p32, b1, da32, bits, h1, r, calls
        torch.cuda.empty_cache()
    gelu = [by_entry[f"gelu {e}"] for e in ("fwd", "bwd")]
    records["ffn_epilogue"].update(
        {key: sum(r[key] for r in gelu) for key in ("ms", "plain_ms",
                                                    "bound_ms")},
        bound_by="bytes", shape=[rows, width], by_shape=by_entry,
        max_abs_err=worst[0], shares=shares)


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

    cfg = Config(dropout=0.0, frame_size=512)
    models = {"auto": init_seq2seq(cfg, torch.Generator(device="cuda")
                                   .manual_seed(0), device="cuda").eval()}
    for impl in ("pallas", "xla"):
        models[impl] = Seq2Seq(cfg.replace(attention_impl=impl), "cuda")
        models[impl].load_state_dict(models["auto"].state_dict())
        models[impl].eval()
    wav = seeded_wav(np, cfg.sr)
    batch = serving_shape(cfg)[0]
    print(f"serve (s2): frame_size {cfg.frame_size}, overlap {cfg.overlap}: "
          f"the 30 s request decodes as [{batch}, {cfg.frame_size}]",
          flush=True)
    expected = {"auto": {"rope_rotate": 50, "flash_attention": 24,
                         **LN_FORWARD},
                "pallas": {"rope_rotate": 50, "flash_attention": 24,
                           **LN_FORWARD},
                "xla": {"rope_rotate": 50, **LN_FORWARD}}
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


def live_kernel_checks(torch):
    """K1 and the K4 forward at the live path's decode batches [D, 128,
    1024], D = 1 and 8 (the decode bucket's ends), bf16, against their
    plain versions (K1 bitwise, K4 within fua.fwd_limit)."""
    from neurosync_trainer_lite_tpu_torch.ops import fused_attention as fua
    from neurosync_trainer_lite_tpu_torch.ops import rope_kernel as rk
    from neurosync_trainer_lite_tpu_torch.ops.rope import rope_tables

    _, T, H, n = serving_shape()
    gen = torch.Generator(device="cuda").manual_seed(8)
    tables = rope_tables(T, H // n, "cuda", tile=n)
    k4_tables = fua.make_tables(T, T, H // n, n, "cuda")
    err = {"rope_rotate": 0.0, "fused_rope_attention": 0.0}
    for batch in (1, LIVE_SESSIONS):
        x, q, k, v = (torch.randn(batch, T, H, device="cuda", generator=gen)
                      .to(torch.bfloat16) for _ in range(4))
        with torch.no_grad():
            out = rk.rope_rotate_cuda(x, *tables)
            torch.cuda.synchronize()
            ref = rk.rope_rotate_plain(x, *tables)
        e = (out.float() - ref.float()).abs().max().item()
        err["rope_rotate"] = max(err["rope_rotate"], e)
        check(torch.equal(out, ref),
              f"K1 rope_rotate at the live decode batch [{batch}, {T}, {H}] "
              f"bf16 bitwise equal to the plain version (max abs err {e})")
        err["fused_rope_attention"] = max(
            err["fused_rope_attention"],
            k4_forward_check(torch, fua, q, k, v, k4_tables, n))
    return err


def live_clips(np, cfg):
    """Each session's seeded 30 s of int16 PCM (noise at 0.3 of full
    scale)."""
    rng = np.random.default_rng(8)
    return [(rng.standard_normal(cfg.sr * LIVE_SECONDS) * 0.3 * 32767)
            .clip(-32768, 32767).astype(np.int16)
            for _ in range(LIVE_SESSIONS)]


def pcm_wav(pcm, sr: int) -> bytes:
    """16-bit mono WAV bytes of int16 samples, as they are."""
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def live_pushes(np, clip, as_int16: bool, step):
    """A session's pushes of `step` samples: int16, or the same samples as
    float32 (pcm / 32768). The first half of a run's sessions push int16,
    the second half float32."""
    for i in range(0, len(clip), step):
        chunk = clip[i: i + step]
        yield chunk if as_int16 else chunk.astype(np.float32) / 32768.0


def live_run(torch, np, ms, clips, cfg):
    """The live schedule through `ms`: session j opens at tick
    LIVE_STAGGER·j and pushes LIVE_PUSH s a tick, one tick() a round of
    pushes, then each session is flushed and closed. Returns ({j: frames},
    wall s)."""
    step = int(cfg.sr * LIVE_PUSH)
    feeds, sids, out = {}, {}, {}
    t0 = time.perf_counter()
    for r in range(-(-len(clips[0]) // step) + LIVE_STAGGER * (len(clips) - 1)):
        if r % LIVE_STAGGER == 0 and r // LIVE_STAGGER < len(clips):
            j = r // LIVE_STAGGER
            sids[j] = ms.open()
            feeds[j] = live_pushes(np, clips[j], j < len(clips) // 2, step)
            out[j] = []
        for j, sid in sids.items():
            chunk = next(feeds[j], None)
            if chunk is not None:
                ms.push_audio(sid, chunk)
        ms.tick()
        for j, sid in sids.items():
            out[j].append(ms.pop_frames(sid))
    for j, sid in sids.items():
        ms.flush(sid)
        out[j].append(ms.pop_frames(sid))
        ms.close(sid)
    torch.cuda.synchronize()
    return ({j: np.concatenate(f) for j, f in out.items()},
            time.perf_counter() - t0)


def live_latency(torch, np, ms, cfg, clip) -> None:
    """One session at real-time cadence: a LIVE_PUSH s push every LIVE_PUSH
    s of wall time for LIVE_LATENCY_SECONDS, each followed by tick() and
    pop_frames(); prints the wall time of the rounds that returned frames
    and how far the finalised frames trail the pushed audio."""
    step = int(cfg.sr * LIVE_PUSH)
    sid = ms.open()
    ms_out, lag, pushed, frames = [], [], 0, 0
    start = time.perf_counter()
    for p in range(int(LIVE_LATENCY_SECONDS / LIVE_PUSH)):
        time.sleep(max(0.0, start + p * LIVE_PUSH - time.perf_counter()))
        t0 = time.perf_counter()
        ms.push_audio(sid, clip[p * step: (p + 1) * step])
        ms.tick()
        got = ms.pop_frames(sid)
        dt = (time.perf_counter() - t0) * 1e3
        pushed += step
        frames += len(got)
        if len(got):
            ms_out.append(dt)
            lag.append(pushed / cfg.sr - frames / cfg.frame_rate)
    ms.flush(sid)
    ms.pop_frames(sid)
    ms.close(sid)
    check(len(ms_out) > 0, "the real-time session returned frames")
    print(f"live latency ('auto', one session, {LIVE_PUSH} s pushes at "
          f"real-time cadence for {LIVE_LATENCY_SECONDS} s, host clock): "
          f"{len(ms_out)} of {int(LIVE_LATENCY_SECONDS / LIVE_PUSH)} push "
          f"rounds returned frames, push → frames {statistics.median(ms_out):.3f} "
          f"ms median, {max(ms_out):.3f} ms max; finalised frames trail the "
          f"pushed audio by {min(lag):.3f}–{max(lag):.3f} s", flush=True)


def live_http(torch, np, model, cfg, clip) -> None:
    """The HTTP server on 127.0.0.1 (an ephemeral port, in a thread) with
    the same model: the batch endpoint equals the API, a live session in
    s16 opens, pushes, flushes and closes, /metrics and /healthz answer."""
    import threading
    import urllib.request

    from neurosync_trainer_lite_tpu_torch.inference.api import (
        generate_facial_data_from_bytes)
    from neurosync_trainer_lite_tpu_torch.inference.server import serve
    from neurosync_trainer_lite_tpu_torch.ops.frontend import num_frames_60

    httpd = serve(model, cfg, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, data=None, headers=None):
        req = urllib.request.Request(base + path, data=data, headers=headers
                                     or {}, method="GET" if data is None
                                     else "POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.load(r)

    try:
        wav = (REPO / "dataset" / "test_set" / "audio.wav").read_bytes()
        got = np.asarray(call("/audio_to_blendshapes", wav)["blendshapes"])
        want = generate_facial_data_from_bytes(wav, model, cfg)
        e, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        check(got.shape == want.shape and e <= 1e-6 * scale,
              f"HTTP POST /audio_to_blendshapes equals the API's output "
              f"{want.shape} (max abs diff {e})")
        sid = call("/session/open", b"")["session"]
        pcm = clip[: 3 * cfg.sr]
        step = int(cfg.sr * LIVE_PUSH)
        frames = []
        for i in range(0, len(pcm), step):
            r = call(f"/session/{sid}/audio", pcm[i: i + step].tobytes(),
                     {"X-Audio-Format": "s16"})
            frames += r["blendshapes"]
        frames += call(f"/session/{sid}/flush", b"")["blendshapes"]
        check(call(f"/session/{sid}/close", b"") == {"ok": True},
              "HTTP live session closed")
        frames = np.asarray(frames)
        n = num_frames_60(len(pcm), int(0.01667 * cfg.sr))
        check(frames.shape == (n, cfg.output_dim)
              and bool(np.isfinite(frames).all()),
              f"HTTP live session (s16 pushes of {LIVE_PUSH} s): "
              f"{frames.shape} finite frames, {n} expected")
        m = call("/metrics")
        check(call("/healthz") == {"ok": True} and m["streamer_started"]
              and m["ticks"] > 0 and m["live_sessions"] == 0
              and m["ring_recoveries"] == 0 and m["watchdog_flips"] == 0,
              f"HTTP /healthz and /metrics answer: {m}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)


def live_against_streamer(np, model, cfg, ms, j, clip, got, as_int16: bool,
                          limit: float) -> float:
    """Session j's frames `got` against an independent BlendshapeStreamer
    fed the same pushes with the MultiStreamer's trim settings, within
    `limit` of max|out|. Returns the max abs error over max|out|."""
    from neurosync_trainer_lite_tpu_torch.inference.streaming import (
        BlendshapeStreamer)

    single = BlendshapeStreamer(model, cfg)
    single.TRIM_THRESHOLD_FRAMES = ms.trim_threshold
    single.TRIM_MARGIN_FRAMES = ms.trim_margin
    for chunk in live_pushes(np, clip, as_int16, int(cfg.sr * LIVE_PUSH)):
        single.push_audio(chunk)
    single.flush()
    want = single.pop_frames()
    scale = float(np.abs(want).max())
    diff = np.abs(got - want) if got.shape == want.shape else np.array(
        [math.inf])
    e = float(diff.max())
    check(e <= limit * scale,
          f"live session {j} ({'int16' if as_int16 else 'float32'} pushes, "
          f"{'bf16' if cfg.use_amp else 'fp32'}) against "
          f"an independent BlendshapeStreamer within {limit:g} of max|out| "
          f"(max abs err {e:.3e}, mean {float(diff.mean()):.3e}, max|out| "
          f"{scale:.3e})")
    return e / scale


def live_fp32(torch, np, clips) -> float:
    """The live path's arithmetic without bf16: the full-width model in
    fp32 ('auto'), two sessions of LIVE_FP32_SECONDS through a
    MultiStreamer, each against its own BlendshapeStreamer within 1e-4 of
    max|out| (fp32 features that differ in summation order, ~1e-6; a
    misplaced window or row would differ by O(1)). Returns the largest
    error over max|out|."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.inference.multi_stream import (
        MultiStreamer)
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq

    cfg = Config(dropout=0.0, use_amp=False)
    model = init_seq2seq(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda").eval()
    ms = MultiStreamer(model, cfg, max_sessions=LIVE_SESSIONS)
    short = [clip[: cfg.sr * LIVE_FP32_SECONDS] for clip in
             (clips[0], clips[-1])]
    outputs, _ = live_run(torch, np, ms, short, cfg)
    err = max(live_against_streamer(np, model, cfg, ms, j, clip, outputs[j],
                                    j == 0, 1e-4)
              for j, clip in enumerate(short))
    del model, ms
    return err


def live_models(torch):
    """Config() at dropout 0 and the full-width model on seeded weights, at
    'auto' and at 'pallas'."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import (
        Seq2Seq, init_seq2seq)

    cfg = Config(dropout=0.0)
    models = {"auto": init_seq2seq(cfg, torch.Generator(device="cuda")
                                   .manual_seed(0), device="cuda").eval()}
    models["pallas"] = Seq2Seq(cfg.replace(attention_impl="pallas"), "cuda")
    models["pallas"].load_state_dict(models["auto"].state_dict())
    models["pallas"].eval()
    return cfg, models


def live(torch, np):
    """Phase 7c: live serving of the full-width model at 'auto' and
    'pallas': LIVE_SESSIONS sessions of LIVE_SECONDS s each through one
    MultiStreamer (the main path run, launches counted from zero), held
    against independent BlendshapeStreamers and the offline API; then a
    profiled repeat, one session at real-time cadence, and the HTTP
    server."""
    from neurosync_trainer_lite_tpu_torch.inference.api import (
        generate_facial_data_from_bytes)
    from neurosync_trainer_lite_tpu_torch.inference.multi_stream import (
        MultiStreamer)
    from neurosync_trainer_lite_tpu_torch.ops import kernels

    err = live_kernel_checks(torch)
    cfg, models = live_models(torch)
    clips = live_clips(np, cfg)
    streamers = {}
    for impl, model in models.items():
        ms = MultiStreamer(model, cfg, max_sessions=LIVE_SESSIONS)
        t0 = time.perf_counter()
        n = ms.warmup()
        print(f"live: MultiStreamer at '{impl}', {LIVE_SESSIONS} sessions, "
              f"ring [{ms._buf.shape[0]}, {ms._buf.shape[1]}] fp32, push "
              f"capacity {ms.push_capacity}, {ms._t60_cap} feature rows, "
              f"f_win {ms.f_win}, decode cap {ms.decode_bucket_cap}; warmup "
              f"{n} runs in {time.perf_counter() - t0:.3f} s", flush=True)
        streamers[impl] = ms

    # the main path run: counts from zero, both impls
    forwards = {}
    hooks = [model.register_forward_hook(
        lambda *_, impl=impl: forwards.__setitem__(
            impl, forwards.get(impl, 0) + 1))
        for impl, model in models.items()]
    kernels.reset_launches()
    launches, outputs = {}, {}
    for impl, ms in streamers.items():
        before = dict(kernels.LAUNCHES)
        outputs[impl], wall = live_run(torch, np, ms, clips, cfg)
        launches[impl] = {name: count - before.get(name, 0)
                          for name, count in kernels.LAUNCHES.items()
                          if count - before.get(name, 0)}
        m = ms.metrics_snapshot()
        total = sum(len(f) for f in outputs[impl].values())
        print(f"live at '{impl}': {m['ticks']} ticks, tick p50 "
              f"{m['tick_p50_ms']} ms, p95 {m['tick_p95_ms']} ms, max "
              f"{m['tick_max_ms']} ms (metrics_snapshot, host clock); "
              f"{m['decode_ticks']} decode ticks, {m['frames_out']} frames "
              f"out, {forwards.get(impl, 0)} decode forwards; {total} frames "
              f"in {wall:.3f} s: {total / wall:.1f} frames/s across "
              f"{LIVE_SESSIONS} sessions", flush=True)
        check(m["ring_recoveries"] == 0 and m["watchdog_flips"] == 0,
              f"live at '{impl}': ring_recoveries {m['ring_recoveries']} "
              f"and watchdog_flips {m['watchdog_flips']} are 0")
        check(m["frames_out"] == total, f"live at '{impl}': frames_out "
              f"{m['frames_out']} counts the {total} frames popped")
    main_path = dict(kernels.LAUNCHES)
    for hook in hooks:
        hook.remove()
    expected = {"auto": {"rope_rotate": 50, **LN_FORWARD},
                "pallas": {"rope_rotate": 2, "fused_rope_attention": 24,
                           **LN_FORWARD}}
    for impl in models:
        want = {name: count * forwards[impl]
                for name, count in expected[impl].items()}
        check(launches[impl] == want,
              f"live at '{impl}': kernel launches {launches[impl]} == "
              f"{expected[impl]} a decode forward x {forwards[impl]}")
    check(main_path.get("rope_rotate", 0) > 0
          and main_path.get("fused_rope_attention", 0) > 0,
          f"K1 and the K4 forward ran in the live path run: {main_path}")

    n = int(0.01667 * cfg.sr)
    errs = {"streamer": 0.0, "offline": 0.0}
    for j, clip in enumerate(clips):
        got = outputs["auto"][j]
        want_frames = (len(clip) + 2 * (n // 2)) // (n // 2) - 1
        check(got.shape == (want_frames // 2 + want_frames % 2,
                            cfg.output_dim) and bool(np.isfinite(got).all()),
              f"live session {j}: {got.shape} finite frames")
        # bf16 over 16 layers: fp32 features that differ in summation order
        # (other pad buckets) round to bf16 differently here and there; the
        # serve phase's 5% of max|out| for bf16 roundings at other places
        errs["streamer"] = max(errs["streamer"], live_against_streamer(
            np, models["auto"], cfg, streamers["auto"], j, clip, got,
            j < LIVE_SESSIONS // 2, 0.05))
        offline = generate_facial_data_from_bytes(pcm_wav(clip, cfg.sr),
                                                  models["auto"], cfg)
        core = len(offline) - cfg.frame_size
        a, b = got[:core], offline[:core]
        scale = float(np.abs(b).max())
        mean_e = float(np.abs(a - b).mean())
        corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
        errs["offline"] = max(errs["offline"], float(np.abs(a - b).max())
                              / scale)
        check(got.shape == offline.shape and corr >= 0.98
              and mean_e <= 0.05 * scale,
              f"live session {j} against the offline API on its {core} core "
              f"rows, to the CMVN drift of a trimmed buffer: correlation "
              f"{corr:.5f} >= 0.98, mean abs err {mean_e:.3e} <= 5% of "
              f"max|out| {scale:.3e} (max abs err "
              f"{float(np.abs(a - b).max()):.3e})")
    for j in outputs["auto"]:
        a, p = outputs["auto"][j], outputs["pallas"][j]
        e, scale = float(np.abs(a - p).max()), float(np.abs(a).max())
        check(a.shape == p.shape and e <= 0.05 * scale,
              f"live session {j}: 'auto' and 'pallas' agree within 5% of "
              f"max|out| (max abs diff {e:.3e}, max|out| {scale:.3e})")
    errs["streamer fp32"] = live_fp32(torch, np, clips)
    print(f"live: largest error against the streamers {errs['streamer']:.3e} "
          f"(bf16), {errs['streamer fp32']:.3e} (fp32) "
          f"and against the offline API {errs['offline']:.3e} of max|out|; "
          f"kernel checks at D = 1, {LIVE_SESSIONS}: {err}", flush=True)

    ms = MultiStreamer(models["auto"], cfg, max_sessions=LIVE_SESSIONS)
    ms.warmup()
    profile_once(torch, lambda: live_run(torch, np, ms, clips, cfg),
                 f"live run at 'auto' ({LIVE_SESSIONS} sessions of "
                 f"{LIVE_SECONDS} s)", top=8)
    live_latency(torch, np, streamers["auto"], cfg, clips[0])
    live_http(torch, np, models["auto"], cfg, clips[0])
    del models, streamers, ms
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

    clips = {
        "test_set/audio.wav": (REPO / "dataset" / "test_set"
                               / "audio.wav").read_bytes(),
        "30 s seeded": seeded_wav(np, cfg.sr),
    }
    expected = {"auto": {"rope_rotate": 50, **LN_FORWARD},
                "pallas": {"rope_rotate": 2, "fused_rope_attention": 24,
                           **LN_FORWARD}}
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

    fps = {impl: request_timing(torch, np, model, cfg, clips["30 s seeded"],
                                f"'{impl}'")
           for impl, model in models.items()}
    return main_path, fps


def request_timing(torch, np, model, cfg, wav: bytes, label: str) -> float:
    """The 30 s request's frames/s, its stages, and the card's busy share.
    Returns the frames/s of the median request."""
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
    return len(out) / med * 1e3


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
    gc.collect()   # no earlier phase's garbage collected in the timed steps
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
    run, {'samples_per_s', 'peak', 'median_ms'} of (a) and 'medians_ms',
    the step median of (a), (b), (c) and (e) by letter)."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq
    from neurosync_trainer_lite_tpu_torch.ops import fused_attention as fua

    configs = {"a": Config(), "b": Config(attention_impl="pallas",
                                          dropout=0.0)}
    expected = {"a": {"rope_rotate": 100, **LN_STEP, **LA_STEP, **FFN_STEP},
                "b": {"rope_rotate": 52, "fused_rope_attention": 24,
                      "fused_rope_attention_bwd": 24, **LN_STEP,
                      **FFN_STEP}}
    base = configs["a"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    weights = init_seq2seq(base, gen, device="cuda").state_dict()
    src, trg = train_batch(torch, base, gen)
    print(f"train: batch {base.batch_size} x {base.micro_batch_size} frames "
          f"x {base.input_dim} → {base.output_dim}, bf16 over fp32, lr "
          f"{base.learning_rate}, clip {base.grad_clip}, {TRAIN_WARMUP} "
          f"warm-up + {TRAIN_TIMED} timed steps", flush=True)

    main_path, step_a, medians = {}, {}, {}
    for name, cfg in configs.items():
        label = f"({name}) '{cfg.attention_impl}', dropout {cfg.dropout}"
        launches, _, peak, med, profiled = train_config(
            torch, cfg, weights, src, trg, label, expected[name],
            warmup=TRAIN_WARMUP, timed=TRAIN_TIMED)
        main_path[f"train ({name})"] = launches
        medians[name] = med * 1e3
        if name == "a":
            step_a = {"samples_per_s": cfg.batch_size / med, "peak": peak,
                      "median_ms": med * 1e3}
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
    main_path.update(train_remat_lean(torch, configs["a"], weights, src,
                                      trg))
    main_path.update(train_ffn_fused(torch, configs["a"], weights, src, trg,
                                     medians))
    main_path.update(train_long_windows(torch, weights, medians))
    step_a["medians_ms"] = medians
    return main_path, step_a


def train_remat_lean(torch, cfg, weights, src, trg) -> dict:
    """(a) with remat=True: one step of cfg (window 128, bf16, dropout 0.3)
    with every layer rematted and one without, from the same weights,
    batch and dropout seeds. The rematted step launches the lean attention
    forward again in the backward at each of the 24 sites (LA_REMAT_STEP:
    48 + 24), K1 again for q and k and the layers' LayerNorm forwards again;
    its loss, grad norm and every parameter's gradient equal the step's
    without remat (relative 1e-6; bitwise printed)."""
    from neurosync_trainer_lite_tpu_torch.ops import kernels
    from neurosync_trainer_lite_tpu_torch.training.step import (
        init_train_state, make_train_step)

    runs = {"no remat": (cfg, {"rope_rotate": 100, **LN_STEP, **LA_STEP,
                               **FFN_STEP}),
            "remat 'all'": (cfg.replace(remat=True), LA_REMAT_STEP)}
    got = {}
    for name, (run_cfg, expected) in runs.items():
        state = init_train_state(run_cfg, 1000, device="cuda",
                                 state_dict=weights)
        step = make_train_step(run_cfg)
        torch.cuda.synchronize()
        kernels.reset_launches()
        _, loss, norm = step(state, src, trg, torch.Generator().manual_seed(4))
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        check(launches == expected, f"train (a) {name}: kernel launches of "
              f"one step {launches} == {expected}")
        grads = {key: p.grad.detach().clone()
                 for key, p in state.model.named_parameters()
                 if p.grad is not None}
        got[name] = (float(loss), float(norm), grads, launches)
        del state, step
        torch.cuda.empty_cache()
    ref_loss, ref_norm, ref_grads, _ = got["no remat"]
    loss, norm, grads, launches = got["remat 'all'"]
    check(grads.keys() == ref_grads.keys() and len(grads) > 0,
          f"train (a) remat 'all': gradients of the same {len(ref_grads)} "
          f"parameters as without remat")
    gap = max(abs(loss - ref_loss) / abs(ref_loss),
              abs(norm - ref_norm) / abs(ref_norm))
    worst = max(((grads[key] - g).abs().max()
                 / g.abs().max().clamp_min(1e-30)).item()
                for key, g in ref_grads.items())
    bitwise = (loss == ref_loss and norm == ref_norm
               and all(torch.equal(grads[key], g)
                       for key, g in ref_grads.items()))
    check(gap <= 1e-6 and worst <= 1e-6,
          f"train (a) remat 'all' (window 128, dropout 0.3, the lean "
          f"attention kernels): loss {loss:.6f} and grad norm {norm:.6f} "
          f"equal the no-remat step's (largest relative difference "
          f"{gap:.3e}), every gradient within {worst:.3e} of its largest "
          f"magnitude (bitwise {bitwise})")
    del got, grads, ref_grads
    torch.cuda.empty_cache()
    return {"train (a) remat 'all'": launches}


def train_ffn_fused(torch, cfg, weights, src, trg, medians: dict):
    """Phase 10 (e): step (a) with the model's FFN routed through ffn_fused
    (seq2seq._ffn rebound, as tools/tpu_probe.py rebinds the JAX model's),
    so that the FFN backward runs K2: K2 = 16 (8 + 8 FFNs) and K1 = 100
    launches a step, samples/s, peak memory and busy share beside (a); one
    step with the default _ffn again runs no K2. Then K2's gradients inside
    the model at dropout 0 against the default path and fp32, with a
    planted fault (db1 zeroed) that the check must catch."""
    from neurosync_trainer_lite_tpu_torch.models import layers, seq2seq
    from neurosync_trainer_lite_tpu_torch.ops import ffn_bwd

    default = seq2seq._ffn
    seq2seq._ffn = layers.ffn_fused
    label = (f"(e) '{cfg.attention_impl}', dropout {cfg.dropout}, FFN "
             f"backward through K2")
    try:
        launches, _, _, med, profiled = train_config(
            torch, cfg, weights, src, trg, label,
            {"rope_rotate": 100, "ffn_bwd_dh1": 16, **LN_STEP, **LA_STEP,
             **FFN_K2_STEP},
            warmup=TRAIN_WARMUP, timed=TRAIN_TIMED)
    finally:
        seq2seq._ffn = default
    medians["e"] = med * 1e3
    kernel_shares(f"step at {label}", profiled, {
        "K2": (r"ffn_bwd_wgmma_kernel", r"ffn_bwd_wmma_kernel"),
        "K1": (r"rope_rows", None)})
    train_config(torch, cfg, weights, src, trg, "(e) with the default _ffn "
                 "again", {"rope_rotate": 100, **LN_STEP, **LA_STEP,
                           **FFN_STEP},
                 warmup=0, timed=0, profile=False, falls=False)

    sound = ffn_bwd.ffn_bwd_dh1_cuda

    def zero_db1(dy, w2, am, *, scale):
        dh1, db2, db1 = sound(dy, w2, am, scale=scale)
        return dh1, db2, torch.zeros_like(db1)

    c0 = cfg.replace(dropout=0.0)
    fused = [(seq2seq, "_ffn", layers.ffn_fused)]
    gradients_in_model(
        torch, weights, src, trg, fp32=(c0.replace(use_amp=False), []),
        baseline=("the default _ffn", c0, []),
        kernel=("ffn_fused", c0, fused),
        planted=(c0, fused + [(ffn_bwd, "ffn_bwd_dh1_cuda", zero_db1)]),
        leaves=r"\.ffn\.linear[12]\.(weight|bias)$",
        leaf_kind="FFN linear1/linear2 weight and bias", what="K2",
        fault="zeroes db1")
    return {"train (e)": launches}


def train_long_windows(torch, weights, medians: dict):
    """Phase 9: the full-width model at long windows, where 'auto' takes
    K3: (c) window 512, batch 32, no remat; (d) window 2048 (MAX_KV_LEN),
    batch 8, with and without remat, and one step each at remat_policy
    'dots' and at remat_scope='decoder', remat_layers=2. Each holds 16,384
    frames a step, as (a) and (b)."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    main_path = {}

    def k3(fwd, bwd=24, rope=100, norms=0, ffns=0):
        return {"rope_rotate": rope, "flash_attention": fwd,
                "flash_attention_bwd_dq": bwd, "flash_attention_bwd_dkdv": bwd,
                **LN_STEP,
                "layer_norm_fwd": LN_STEP["layer_norm_fwd"] + norms,
                **FFN_STEP, "ffn_epi_fwd": FFN_STEP["ffn_epi_fwd"] + ffns}

    cfg_c = Config(dropout=0.0, batch_size=32, micro_batch_size=512)
    src, trg = train_batch(torch, cfg_c, gen)
    print(f"train (c): batch 32 x 512 frames, 'auto', dropout 0, no remat, "
          f"{TRAIN_WARMUP} warm-up + {TRAIN_TIMED} timed steps", flush=True)
    label = "(c) window 512, 'auto'"
    main_path["train (c)"], _, _, med, profiled = train_config(
        torch, cfg_c, weights, src, trg, label, k3(24),
        warmup=TRAIN_WARMUP, timed=TRAIN_TIMED)
    medians["c"] = med * 1e3
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
    # backward: K3 forward once per attention, K1 twice (q and k), the
    # LayerNorm forward once per LayerNorm of a layer (2 an encoder layer,
    # 3 a decoder layer; the stacks' final ones are outside the layers),
    # the FFN epilogue's forward once per layer
    runs = {
        "no remat": (cfg_d, k3(24), 1, 3),
        "remat 'all'": (cfg_d.replace(remat=True),
                        k3(48, rope=148, norms=40, ffns=16), 1, 3),
        "remat 'dots'": (cfg_d.replace(remat=True, remat_policy="dots"),
                         k3(48, rope=148, norms=40, ffns=16), 0, 0),
        "remat 'decoder', 2 layers": (
            cfg_d.replace(remat=True, remat_scope="decoder", remat_layers=2),
            k3(28, rope=108, norms=6, ffns=2), 0, 0),
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
        epoch_stats_readable(os.path.join(cfg.plots_dir, "stats"), 3)
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
    core (its kernels at windows up to 128), and at the `kernel` impl,
    where it takes the kernel (`what`) forward and backward, each held against the same step in fp32
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


def dp_weights(torch, cfg):
    """The training phase's seeded full-width weights and batch (train()),
    drawn alike in every process."""
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq

    gen = torch.Generator(device="cuda").manual_seed(3)
    weights = init_seq2seq(cfg, gen, device="cuda").state_dict()
    return (weights, *train_batch(torch, cfg, gen))


def params_checksum(torch, model) -> int:
    """The sum of the parameters' fp32 bit patterns: equal bits, equal sum."""
    return sum(int(p.detach().view(torch.int32).to(torch.int64).sum())
               for p in model.parameters())


def dp_run(torch, cfg, weights, src, trg, mesh, *, keep=False,
           steps=DP_STEPS, rows=None, after=None) -> dict:
    """`steps` steps of cfg from `weights` on this rank's rows of (src,
    trg) (parallel/mesh.py:batch_rows, or `rows`; every row without a
    mesh), one step generator as train_config's: losses, grad norms, the
    median step ms, the peak device memory, the parameters' checksum and,
    with keep, the parameters on the host; `after(state, step, s, t, gen)`
    adds its dict of results last."""
    from neurosync_trainer_lite_tpu_torch.parallel import batch_rows
    from neurosync_trainer_lite_tpu_torch.training.step import (
        init_train_state, make_train_step)

    state = init_train_state(cfg, 1000, device="cuda", state_dict=weights,
                             mesh=mesh)
    step = make_train_step(cfg, mesh=mesh)
    if rows is None:
        rows = batch_rows(mesh, src.shape[0], cfg.grad_accum_steps)
    rows = torch.from_numpy(rows).cuda()
    s, t = src[rows], trg[rows]
    gen = torch.Generator().manual_seed(4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, loss, norm = step(state, s, t, gen)
        losses.append(float(loss))       # float() synchronises
        norms.append(float(norm))
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"losses": losses, "norms": norms,
           "step_ms": statistics.median(times),
           "peak": torch.cuda.max_memory_allocated(),
           "checksum": params_checksum(torch, state.model), "rows": len(s)}
    if keep:
        out["params"] = [p.detach().cpu() for p in state.model.parameters()]
    if after is not None:
        out.update(after(state, step, s, t, gen))
    del state, step
    torch.cuda.empty_cache()
    return out


def dp_p1(torch, port: int) -> dict:
    """(p1), one process: the references of (p1) and (p2) with no process
    group, then step (a) through an NCCL group of one rank and its
    all-reduce, which must equal the run without a group bit for bit."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.ops import kernels
    from neurosync_trainer_lite_tpu_torch.parallel import (
        distributed, make_mesh)

    base = Config()
    weights, src, trg = dp_weights(torch, base)
    refs = {label: dp_run(torch, base.replace(**kw), weights, src, trg, None,
                          keep=not kw)
            for label, kw in DP_CONFIGS.items()}
    plain = refs["'auto', dropout 0.3"]
    distributed.initialize_distributed(f"127.0.0.1:{port}", 1, 0,
                                       timeout_s=DP_GROUP_TIMEOUT)
    try:
        mesh = make_mesh(base)
        kernels.reset_launches()
        got = dp_run(torch, base, weights, src, trg, mesh, keep=True)
        launches = dict(kernels.LAUNCHES)
    finally:
        distributed.destroy()
    check(got["losses"] == plain["losses"] and got["norms"] == plain["norms"]
          and all(torch.equal(a, b) for a, b in zip(got["params"],
                                                     plain["params"])),
          f"(p1) {DP_STEPS} steps of (a) through an NCCL group of one rank "
          f"and its all-reduce equal {DP_STEPS} steps with no group bit for "
          f"bit: losses {got['losses']}, grad norms {got['norms']}, every "
          f"parameter")
    print(f"(p1) one rank, NCCL: step median {got['step_ms']:.3f} ms (no "
          f"group {plain['step_ms']:.3f}), peak device memory {got['peak']} "
          f"bytes (no group {plain['peak']})", flush=True)
    for run in (*refs.values(), got):
        run.pop("params", None)
    return {"refs": refs, "group": got, "launches": launches}


def dp_decode(torch, np, mesh, tag: str = "(p3)",
              fp32_limit: float = 1e-4) -> dict:
    """(p3) and (t2): MeshDecoder over the mesh's ranks against
    decode_chunks_batched on one, the 30 s request's chunks at frame_size
    128, 'auto' and 'pallas' in bf16 (5% of max|out|) and 'auto' in fp32
    (fp32_limit of max|out|), standalone and through
    process_audio_features. The launches of the MeshDecoder calls."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.data.processing import (
        extract_audio_features)
    from neurosync_trainer_lite_tpu_torch.inference.chunked import (
        MeshDecoder, decode_chunks_batched, process_audio_features)
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import (
        Seq2Seq, init_seq2seq)
    from neurosync_trainer_lite_tpu_torch.ops import kernels

    cfg = Config(dropout=0.0)
    wav = seeded_wav(np, cfg.sr)
    feats, _ = extract_audio_features(wav, cfg.sr, from_bytes=True,
                                      device="cuda")
    weights = init_seq2seq(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda").state_dict()
    runs = {"'auto' bf16": cfg, "'pallas' bf16": cfg.replace(
        attention_impl="pallas"), "'auto' fp32": cfg.replace(use_amp=False)}
    models, wants = {}, {}
    for label, c in runs.items():
        model = Seq2Seq(c, "cuda")
        model.load_state_dict(weights)
        models[label] = model.eval()
        captured = []

        def record(m, chunks, cc, captured=captured):
            captured.append(chunks)
            return decode_chunks_batched(m, chunks, cc)

        frames = process_audio_features(feats, model, c, decode_batched=record)
        chunks = captured[0]
        wants[label] = (chunks, decode_chunks_batched(model, chunks, c),
                        frames)
    torch.cuda.synchronize()
    kernels.reset_launches()
    gots = {}
    for label, c in runs.items():
        dec = MeshDecoder(models[label], c, mesh)
        gots[label] = (dec(models[label], wants[label][0], c),
                       process_audio_features(feats, models[label], c,
                                              decode_batched=dec))
    launches = dict(kernels.LAUNCHES)
    out = {"launches": launches, "sums": {}}
    for label, (chunks, ref_chunks, ref_frames) in wants.items():
        got_chunks, got_frames = gots[label]
        tol = fp32_limit if "fp32" in label else 0.05
        for what, got, ref in (("chunks", got_chunks, ref_chunks),
                               ("frames", got_frames, ref_frames)):
            e, scale = float(np.abs(got - ref).max()), float(
                np.abs(ref).max())
            check(got.shape == ref.shape and bool(np.isfinite(got).all())
                  and e <= tol * scale,
                  f"{tag} MeshDecoder at {mesh.shape}, {label}, {what} "
                  f"{tuple(got.shape)} (from {chunks.shape[0]} chunks): "
                  f"within {tol:g} of max|out| of one rank's decode (max abs "
                  f"diff {e}, max|out| {scale}: {e / scale:.3e} of it)")
        out["sums"][label] = [float(got_chunks.sum()), float(got_frames.sum())]
    check(all(w[0].shape[0] == serving_shape(cfg)[0] for w in wants.values()),
          f"{tag} the 30 s request decodes as {serving_shape(cfg)[0]} "
          f"chunks")
    del models
    torch.cuda.empty_cache()
    return out


def dp_train_model(torch, np, tmp: str, rank: int) -> dict:
    """(p4): train_model at dp 2 on the copy of dataset/data in tmp,
    validating on dataset/test_set: one epoch, a checkpoint, a resume for
    the second; rank 0's model.pth serves test_set/audio.wav."""
    import os

    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.inference.api import (
        generate_facial_data_from_bytes)
    from neurosync_trainer_lite_tpu_torch.ops import kernels
    from neurosync_trainer_lite_tpu_torch.training.loop import train_model
    from neurosync_trainer_lite_tpu_torch.utils.weights import load_model

    test_set = REPO / "dataset" / "test_set"
    out = os.path.join(tmp, "p4")
    cfg = Config(root_dir=os.path.join(tmp, "data"), n_epochs=1,
                 audio_path=str(test_set / "audio.wav"),
                 ground_truth_path=str(test_set / "testset.csv"),
                 model_path=os.path.join(out, "model.pth"),
                 checkpoint_path=os.path.join(out, "checkpoints",
                                              "checkpoint"),
                 plots_dir=os.path.join(out, "plots"))
    history = {}
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    _, steps = train_model(cfg, device="cuda", history_out=history)
    _, total = train_model(cfg.replace(mode="resume", n_epochs=2),
                           device="cuda", history_out=history)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = history["train_losses"]
    check(total == 2 * steps == len(losses) > 0
          and all(math.isfinite(x) for x in losses + history["val_losses"]
                  + history["grad_norms"]),
          f"(p4) rank {rank}: {steps} steps in the first epoch, the resume "
          f"continues to {total}, every loss and grad norm finite")
    if rank == 0:
        model = load_model(cfg.model_path, Config(), device="cuda")
        frames = generate_facial_data_from_bytes(
            (test_set / "audio.wav").read_bytes(), model, Config())
        check(isinstance(frames, np.ndarray) and frames.ndim == 2
              and frames.shape[1] == 61 and bool(np.isfinite(frames).all()),
              f"(p4) rank 0's model.pth serves test_set/audio.wav: "
              f"{frames.shape} finite frames")
        del model
    return {"launches": launches, "steps": steps, "total": total,
            "peak": peak, **{k: history[k] for k in ("train_losses", "val_losses",
                                       "grad_norms", "epoch_seconds",
                                       "epoch_samples")}}


def dp_first_step_gaps(got: dict, ref: dict) -> tuple[float, float]:
    """The first step's relative loss and grad norm gaps of a dp run
    against one process."""
    return (abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            abs(got["norms"][0] - ref["norms"][0]) / ref["norms"][0])


def dp_planted(torch, np, base, weights, src, trg, mesh) -> dict:
    """One step of (p2)'s dropout-0.3 runs with each fault planted that the
    step-1 gate must catch: a rank's rows as one contiguous block under
    accumulation (its micro-batch i then is not its share of the global
    micro-batch i, so its masks are other rows'), and masks drawn over the
    rank's own rows instead of its block of the global draw."""
    from neurosync_trainer_lite_tpu_torch.ops import attention as attn
    from neurosync_trainer_lite_tpu_torch.training import step as step_mod

    accum = base.replace(grad_accum_steps=2)
    m = base.batch_size // mesh.dp
    contiguous = np.arange(mesh.data_index * m, (mesh.data_index + 1) * m)
    out = {"contiguous rows, accum 2": dp_run(
        torch, accum, weights, src, trg, mesh, steps=1, rows=contiguous)}
    plain_rows = step_mod.dropout_rows
    step_mod.dropout_rows = lambda n, i, *width: attn.dropout_rows(1, 0)
    try:
        out["masks over the local rows"] = dp_run(
            torch, base, weights, src, trg, mesh, steps=1)
    finally:
        step_mod.dropout_rows = plain_rows
    return out


def dp_p2(torch, np, port: int, rank: int, tmp: str) -> dict:
    """(p2)–(p4) on rank `rank` of two, over gloo, both on the one card."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.ops import kernels
    from neurosync_trainer_lite_tpu_torch.parallel import (
        distributed, make_mesh)

    distributed.initialize_distributed(f"127.0.0.1:{port}", 2, rank,
                                       backend="gloo",
                                       timeout_s=DP_GROUP_TIMEOUT)
    try:
        base = Config()
        mesh = make_mesh(base)
        weights, src, trg = dp_weights(torch, base)
        kernels.reset_launches()
        runs = {label: dp_run(torch, base.replace(**kw), weights, src, trg,
                              mesh)
                for label, kw in DP_CONFIGS.items()}
        launches = dict(kernels.LAUNCHES)
        planted = dp_planted(torch, np, base, weights, src, trg, mesh)
        n = sum(t.numel() for t in weights.values())
        flat = torch.ones(n + 1, device="cuda")
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            distributed.all_reduce_mean_(flat, mesh)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        del flat, weights, src, trg
        torch.cuda.empty_cache()
        decode = dp_decode(torch, np, mesh)
        trained = dp_train_model(torch, np, tmp, rank)
    finally:
        distributed.destroy()
    return {"runs": runs, "launches": launches, "planted": planted,
            "allreduce_ms": statistics.median(times[1:]),
            "allreduce_bytes": 4 * (n + 1), "decode": decode,
            "train_model": trained}


def dp_worker(torch, np, part: str, rank: int, port: int, tmp: str) -> None:
    """One rank of the parallel phase: its results as JSON in tmp."""
    import os

    if part == "p1":
        result = dp_p1(torch, port)
    elif part == "c4":
        result = compat_profile_worker(torch, tmp)
    elif part.startswith("t"):
        result = tp_worker(torch, np, part, rank, port, tmp)
    else:
        result = dp_p2(torch, np, port, rank, tmp)
    with open(os.path.join(tmp, f"{part}_r{rank}.json"), "w") as f:
        json.dump(result, f)


def dp_spawn(part: str, world: int, tmp: str) -> list[dict]:
    """Run `world` ranks of the parallel phase's `part` as subprocesses
    with a deadline; relay their output; fail unless every rank exits 0.
    Returns each rank's results."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--parallel-worker",
         part, str(r), str(port), tmp], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + DP_RUN_TIMEOUT
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                logs.append(f"(no exit within {DP_RUN_TIMEOUT} s)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, log in enumerate(logs):
        for line in log.splitlines():
            print(f"[{part} rank {r}] {line}", flush=True)
    check(all(p.returncode == 0 for p in procs),
          f"({part}) {world} rank(s) exit 0: "
          f"{[p.returncode for p in procs]}")
    results = []
    for r in range(world):
        with open(os.path.join(tmp, f"{part}_r{r}.json")) as f:
            results.append(json.load(f))
    return results


def parallel(torch, np) -> dict:
    """Phase 12: data parallelism, every rank a subprocess with a deadline,
    the kernels built by this process first. (p1) one rank over NCCL; (p2)
    two ranks on the one card over gloo, which reduces CUDA tensors where
    NCCL refuses two ranks on one card; (p3) MeshDecoder and (p4)
    train_model on the same two ranks. Returns the main path runs' launch
    counts by run."""
    import os
    import shutil
    import tempfile
    from collections import Counter

    print("parallel: (p2)-(p4) run two ranks on the one card, so they "
          "measure correctness and the reduction's cost, not scaling",
          flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        shutil.copytree(REPO / "dataset" / "data", os.path.join(tmp, "data"),
                        ignore=shutil.ignore_patterns("audio_features.csv"))
        (p1,) = dp_spawn("p1", 1, tmp)
        p2 = dp_spawn("p2", 2, tmp)
    # every first-step gap, before the checks stop at one
    for name, got, label in (
            *((label, p2[0]["runs"][label], label) for label in DP_CONFIGS),
            *((f"planted fault, {fault}", p2[0]["planted"][fault], label)
              for fault, label in DP_PLANTED.items())):
        gaps = dp_first_step_gaps(got, p1["refs"][label])
        print(f"(p2) {name}: the first step against one process: loss "
              f"{gaps[0]:.3e}, grad norm {gaps[1]:.3e} relative (losses "
              f"{got['losses'][0]!r} vs {p1['refs'][label]['losses'][0]!r}, "
              f"grad norms {got['norms'][0]!r} vs "
              f"{p1['refs'][label]['norms'][0]!r})", flush=True)
    for label in DP_CONFIGS:
        a, b = (r["runs"][label] for r in p2)
        check(a["losses"] == b["losses"] and a["norms"] == b["norms"]
              and a["checksum"] == b["checksum"],
              f"(p2) {label}: the two ranks' losses, grad norms and "
              f"parameter checksums are bitwise equal")
        ref = p1["refs"][label]
        loss_err = max(abs(x - y) / abs(y)
                       for x, y in zip(a["losses"], ref["losses"]))
        norm_err = max(abs(x - y) / abs(y)
                       for x, y in zip(a["norms"], ref["norms"]))
        check(loss_err <= 1e-3 and norm_err <= 1e-2,
              f"(p2) {label}: dp 2 against one process on the whole batch, "
              f"{DP_STEPS} steps: loss within {loss_err:.3e} relative "
              f"(limit 1e-3), grad norm within {norm_err:.3e} (1e-2); losses "
              f"{a['losses']} vs {ref['losses']}")
        gaps = dp_first_step_gaps(a, ref)
        check(all(g <= lim for g, lim in zip(gaps, DP_FIRST_STEP_LIMITS)),
              f"(p2) {label}: the first step against one process: loss "
              f"within {gaps[0]:.3e} relative, grad norm within "
              f"{gaps[1]:.3e} (limits {DP_FIRST_STEP_LIMITS})")
        print(f"(p2) {label}: {a['rows']} rows a rank, step median "
              f"{a['step_ms']:.3f} / {b['step_ms']:.3f} ms (ranks 0 / 1, "
              f"sharing the card; one process on the whole batch "
              f"{ref['step_ms']:.3f}), peak device memory {a['peak']} / "
              f"{b['peak']} bytes (one process {ref['peak']})", flush=True)
    for fault, label in DP_PLANTED.items():
        gaps = dp_first_step_gaps(p2[0]["planted"][fault], p1["refs"][label])
        check(any(g > lim for g, lim in zip(gaps, DP_FIRST_STEP_LIMITS)),
              f"(p2) planted fault, {fault}: the first-step gate catches it "
              f"(loss {gaps[0]:.3e} relative, grad norm {gaps[1]:.3e}; "
              f"limits {DP_FIRST_STEP_LIMITS})")
    print(f"(p2) the gradient all-reduce over gloo through the host: "
          f"{p2[0]['allreduce_ms']:.3f} ms (rank 1: "
          f"{p2[1]['allreduce_ms']:.3f}) for {p2[0]['allreduce_bytes']} bytes "
          f"of fp32, once a step", flush=True)
    check(p2[0]["decode"]["sums"] == p2[1]["decode"]["sums"],
          "(p3) both ranks hold the same decoded frames")
    t0, t1 = (r["train_model"] for r in p2)
    check(all(t0[k] == t1[k] for k in ("train_losses", "val_losses",
                                        "grad_norms", "steps", "total")),
          f"(p4) the two ranks' histories are equal: {len(t0['train_losses'])}"
          f" train losses, {len(t0['val_losses'])} validation losses, "
          f"{len(t0['grad_norms'])} grad norms")
    for i, (sec, n) in enumerate(zip(t0["epoch_seconds"],
                                     t0["epoch_samples"])):
        print(f"(p4) epoch {i + 1} at dp 2: {sec:.3f} s, {n} samples, "
              f"{n / sec:.1f} samples/s as the loop counts them", flush=True)
    print(f"(p4) peak device memory of the two train_model calls: "
          f"{t0['peak']} / {t1['peak']} bytes (ranks 0 / 1)", flush=True)

    def summed(counts):
        return dict(sum((Counter(c) for c in counts), Counter()))

    paths = {"parallel (p1)": p1["launches"],
             "parallel (p2)": summed(r["launches"] for r in p2),
             "parallel (p3)": summed(r["decode"]["launches"] for r in p2),
             "parallel (p4)": summed(r["train_model"]["launches"] for r in p2)}
    want = {"rope_rotate": 100 * DP_STEPS,
            **{k: n * DP_STEPS for k, n in {**LN_STEP, **LA_STEP,
                                            **FFN_STEP}.items()}}
    check(p1["launches"] == want, f"(p1) kernel launches of {DP_STEPS} "
          f"steps of (a): {p1['launches']} == {want}")
    for path in ("parallel (p2)", "parallel (p3)"):   # 'pallas' runs K4
        check(paths[path].get("fused_rope_attention", 0) > 0,
              f"{path} launched the K4 forward")
    check(paths["parallel (p2)"].get("fused_rope_attention_bwd", 0) > 0,
          "parallel (p2) launched the K4 backward")
    for path, counts in paths.items():
        check(counts.get("rope_rotate", 0) > 0,
              f"{path} launched K1: {counts}")
    return paths


# ---------------------------------------------------------------------------
# phase 13: tensor parallelism


def tp_kernel_checks(torch) -> tuple[dict, dict]:
    """(t1): the kernels at a tp = 2 rank's shapes of the full-width model
    (8 of the 16 heads, h = 64, so q and k are [B, T, 512]; 2048 of the
    4096 FFN columns) against their plain versions, then timed beside their
    bounds: K1 (bitwise) and the K4 forward (fua.fwd_limit) at [17 | 128,
    128, 512], the K4 backward at [128, 128, 512] (its bound), K3 forward
    and backward at [32, 8, 512, 64] (fa.kernel_limit), K2 at [16384, 1024,
    2048] (kernel_limits, on ffn_bwd_wgmma_kernel). Checked at the other
    shapes the phase's main path gives them, untimed: K1 at (t3)'s 32 rows
    and (t4)'s 8 in bf16 and at (t2)'s 17 in fp32, the K4 forward and
    backward at (t3)'s 32, K2 at (t3)'s M = 4096 and (t4)'s 1024. Returns
    ({kernel: {label: timing}}, {kernel: max abs err})."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.ops import ffn_bwd
    from neurosync_trainer_lite_tpu_torch.ops import flash_attention as fa
    from neurosync_trainer_lite_tpu_torch.ops import fused_attention as fua
    from neurosync_trainer_lite_tpu_torch.ops import rope_kernel as rk
    from neurosync_trainer_lite_tpu_torch.ops.rope import rope_tables

    cfg = Config()
    n, hd, T = cfg.num_heads // 2, cfg.hidden_dim // cfg.num_heads, \
        cfg.micro_batch_size
    W = n * hd
    gen = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape):
        return torch.randn(*shape, device="cuda",
                           generator=gen).to(torch.bfloat16)

    timed, err = {}, {}

    def keep(name, label, rec, e):
        timed.setdefault(name, {})[f"tp=2 rank, {label}"] = rec
        err[name] = max(err.get(name, 0.0), e)
        print_timed(name, f"tp=2 rank, {label}", rec)

    tiled = rope_tables(T, hd, "cuda", tile=n)
    tables = fua.make_tables(T, T, hd, n, "cuda")
    for label, B, dtype in (("(t4) a data group's rows", TP_DP_BATCH // 2,
                             torch.bfloat16),
                            ("(t2) fp32 decode", serving_shape()[0],
                             torch.float32)):
        x = torch.randn(B, T, W, device="cuda", generator=gen).to(dtype)
        out = rk.rope_rotate_cuda(x, *tiled)
        torch.cuda.synchronize()
        check(torch.equal(out, rk.rope_rotate_plain(x, *tiled)),
              f"(t1) K1 rope_rotate [{B}, {T}, {W}], {n} heads, {label}, "
              f"{dtype}, bitwise equal to the plain version")
    for label, B in (("serving", serving_shape()[0]),
                     ("(t3) batch", TP_BATCH), ("training", cfg.batch_size)):
        x = randn(B, T, W)
        out = rk.rope_rotate_cuda(x, *tiled)
        torch.cuda.synchronize()
        ref = rk.rope_rotate_plain(x, *tiled)
        check(torch.equal(out, ref), f"(t1) K1 rope_rotate [{B}, {T}, {W}], "
              f"{n} heads, bf16, bitwise equal to the plain version")
        if label != "(t3) batch":
            keep("rope_rotate", label, k1_timed(torch, x, tiled), 0.0)
        q, k, v, do = (randn(B, T, W) for _ in range(4))
        e = k4_forward_check(torch, fua, q, k, v, tables, n)
        if label != "(t3) batch":
            keep("fused_rope_attention", label,
                 k4_fwd_timed(torch, q, k, v, tables, n), e)
        if label == "serving":
            continue
        got = fua.fused_rope_attention_bwd_cuda(q, k, v, do, tables, n,
                                                hd ** -0.5)
        torch.cuda.synchronize()
        want = fua.fused_rope_attention_bwd_plain(q, k, v, do, tables, n,
                                                  hd ** -0.5)
        e = 0.0
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            diff = (a.float() - b.float()).abs()
            limit = 2.0 ** -7 * b.float().abs() + 1e-4 * b.float().abs().max()
            e = max(e, diff.max().item())
            check(bool((diff <= limit).all()),
                  f"(t1) K4 backward {name} [{B}, {T}, {W}], {n} heads, bf16 "
                  f"within 2^-7·|plain| + 1e-4·max|plain| (max abs err "
                  f"{diff.max().item():.3e})")
        if label == "training":
            keep("fused_rope_attention_bwd", label,
                 k4_bwd_timed(torch, q, k, v, do, tables, n), e)
        del x, q, k, v, do, got, want

    B, N, Tk, h = 32, n, 512, hd
    q, k, v, do = (randn(B, N, Tk, h) for _ in range(4))
    got = {"out": fa.flash_attention_cuda(q, k, v, h ** -0.5)}
    got.update(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_cuda(
        q, k, v, do, h ** -0.5)))
    torch.cuda.synchronize()
    want = {"out": fa.flash_attention_plain(q, k, v, h ** -0.5)}
    want.update(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_plain(
        q, k, v, do, h ** -0.5)))
    e = {}
    for name, ref in want.items():
        diff = (got[name].float() - ref.float()).abs()
        kernel = "flash_attention" if name == "out" else "flash_attention_bwd"
        e[kernel] = max(e.get(kernel, 0.0), diff.max().item())
        check(bool((diff <= fa.kernel_limit(ref, torch.bfloat16)).all()),
              f"(t1) K3 {name} [{B}, {N}, {Tk}, {h}] bf16 within the limit "
              f"of the plain version (max abs err {diff.max().item():.3e})")
    fwd, bwd = k3_timed(torch, q, k, v, do, "tp=2 rank, window 512")
    for kernel, rec in (("flash_attention", fwd), ("flash_attention_bwd",
                                                    bwd)):
        timed.setdefault(kernel, {})["tp=2 rank, window 512"] = rec
        err[kernel] = e[kernel]
    del q, k, v, do, got, want

    hh, f = cfg.hidden_dim, cfg.ffn_dim // 2
    w = (torch.randn(hh, f, device="cuda", generator=gen) * 0.02).to(
        torch.bfloat16)
    for label, rows in (("training", cfg.batch_size),
                        ("(t3) batch", TP_BATCH),
                        ("(t4) a data group's rows", TP_DP_BATCH // 2)):
        m = rows * T
        dy = randn(m, hh)
        am = torch.relu(torch.randn(m, f, device="cuda", generator=gen)
                        - 0.3).to(torch.bfloat16)
        out = ffn_bwd.ffn_bwd_dh1_cuda(dy, w, am, scale=256 / 179)
        torch.cuda.synchronize()
        ref = ffn_bwd.ffn_bwd_dh1_plain(dy, w, am, scale=256 / 179)
        e = 0.0
        for name, a, b, limit in zip(("dh1", "db2", "db1"), out, ref,
                                     ffn_bwd.kernel_limits(ref)):
            diff = (a.float() - b.float()).abs()
            e = max(e, diff.max().item())
            check(bool((diff <= limit).all()),
                  f"(t1) K2 {name} [{m}, {hh}, {f}] within the limit of the "
                  f"plain version (max abs err {diff.max().item():.3e})")
        err["ffn_bwd_dh1"] = max(err.get("ffn_bwd_dh1", 0.0), e)
        names = profile_names(torch, lambda: ffn_bwd.ffn_bwd_dh1_cuda(
            dy, w, am, scale=256 / 179), "ffn_bwd")
        check(names and all("ffn_bwd_wgmma_kernel" in x for x in names),
              f"(t1) K2 at [{m}, {hh}, {f}] runs ffn_bwd_wgmma_kernel: "
              f"{names}")
        if label == "training":
            keep("ffn_bwd_dh1", label, k2_timed(torch, dy, w, am), e)
        del dy, am, out, ref
    del w
    torch.cuda.empty_cache()
    return timed, err


def profile_names(torch, fn, prefix: str) -> list[str]:
    """The profiler's names of the kernels fn launches that contain
    prefix (two traced calls after an untraced one; CPU and CUDA traced,
    as profile_once traces them)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and prefix in e.key})


def tp_checksums(torch, model) -> dict:
    """The parameters' checksums (params_checksum's): the replicated leaves'
    and all of them."""
    from neurosync_trainer_lite_tpu_torch.parallel.mesh import param_spec

    total = rep = 0
    for key, p in model.named_parameters():
        c = int(p.detach().view(torch.int32).to(torch.int64).sum())
        total += c
        if param_spec(key) is None:
            rep += c
    return {"replicated": rep, "all": total}


def tp_timed_step(torch, mesh):
    """`after` for dp_run: one more step with every 'model' all-reduce
    timed (the card synchronised around each): the step's wall ms, the
    all-reduces' ms and their count; then the checksums."""
    import torch.distributed as dist

    def after(state, step, s, t, gen):
        plain = dist.all_reduce
        spent = []

        def timed_reduce(tensor, *args, group=None, **kw):
            if group is not mesh.model_group:
                return plain(tensor, *args, group=group, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = plain(tensor, *args, group=group, **kw)
            torch.cuda.synchronize()
            spent.append((time.perf_counter() - t0) * 1e3)
            return out

        dist.all_reduce = timed_reduce
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, loss, _ = step(state, s, t, gen)
            float(loss)
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            dist.all_reduce = plain
        return {"timed_step_ms": wall, "reduce_ms": sum(spent),
                "reduces": len(spent), **tp_checksums(torch, state.model)}

    return after


def tp_run(torch, cfg, weights, src, trg, mesh, *, fused: bool, steps,
           timed: bool = False) -> dict:
    """dp_run of cfg (seq2seq._ffn through K2 where fused) with the kernel
    launches and 'model' all-reduces of its steps counted from zero; with
    timed, tp_timed_step after them (not counted)."""
    from neurosync_trainer_lite_tpu_torch.models import layers, seq2seq
    from neurosync_trainer_lite_tpu_torch.ops import kernels
    from neurosync_trainer_lite_tpu_torch.parallel import tensor

    default = seq2seq._ffn
    if fused:
        seq2seq._ffn = layers.ffn_fused
    counted = {}

    def after(state, step, s, t, gen):
        counted.update(launches=dict(kernels.LAUNCHES),
                       collectives=dict(tensor.COLLECTIVES))
        return (tp_timed_step(torch, mesh)(state, step, s, t, gen)
                if timed else tp_checksums(torch, state.model))

    kernels.reset_launches()
    tensor.reset_collectives()
    try:
        out = dp_run(torch, cfg, weights, src, trg, mesh, steps=steps,
                     after=after)
    finally:
        seq2seq._ffn = default
    return {**out, **counted}


def tp_refs(torch) -> dict:
    """One process, no group: (t3)'s configurations at batch TP_BATCH and
    (t4)'s at TP_DP_BATCH, from the seeded weights and rows every rank
    draws (dp_weights)."""
    from neurosync_trainer_lite_tpu_torch.config import Config

    refs = {}
    for batch, steps in ((TP_BATCH, TP_STEPS), (TP_DP_BATCH, 1)):
        base = Config(batch_size=batch)
        weights, src, trg = dp_weights(torch, base)
        for label, (kw, fused) in TP_CONFIGS.items():
            if batch == TP_DP_BATCH and label != TP_DP_CONFIG:
                continue
            refs[f"{label}, batch {batch}"] = tp_run(
                torch, base.replace(**kw), weights, src, trg, None,
                fused=fused, steps=steps)
        del weights, src, trg
        torch.cuda.empty_cache()
    return refs


def tp_planted(torch, base, weights, src, trg, mesh) -> dict:
    """One step of (t3)'s dropout-0.3 run with each fault planted that the
    first-step gate must catch: every column-parallel backward (the
    linears' and the FFN core's) without its all-reduce over 'model'
    (each rank keeps its own partial dx), and every mask drawn at the rank's local width instead of its
    block of the global width's draw."""
    from neurosync_trainer_lite_tpu_torch.models import layers
    from neurosync_trainer_lite_tpu_torch.ops import attention as attn
    from neurosync_trainer_lite_tpu_torch.parallel import tensor
    from neurosync_trainer_lite_tpu_torch.training import step as step_mod

    kw, fused = TP_CONFIGS[TP_PLANTED_CONFIG]
    cfg = base.replace(**kw)
    out = {}
    sound = tensor.reduce_model_
    callers = (attn, layers)   # _linear and the FFN core

    def no_backward_reduce(t, mesh, kind):
        return t if kind == "backward" else sound(t, mesh, kind)

    for module in callers:
        module.reduce_model_ = no_backward_reduce
    try:
        out["column backward without its all-reduce"] = tp_run(
            torch, cfg, weights, src, trg, mesh, fused=fused, steps=1)
    finally:
        for module in callers:
            module.reduce_model_ = sound
    plain_rows = step_mod.dropout_rows
    step_mod.dropout_rows = lambda n, i, nw, j: attn.dropout_rows(n, i)
    try:
        out["masks at the local width"] = tp_run(
            torch, cfg, weights, src, trg, mesh, fused=fused, steps=1)
    finally:
        step_mod.dropout_rows = plain_rows
    return out


def tp_train_model(torch, np, tmp: str, rank: int, mesh) -> dict:
    """(t5) on a rank of two: train_model at tp 2 on the copy of
    dataset/data in tmp, batch TP_BATCH, TP_LOOP_STEPS steps, one epoch
    with a checkpoint, validating on dataset/test_set; then the final
    parameters gathered to rank 0 (collective)."""
    import os

    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.ops import kernels
    from neurosync_trainer_lite_tpu_torch.parallel import distributed
    from neurosync_trainer_lite_tpu_torch.training.loop import train_model

    test_set = REPO / "dataset" / "test_set"
    out = os.path.join(tmp, "t5")
    cfg = Config(root_dir=os.path.join(tmp, "data"), n_epochs=1, tp=2,
                 batch_size=TP_BATCH, max_steps_per_epoch=TP_LOOP_STEPS,
                 audio_path=str(test_set / "audio.wav"),
                 ground_truth_path=str(test_set / "testset.csv"),
                 model_path=os.path.join(out, "model.pth"),
                 checkpoint_path=os.path.join(out, "checkpoints",
                                              "checkpoint"),
                 plots_dir=os.path.join(out, "plots"))
    history = {}
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    state, steps = train_model(cfg, device="cuda", history_out=history)
    launches = dict(kernels.LAUNCHES)
    full = distributed.gather_state_dict(state.model, mesh)
    losses = history["train_losses"]
    check(steps == len(losses) == TP_LOOP_STEPS
          and all(math.isfinite(x) for x in losses + history["val_losses"]
                  + history["grad_norms"]),
          f"(t5) rank {rank}: train_model at tp 2, {steps} steps, every loss "
          f"and grad norm finite")
    result = {"launches": launches, "steps": steps,
              "peak": torch.cuda.max_memory_allocated(),
              **{k: history[k] for k in ("train_losses", "val_losses",
                                          "grad_norms", "epoch_seconds",
                                          "epoch_samples")}}
    if full is not None:
        exported = torch.load(cfg.model_path, weights_only=True)
        check(list(exported) == list(full["model"]) and all(
                  torch.equal(exported[k], v)
                  for k, v in full["model"].items()),
              f"(t5) rank 0's model.pth holds the parameters gathered over "
              f"'model', bit for bit ({len(exported)} leaves)")
    del state
    torch.cuda.empty_cache()
    return {**result, "cfg": cfg.to_dict()}


def tp_resume_at_tp1(torch, np, cfg_dict: dict) -> dict:
    """(t5), rank 0 alone after the group is gone: model.pth served on
    test_set/audio.wav, then train_model resumed at tp 1 from the tp = 2
    checkpoint for a second epoch."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.inference.api import (
        generate_facial_data_from_bytes)
    from neurosync_trainer_lite_tpu_torch.training.loop import train_model
    from neurosync_trainer_lite_tpu_torch.utils.weights import load_model

    cfg = Config.from_dict(cfg_dict)
    model = load_model(cfg.model_path, Config(), device="cuda")
    frames = generate_facial_data_from_bytes(
        (REPO / "dataset" / "test_set" / "audio.wav").read_bytes(), model,
        Config())
    check(isinstance(frames, np.ndarray) and frames.ndim == 2
          and frames.shape[1] == 61 and bool(np.isfinite(frames).all()),
          f"(t5) the tp = 2 run's model.pth serves test_set/audio.wav: "
          f"{frames.shape} finite frames")
    del model
    history = {}
    _, total = train_model(cfg.replace(tp=1, mode="resume", n_epochs=2),
                           device="cuda", history_out=history)
    losses = history["train_losses"]
    check(total == 2 * TP_LOOP_STEPS and len(losses) == TP_LOOP_STEPS
          and all(math.isfinite(x) for x in losses),
          f"(t5) resumed at tp 1 from the tp = 2 checkpoint: batch_step "
          f"continues to {total}, losses {losses}")
    return {"resumed_losses": losses, "total": total}


def tp_worker(torch, np, part: str, rank: int, port: int, tmp: str) -> dict:
    """One process of the tensor phase: (t1) alone, or a rank of (t2),
    (t3) and (t5) on a (1, 2) mesh or of (t4) on a (2, 2) one, over gloo
    on the one card."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.parallel import (
        distributed, make_mesh)

    if part == "t1":
        timed, err = tp_kernel_checks(torch)
        return {"timed": timed, "err": err}
    world = 2 if part == "t235" else 4
    distributed.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       backend="gloo",
                                       timeout_s=DP_GROUP_TIMEOUT)
    out = {}
    try:
        batch = TP_BATCH if part == "t235" else TP_DP_BATCH
        base = Config(batch_size=batch, tp=2)
        mesh = make_mesh(base)
        weights, src, trg = dp_weights(torch, base.replace(tp=1))
        if part == "t4":
            kw, fused = TP_CONFIGS[TP_DP_CONFIG]
            out["runs"] = {TP_DP_CONFIG: tp_run(
                torch, base.replace(**kw), weights, src, trg, mesh,
                fused=fused, steps=1)}
            return out
        out["runs"] = {label: tp_run(torch, base.replace(**kw), weights, src,
                                     trg, mesh, fused=fused, steps=TP_STEPS,
                                     timed=True)
                       for label, (kw, fused) in TP_CONFIGS.items()}
        out["planted"] = tp_planted(torch, base, weights, src, trg, mesh)
        del weights, src, trg
        torch.cuda.empty_cache()
        out["decode"] = dp_decode(torch, np, mesh, "(t2)",
                                  TP_DECODE_FP32_LIMIT)
        out["train_model"] = tp_train_model(torch, np, tmp, rank, mesh)
    finally:
        distributed.destroy()
    if rank == 0:
        out["train_model"].update(tp_resume_at_tp1(
            torch, np, out["train_model"]["cfg"]))
    return out


def tensor(torch, np) -> tuple[dict, dict, dict]:
    """Phase 13: tensor parallelism, every process a subprocess with a
    deadline (--parallel-worker): (t1) the kernels at a tp = 2 rank's
    shapes, in a process of its own (a fresh profiler: late in this
    process's run the profiler no longer saw the kernels, so K2's symbol
    check could not pass); then ranks over gloo on the one card: (t2)
    MeshDecoder, (t3) the step and (t5) train_model on a (1, 2) mesh, (t4)
    a (2, 2) step; the one-process references in this process. Returns
    (the main path runs' launch counts by run, (t1)'s timings, (t1)'s
    errors)."""
    import os
    import shutil
    import tempfile
    from collections import Counter

    print("tensor: the ranks share the one card and reduce through the host "
          "under gloo, so (t2)-(t5) measure correctness and the reduction's "
          "cost, not scaling", flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        (kernel_run,) = dp_spawn("t1", 1, tmp)
        refs = tp_refs(torch)
        shutil.copytree(REPO / "dataset" / "data", os.path.join(tmp, "data"),
                        ignore=shutil.ignore_patterns("audio_features.csv"))
        t235 = dp_spawn("t235", 2, tmp)
        t4 = dp_spawn("t4", 4, tmp)

    ranks = {"(t3)": (t235, TP_BATCH), "(t4)": (t4, TP_DP_BATCH)}
    # every first-step gap, before the checks stop at one
    gaps = {}
    for tag, (per_rank, batch) in ranks.items():
        for label, got in per_rank[0]["runs"].items():
            gaps[tag, label] = dp_first_step_gaps(
                got, refs[f"{label}, batch {batch}"])
    for fault, got in t235[0]["planted"].items():
        gaps["(t3) planted fault", fault] = dp_first_step_gaps(
            got, refs[f"{TP_PLANTED_CONFIG}, batch {TP_BATCH}"])
    for (tag, label), (gl, gn) in gaps.items():
        print(f"{tag} {label}: the first step against one process: loss "
              f"{gl:.3e}, grad norm {gn:.3e} relative", flush=True)

    expected_per_step = {label: TP_LAUNCHES[label] for label in TP_CONFIGS}
    for tag, (per_rank, batch) in ranks.items():
        for label in per_rank[0]["runs"]:
            runs = [r["runs"][label] for r in per_rank]
            ref = refs[f"{label}, batch {batch}"]
            steps = len(runs[0]["losses"])
            check(all(r["losses"] == runs[0]["losses"]
                      and r["norms"] == runs[0]["norms"]
                      and r["replicated"] == runs[0]["replicated"]
                      for r in runs),
                  f"{tag} {label}: every rank's losses, grad norms and "
                  f"replicated leaves bitwise equal after {steps} step(s)")
            for r, run in enumerate(runs):
                want = {k: steps * v for k, v in
                        expected_per_step[label].items()}
                check(run["launches"] == want,
                      f"{tag} {label}, rank {r}: kernel launches of {steps} "
                      f"step(s) {run['launches']} == {want}")
                want = {k: steps * v for k, v in TP_COLLECTIVES.items()}
                check(run["collectives"] == want,
                      f"{tag} {label}, rank {r}: 'model' all-reduces of "
                      f"{steps} step(s) {run['collectives']} == {want}")
            gl, gn = gaps[tag, label]
            check(gl <= TP_FIRST_STEP_LIMITS[0]
                  and gn <= TP_FIRST_STEP_LIMITS[1],
                  f"{tag} {label}: the first step against one process on "
                  f"the same weights and rows: loss within {gl:.3e}, grad "
                  f"norm within {gn:.3e} relative (limits "
                  f"{TP_FIRST_STEP_LIMITS}; losses {runs[0]['losses']} vs "
                  f"{ref['losses']})")
            if tag == "(t3)":
                a, b = runs
                print(f"(t3) {label}: {a['rows']} rows on each rank, step "
                      f"median {a['step_ms']:.3f} / {b['step_ms']:.3f} ms "
                      f"(ranks 0 / 1, sharing the card; one process "
                      f"{ref['step_ms']:.3f}); a timed step "
                      f"{a['timed_step_ms']:.3f} ms of which the {a['reduces']} "
                      f"'model' all-reduces over gloo {a['reduce_ms']:.3f} ms "
                      f"({100 * a['reduce_ms'] / a['timed_step_ms']:.1f}%); "
                      f"peak device memory {a['peak']} / {b['peak']} bytes "
                      f"(one process {ref['peak']})", flush=True)
    for fault in t235[0]["planted"]:
        gl, gn = gaps["(t3) planted fault", fault]
        check(gl > TP_FIRST_STEP_LIMITS[0] or gn > TP_FIRST_STEP_LIMITS[1],
              f"(t3) planted fault, {fault}: the first-step gate catches it "
              f"(loss {gl:.3e}, grad norm {gn:.3e} relative; limits "
              f"{TP_FIRST_STEP_LIMITS})")
    shards = [r["runs"][TP_DP_CONFIG]["all"] for r in t4]
    check(all(shards[r] == shards[r % 2] for r in range(4)),
          "(t4) the two ranks of each model index hold the same shard, "
          "bitwise")
    check(t235[0]["decode"]["sums"] == t235[1]["decode"]["sums"],
          "(t2) both ranks hold the same decoded frames")
    t0, t1 = (r["train_model"] for r in t235)
    check(all(t0[k] == t1[k] for k in ("train_losses", "val_losses",
                                        "grad_norms", "steps")),
          f"(t5) the two ranks' histories are equal: "
          f"{len(t0['train_losses'])} train losses, "
          f"{len(t0['val_losses'])} validation losses")
    for sec, n in zip(t0["epoch_seconds"], t0["epoch_samples"]):
        print(f"(t5) the epoch at tp 2: {sec:.3f} s, {n} samples, "
              f"{n / sec:.1f} samples/s as the loop counts them; peak device "
              f"memory {t0['peak']} / {t1['peak']} bytes (ranks 0 / 1)",
              flush=True)

    def summed(counts):
        return dict(sum((Counter(c) for c in counts), Counter()))

    paths = {"tensor (t2)": summed(r["decode"]["launches"] for r in t235),
             "tensor (t3)": summed(run["launches"] for r in t235
                                   for run in r["runs"].values()),
             "tensor (t4)": summed(run["launches"] for r in t4
                                   for run in r["runs"].values()),
             "tensor (t5)": summed(r["train_model"]["launches"]
                                   for r in t235)}
    for path, counts in paths.items():
        check(counts.get("rope_rotate", 0) > 0,
              f"{path} launched K1: {counts}")
    return paths, kernel_run["timed"], kernel_run["err"]



def epoch_stats_readable(stats_dir: str, n_epochs: int) -> None:
    """(c5) utils/epoch_stats.py on the stats files train_model wrote: every
    epoch found, 61 dimensions with every metric, NaN-free MAE; the plot
    raises ImportError where matplotlib is missing (the card's machine) and
    is written where it is installed."""
    import importlib.util
    import os

    from neurosync_trainer_lite_tpu_torch.utils.epoch_stats import (
        DIMENSION_METRICS, load_stats_history, plot_overall_stats)

    epochs, overall, per_dim = load_stats_history(stats_dir)
    mae = overall.get("Mean Absolute Error (MAE)", [])
    check(epochs == list(range(1, n_epochs + 1)) and len(per_dim) == 61
          and all(set(stats) == set(DIMENSION_METRICS)
                  and all(len(v) == n_epochs for v in stats.values())
                  for stats in per_dim.values())
          and len(mae) == n_epochs and all(math.isfinite(x) for x in mae),
          f"(c5) load_stats_history finds epochs {epochs} with {len(per_dim)} "
          f"dimensions of {len(DIMENSION_METRICS)} metrics each; MAE by "
          f"epoch {[round(x, 4) for x in mae]}")
    have_matplotlib = importlib.util.find_spec("matplotlib") is not None
    try:
        written, raised = plot_overall_stats(stats_dir), None
    except ImportError as e:
        written, raised = None, e
    check((written is not None and os.path.exists(written))
          if have_matplotlib else raised is not None,
          f"(c5) plot_overall_stats with matplotlib "
          f"{'installed: wrote ' + str(written) if have_matplotlib else 'missing: raised ImportError (' + str(raised) + ')'}")


def compat_step_timer(torch, compat, step_a) -> None:
    """(c3) COMPAT_TIMER_STEPS steps of step (a)'s configuration written as
    the reference's loop writes them, from compat.prepare_training_components'
    criterion and optimizer, under StepTimer(sync_every=COMPAT_SYNC_EVERY).
    Their losses must equal the port's make_train_step from the same
    weights, batch and dropout seeds; the timer's mean must lie within
    COMPAT_TIMER_LIMIT of phase 8's step (a) median (or, run alone, of the
    port's steps timed here); the scheduler's LR must be lr_factor's."""
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import (
        Seq2Seq, init_seq2seq)
    from neurosync_trainer_lite_tpu_torch.training.optim import (
        clip_by_global_norm_, global_norm, lr_factor)
    from neurosync_trainer_lite_tpu_torch.training.step import (
        init_train_state, make_train_step)
    from neurosync_trainer_lite_tpu_torch.utils.profiling import StepTimer

    cfg = Config()
    gen = torch.Generator(device="cuda").manual_seed(3)
    weights = init_seq2seq(cfg, gen, device="cuda").state_dict()
    src, trg = train_batch(torch, cfg, gen)

    state = init_train_state(cfg, 1000, device="cuda", state_dict=weights)
    step = make_train_step(cfg)
    seeds = torch.Generator().manual_seed(4)
    ref_losses, ref_times = [], []
    for _ in range(COMPAT_REF_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_losses.append(float(step(state, src, trg, seeds)[1]))
        ref_times.append(time.perf_counter() - t0)
    del state, step
    torch.cuda.empty_cache()

    model = Seq2Seq(cfg, "cuda")
    model.load_state_dict(weights)
    model.train()
    del weights
    criterion, optimizer, scheduler = compat.prepare_training_components(
        compat.training_config, model)
    seeds = torch.Generator().manual_seed(4)
    timer = StepTimer(sync_every=COMPAT_SYNC_EVERY)
    losses = []
    gc.collect()   # no earlier phase's garbage collected in the timed steps
    torch.cuda.synchronize()
    for _ in range(COMPAT_TIMER_STEPS):
        optimizer.zero_grad(set_to_none=True)
        loss = criterion(model(src, seeds), trg)
        loss.backward()
        grads = [p.grad for p in model.parameters()]
        clip_by_global_norm_(grads, global_norm(grads), cfg.grad_clip)
        optimizer.step()
        timer.step(loss)
        losses.append(loss.detach())
    summary = timer.summary()
    losses = [float(x) for x in losses]
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    check(gap <= 1e-6, f"(c3) the compat criterion and optimizer's first "
          f"{COMPAT_REF_STEPS} losses equal make_train_step's from the same "
          f"weights, batch and seeds: largest relative gap {gap:.3e} "
          f"({'bitwise' if losses[:COMPAT_REF_STEPS] == ref_losses else 'not bitwise'})")
    own_ms = statistics.median(ref_times[1:]) * 1e3
    ref_ms, ref_what = ((step_a["median_ms"], "phase 8's step (a) median")
                        if step_a else (own_ms, "the port's steps here"))
    phase8 = (f"phase 8's step (a) median {step_a['median_ms']:.3f} ms; "
              if step_a else "")
    print(f"(c3) StepTimer(sync_every={COMPAT_SYNC_EVERY}) over "
          f"{COMPAT_TIMER_STEPS} steps: {json.dumps(summary)}; {phase8}"
          f"make_train_step here {own_ms:.3f} ms (median of "
          f"{COMPAT_REF_STEPS - 1} synchronised steps)", flush=True)
    check(summary["steps"] == COMPAT_TIMER_STEPS - 1
          and abs(summary["mean_ms"] - ref_ms) <= COMPAT_TIMER_LIMIT * ref_ms,
          f"(c3) StepTimer records {summary['steps']} steps, mean "
          f"{summary['mean_ms']:.3f} ms within {COMPAT_TIMER_LIMIT:.0%} of "
          f"{ref_what}, {ref_ms:.3f} ms")
    lrs = []
    for c in range(4):
        lrs.append((optimizer.param_groups[0]["lr"],
                    cfg.learning_rate * lr_factor(c, cfg)))
        scheduler.step()
    check(all(a == b for a, b in lrs),
          f"(c3) the compat scheduler's LR after 0-3 steps equals "
          f"learning_rate * lr_factor: {lrs}")


def compat_profile_worker(torch, tmp: str) -> dict:
    """(c4), in a process of its own (late in the whole script's process the
    profiler saw no kernels): two steps of step (a) under
    utils/profiling.py:profile_trace after one untraced step; returns the
    trace file's size and the kernel events naming K1's rope_rows."""
    import os

    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq
    from neurosync_trainer_lite_tpu_torch.training.step import (
        init_train_state, make_train_step)
    from neurosync_trainer_lite_tpu_torch.utils.profiling import (
        TRACE_FILE, profile_trace)

    cfg = Config()
    gen = torch.Generator(device="cuda").manual_seed(3)
    state = init_train_state(cfg, 1000, generator=gen, device="cuda")
    src, trg = train_batch(torch, cfg, gen)
    step = make_train_step(cfg)
    seeds = torch.Generator().manual_seed(4)
    float(step(state, src, trg, seeds)[1])
    trace_dir = os.path.join(tmp, "c4_trace")
    with profile_trace(trace_dir):
        for _ in range(2):
            step(state, src, trg, seeds)
        torch.cuda.synchronize()
    path = os.path.join(trace_dir, TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "rope_rows" in e.get("name", "")]
    return {"bytes": os.path.getsize(path), "kernel_events": len(kernels),
            "k1_events": len(k1),
            "k1_names": sorted({e["name"] for e in k1})}


def compat_surface(torch, np, step_a=None) -> dict:
    """Phase 14: the reference-name surface at full width (Config()).
    (c1) compat.build_model, count_parameters, save_final_model and
    load_model; (c2) the 30 s request through compat's reference call shape
    at 'auto' and 'pallas' (the main path run: launches counted from zero)
    against inference/api.py, generate_facial_data_from_bytes_device and
    the host path through compat.extract_audio_features and
    compat.process_audio_features, all bitwise; (c3) StepTimer over the
    compat training components; (c4) profile_trace in a subprocess.
    ((c5) runs inside phase 11, on the stats train_model writes.) Returns
    the main path run's launch counts."""
    import os
    import tempfile

    from neurosync_trainer_lite_tpu_torch import compat
    from neurosync_trainer_lite_tpu_torch.config import Config
    from neurosync_trainer_lite_tpu_torch.inference.api import (
        generate_facial_data_from_bytes)
    from neurosync_trainer_lite_tpu_torch.inference.device_pipeline import (
        generate_facial_data_from_bytes_device)
    from neurosync_trainer_lite_tpu_torch.models import count_parameters
    from neurosync_trainer_lite_tpu_torch.ops import kernels

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg_dict = compat.training_config
    t0 = time.perf_counter()
    built = compat.build_model(cfg_dict)
    torch.cuda.synchronize()
    n = count_parameters(built)
    check(next(built.parameters()).is_cuda and n == FULL_WIDTH_PARAMETERS,
          f"(c1) compat.build_model(training_config) on the card in "
          f"{time.perf_counter() - t0:.3f} s: count_parameters {n} == "
          f"{FULL_WIDTH_PARAMETERS}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_compat_") as tmp:
        path = os.path.join(tmp, "model.pth")
        compat.save_final_model(built, cfg_dict, path)
        models = {impl: compat.load_model(
            path, {**cfg_dict, "attention_impl": impl}, device="cuda")
            for impl in ("auto", "pallas")}
    want, got = built.state_dict(), models["auto"].state_dict()
    check(want.keys() == got.keys()
          and all(torch.equal(v, got[k]) for k, v in want.items()),
          f"(c1) save_final_model, then load_model(path, training_config, "
          f"device='cuda'): all {len(want)} leaves bitwise equal")
    del built, want, got

    cfg = Config.from_dict(cfg_dict)
    wav = seeded_wav(np, cfg.sr)
    expected = {"auto": {"rope_rotate": 50, **LN_FORWARD},
                "pallas": {"rope_rotate": 2, "fused_rope_attention": 24,
                           **LN_FORWARD}}
    for model in models.values():      # warm-up
        compat.generate_facial_data_from_bytes(wav, model, device=None)
    torch.cuda.synchronize()
    kernels.reset_launches()
    served, launches = {}, {}
    for impl, model in models.items():
        before = dict(kernels.LAUNCHES)
        served[impl] = compat.generate_facial_data_from_bytes(wav, model,
                                                              device=None)
        launches[impl] = {name: count - before.get(name, 0)
                          for name, count in kernels.LAUNCHES.items()
                          if count - before.get(name, 0)}
    main_path = dict(kernels.LAUNCHES)
    for impl, model in models.items():
        out = served[impl]
        check(launches[impl] == expected[impl],
              f"(c2) kernel launches of the compat request at '{impl}': "
              f"{launches[impl]} == {expected[impl]}")
        direct = generate_facial_data_from_bytes(wav, model, cfg)
        entry = generate_facial_data_from_bytes_device(wav, model, cfg)
        check(isinstance(out, np.ndarray) and out.ndim == 2
              and out.shape[1] == 61 and bool(np.isfinite(out).all())
              and np.array_equal(out, direct)
              and np.array_equal(entry, direct),
              f"(c2) '{impl}': compat.generate_facial_data_from_bytes(wav, "
              f"model, device=None) {out.shape} and "
              f"generate_facial_data_from_bytes_device bitwise equal to "
              f"inference/api.py's")
        feats, _ = compat.extract_audio_features(wav, cfg.sr,
                                                 from_bytes=True)
        host = compat.process_audio_features(feats, model, device=None)
        direct = generate_facial_data_from_bytes(wav, model, cfg,
                                                 pipeline="host")
        check(np.array_equal(host, direct),
              f"(c2) '{impl}': compat.process_audio_features on "
              f"compat.extract_audio_features' {feats.shape} features "
              f"bitwise equal to pipeline='host'")
    del models
    torch.cuda.empty_cache()

    compat_step_timer(torch, compat, step_a)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_c4_") as tmp:
        (traced,) = dp_spawn("c4", 1, tmp)
    check(traced["k1_events"] > 0,
          f"(c4) profile_trace of 2 steps of (a) in a process of its own: "
          f"trace.json of {traced['bytes']} bytes, {traced['kernel_events']} "
          f"kernel events, {traced['k1_events']} of K1 "
          f"({', '.join(traced['k1_names'])})")
    print(f"phase 14 (compat): {time.perf_counter() - t_phase:.3f} s",
          flush=True)
    return {"compat": main_path}


def run_tool(module: str, *args: str) -> tuple[str, str]:
    """python3 -m <module> <args> from the repo root in a process of its
    own, stopped after TOOL_TIMEOUT s; it must exit 0. Returns (stdout,
    stderr)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          capture_output=True, text=True,
                          timeout=TOOL_TIMEOUT)
    tail = "\n".join(proc.stdout.strip().splitlines()[-3:])
    check(proc.returncode == 0,
          f"(15) python3 -m {module} {' '.join(args)}: exit "
          f"{proc.returncode} in {time.perf_counter() - t0:.3f} s\n{tail}"
          + ("" if proc.returncode == 0 else "\n" + proc.stderr[-3000:]))
    return proc.stdout, proc.stderr


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def tools(torch, np, step_a=None, request_fps=None) -> dict:
    """Phase 15: the port's runnable scripts on the card
    (neurosync_trainer_lite_tpu_torch/bench.py and tools/), at full width.
    (b1) The four bench modes in this process, each run counted from zero
    (the main path runs): train, 2 configurations x (3 + 20) steps, K1 100
    a step; infer, a warm and a timed 30 s request, K1 50 each; stream, K1
    50 a decode forward; frontend, no kernel. The headline within
    TOOLS_AGREEMENT of phase 8's step (a) median when phase 8 ran. (b2)
    python3 -m neurosync_trainer_lite_tpu_torch.bench, default and --mode
    infer, their last stdout line and the dropout-0 line on stderr. (b3)
    serving_soak, 4 sessions, max 8, 120 ticks, churn 30: no SLOW tick, no
    watchdog flip, frames from every closed session. (b4) serving_knee at K
    = 8, 5 reps, --fused 0 and 1. (b5) warmup_probe, 8 sessions, 40 soak
    ticks. (b6) local_dispatch_probe, 8 sessions, 60 ticks, --device cpu.
    (b7) step_probe at (a), (b) (K4), (e) (K2) and (c) (K3), each in its
    own process: its launches a step (its stderr line) equal
    STEP_PROBE_LAUNCHES, and its step within TOOLS_AGREEMENT of phase 8's
    median of the same configuration when phase 8 ran. (b8) data_scale_probe --generate at 2
    voices x 2 min (under out/, removed after), --measure, then
    train_scale_run --steps 20 --epochs 1 over it. Returns the launch
    counts of (b1)'s runs."""
    import ast
    import os
    import shutil
    import tempfile

    from neurosync_trainer_lite_tpu_torch import bench
    from neurosync_trainer_lite_tpu_torch.ops import kernels

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    medians = (step_a or {}).get("medians_ms", {})
    request_fps = request_fps or {}

    def counted(mode):
        gc.collect()   # no earlier phase's garbage collected in its timing
        torch.cuda.synchronize()
        kernels.reset_launches()
        records = bench.MODES[mode](None, "cuda")
        torch.cuda.synchronize()
        return records, dict(kernels.LAUNCHES)

    paths = {}
    steps = 2 * (bench.TRAIN_WARMUP + bench.TRAIN_TIMED)
    (d0, head), paths["bench train"] = counted("train")
    check(paths["bench train"] == {"rope_rotate": 100 * steps,
                                   **{k: n * steps for k, n in
                                      {**LN_STEP, **LA_STEP,
                                       **FFN_STEP}.items()}},
          f"(b1) bench train: {steps} steps of (a)'s geometry at dropout 0 "
          f"and 0.3 launched {paths['bench train']} == K1 100, the "
          f"LayerNorm 42 + 42, the lean attention 24 + 24 and the FFN "
          f"epilogue 16 + 16 a step")
    check(d0["metric"] == "228M_train_samples_per_sec_per_chip_dropout0"
          and head["metric"]
          == "228M_train_samples_per_sec_per_chip_dropout0.3"
          and d0["value"] > 0 and head["value"] > 0,
          f"(b1) bench train: dropout 0 {d0['value']} samples/s, headline "
          f"(dropout 0.3) {head['value']} samples/s, vs_baseline "
          f"{head['vs_baseline']}")
    if "a" in medians:
        ref = 128 / medians["a"] * 1e3
        gap = head["value"] / ref - 1
        check(abs(gap) <= TOOLS_AGREEMENT,
              f"(b1) the bench headline {head['value']} samples/s within "
              f"{TOOLS_AGREEMENT:.0%} of phase 8's step (a) median "
              f"{medians['a']:.3f} ms ({ref:.1f} samples/s): {gap:+.2%}")
    infer, paths["bench infer"] = counted("infer")
    two = {"rope_rotate": 100,
           **{k: 2 * n for k, n in LN_FORWARD.items()}}
    check(paths["bench infer"] == two,
          f"(b1) bench infer: {infer['value']} frames/s; a warm and a timed "
          f"30 s request launched {paths['bench infer']} == K1 50 and the "
          f"LayerNorm 42 each")
    print(f"(b1) bench infer: one timed request {infer['value']} frames/s "
          f"beside phase 7's 30 s request median at 'auto' "
          + (f"{request_fps['auto']:.1f} frames/s" if "auto" in request_fps
             else "(phase 7 did not run)"), flush=True)
    stream, paths["bench stream"] = counted("stream")
    k1 = paths["bench stream"].get("rope_rotate", 0)
    norms = paths["bench stream"].get("layer_norm_fwd", 0)
    check(set(paths["bench stream"]) == {"rope_rotate", "layer_norm_fwd"}
          and k1 > 0 and k1 % 50 == 0
          and norms == k1 // 50 * LN_FORWARD["layer_norm_fwd"]
          and 0 < stream["value"] < 500,
          f"(b1) bench stream: tick p95 {stream['value']} ms at K = 4 under "
          f"the 500 ms push budget; K1 {k1} launches, 50 a decode forward, "
          f"and the LayerNorm {norms}, 42 a decode forward (warmup's "
          f"included)")
    front, paths["bench frontend"] = counted("frontend")
    check(paths["bench frontend"] == {} and front["value"] > 0,
          f"(b1) bench frontend: {front['value']} audio s/s, no kernel "
          f"launched")

    out, err = run_tool("neurosync_trainer_lite_tpu_torch.bench")
    sub_head = last_json(out)
    sub_d0 = [json.loads(line) for line in err.splitlines()
              if line.startswith('{"metric"')]
    check(sub_head["metric"] == head["metric"] and len(sub_d0) == 1
          and sub_d0[0]["metric"] == d0["metric"],
          f"(b2) python3 -m neurosync_trainer_lite_tpu_torch.bench: last "
          f"stdout line {sub_head}; stderr {sub_d0}")
    out, _ = run_tool("neurosync_trainer_lite_tpu_torch.bench", "--mode",
                      "infer")
    check(last_json(out)["metric"] == infer["metric"],
          f"(b2) --mode infer: last stdout line {last_json(out)}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        out, _ = run_tool(TOOLS + "serving_soak", "soak", "--sessions", "4",
                          "--max-sessions", "8", "--ticks", "120",
                          "--churn", "30", "--out", f"{tmp}/soak.jsonl")
        soak = last_json(out)
        closed = [int(n) for n in re.findall(r"closed after (\d+) frames",
                                             out)]
        check(soak["slow_over_5s"] == 0 and soak["watchdog_flip_tick"] is None
              and "SLOW" not in out and len(closed) == 7 and min(closed) > 0,
              f"(b3) serving_soak: p50 / p95 / max {soak['p50_ms']} / "
              f"{soak['p95_ms']} / {soak['max_ms']} ms, no SLOW tick, no "
              f"watchdog flip, the 7 closed sessions' frames {closed}")
        for fused in ("0", "1"):
            out, _ = run_tool(TOOLS + "serving_knee", f"knee{fused}", "--k",
                              "8", "--reps", "5", "--fused", fused, "--out",
                              f"{tmp}/knee.jsonl")
            knee = last_json(out)
            check(knee["frames_per_decode_tick"] > 0,
                  f"(b4) serving_knee K = 8, --fused {fused}: intake p50 / "
                  f"p95 {knee['intake_p50_ms']} / {knee['intake_p95_ms']} "
                  f"ms, decode p50 / p95 {knee['decode_p50_ms']} / "
                  f"{knee['decode_p95_ms']} ms, "
                  f"{knee['frames_per_decode_tick']} frames a decode tick")
        out, _ = run_tool(TOOLS + "warmup_probe", "--sessions", "8",
                          "--soak-ticks", "40", "--out",
                          f"{tmp}/warmup.jsonl")
        warm = last_json(out)
        check(warm["bg_completed"] and warm["time_to_serve_s"] > 0,
              f"(b5) warmup_probe, 8 sessions: time to serve "
              f"{warm['time_to_serve_s']} s ({warm['n_fused_programs']} "
              f"runs), soak tick ms {warm['soak_tick_ms']}")
        out, _ = run_tool(TOOLS + "local_dispatch_probe", "--sessions", "8",
                          "--ticks", "60", "--device", "cpu")
        local = ast.literal_eval(out.strip().splitlines()[-1])
        check(local["decode_ticks"] > 0 and local["intake_ticks"] > 0,
              f"(b6) local_dispatch_probe on the CPU, 8 sessions: "
              f"{out.strip().splitlines()[1]}; host ms a tick, intake p50 "
              f"{local['intake_host_ms_p50']}, decode p50 "
              f"{local['decode_host_ms_p50']}")
        for letter, flags in STEP_PROBES.items():
            out, err = run_tool(TOOLS + "step_probe", letter, *flags,
                                "--out", f"{tmp}/step.jsonl")
            rec = last_json(out)
            line = next(x for x in err.splitlines()
                        if x.startswith("launches "))
            ran = json.loads(line[len("launches "):])
            want = {k: n * ran["steps"]
                    for k, n in STEP_PROBE_LAUNCHES[letter].items()}
            check(ran["launches"] == want,
                  f"(b7) step_probe ({letter}): {ran['steps']} steps launched "
                  f"{ran['launches']} == {STEP_PROBE_LAUNCHES[letter]} a "
                  f"step")
            what = (f"(b7) step_probe ({letter}) {' '.join(flags)}: "
                    f"{rec['ms_per_step']} ms a step, "
                    f"{rec['samples_per_sec']} samples/s")
            if letter in medians:
                gap = rec["ms_per_step"] / medians[letter] - 1
                check(abs(gap) <= TOOLS_AGREEMENT,
                      f"{what}, within {TOOLS_AGREEMENT:.0%} of phase 8's "
                      f"median {medians[letter]:.3f} ms: {gap:+.2%}")
            else:
                check(rec["ms_per_step"] > 0, what)

        data = REPO / "out" / "chip_smoke_data_scale"
        shutil.rmtree(data, ignore_errors=True)
        try:
            out, _ = run_tool(TOOLS + "data_scale_probe", "--generate",
                              str(data), "--voices", "2", "--minutes", "2")
            print(f"(b8) {out.strip().splitlines()[-1]}", flush=True)
            out, _ = run_tool(TOOLS + "data_scale_probe", "--measure",
                              str(data))
            check("peak RSS" in out and "epoch 2:" in out,
                  "(b8) data_scale_probe --measure:\n"
                  + "\n".join(out.strip().splitlines()[1:]))
            out, _ = run_tool(TOOLS + "train_scale_run", "--root", str(data),
                              "--steps", "20", "--epochs", "1", "--out",
                              os.path.join(tmp, "scale"), "--summary-out",
                              os.path.join(tmp, "summary.json"))
        finally:
            shutil.rmtree(data, ignore_errors=True)
        last = out.strip().splitlines()[-1]
        summary = json.loads(last[len("SUMMARY "):])
        check(last.startswith("SUMMARY ") and summary["optimizer_steps"] == 20
              and summary["nan_steps"] == 0 and summary["model_pth_mb"] > 0,
              f"(b8) train_scale_run --steps 20 --epochs 1: {last}")
    print(f"phase 15 (tools): {time.perf_counter() - t_phase:.3f} s",
          flush=True)
    return paths


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
    by_kernel = {e.key: e.self_device_time_total / 1e3 for e in events}
    # the profiler's events form cycles (each points at its parent and its
    # children; a training step's leave ~0.3M objects): free them here, not
    # in a full collection inside a later timed window
    del prof, events
    gc.collect()
    return by_kernel


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--only", choices=("serve-s2", "live", "parallel", "tensor",
                           "compat", "tools", "ln", "la", "ffn"),
        help="build the kernels and run phase 7b (serve-s2), 7c (live), 12 "
             "(parallel), 13 (tensor), 14 (compat), 15 (tools) or 4 and 5 "
             "(ln, the LayerNorm kernels; la, the lean attention kernels; "
             "ffn, the FFN epilogue kernels) "
             "alone, printing no result line: "
             "to time the (s2) request or the live run of two trees side by "
             "side")
    parser.add_argument("--parallel-worker", nargs=4,
                        metavar=("PART", "RANK", "PORT", "DIR"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.parallel_worker:
        part, rank, port, tmp = args.parallel_worker
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dp_worker(torch, np, part, int(rank), int(port), tmp)
        return 0
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
    if args.only:
        {"serve-s2": serve_long, "live": live, "parallel": parallel,
         "tensor": tensor, "compat": compat_surface,
         "tools": tools,
         "ln": lambda torch, _: ln_checks(torch, {"layer_norm": {}}),
         "la": lambda torch, _: la_checks(torch, {"lean_attention": {}}),
         "ffn": lambda torch, _: ffn_checks(torch, {"ffn_epilogue": {}}),
         }[args.only](torch, np)
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
        "layer_norm": dict(
            route="cuda", source=source + "layer_norm.cu",
            replaces="neurosync_trainer_lite_tpu/models/seq2seq.py:119",
            tolerance="out, dx one bf16 ulp of their terms' size and 99% "
                      "bitwise; dweight, dbias 1e-5*norm(plain)",
            launch_names=["layer_norm_fwd", "layer_norm_bwd"]),
        "lean_attention": dict(
            route="cuda", source=source + "lean_attention.cu",
            replaces="none: the JAX package's ops/attention.py:138 "
                     "_sdpa_lean_core (custom VJP), fused by XLA",
            tolerance="out, dq, dk, dv two bf16 roundings of their terms' "
                      "size and 99% bitwise",
            launch_names=["lean_attention_fwd", "lean_attention_bwd"]),
        "ffn_epilogue": dict(
            route="cuda", source=source + "ffn_epilogue.cu",
            replaces="none: the JAX package's FFN cores "
                     "(models/seq2seq.py), whose epilogues XLA fuses",
            tolerance="ReLU bitwise; GELU h1 bitwise, a, dh1 and dw2's "
                      "operand one bf16 rounding in at most 1e-3 of the "
                      "elements; db1 1e-5*max|plain|",
            launch_names=["ffn_epi_fwd", "ffn_epi_bwd"]),
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
    ln_checks(torch, records)
    la_checks(torch, records)
    ffn_checks(torch, records)
    reference_goldens(torch, np)
    paths, request_fps = {}, {}
    paths["serve"], request_fps = serve(torch, np)
    paths.update({"serve (s2)": serve_long(torch, np),
                  "live": live(torch, np)})
    train_paths, step_a = train(torch)
    paths.update(train_paths)
    train_entry_point(torch, np, step_a)
    paths.update(parallel(torch, np))
    tp_paths, tp_timed, tp_err = tensor(torch, np)
    paths.update(tp_paths)
    paths.update(compat_surface(torch, np, step_a))
    paths.update(tools(torch, np, step_a, request_fps))
    for name, by in tp_timed.items():
        records[name].setdefault("by_shape", {}).update(by)
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                           tp_err[name])
    for counts in paths.values():   # the K3 backward's two kernels
        check(counts.get("flash_attention_bwd_dq", 0)
              == counts.get("flash_attention_bwd_dkdv", 0),
              "the K3 backward launched its two kernels alike")
        if "flash_attention_bwd_dq" in counts:
            counts["flash_attention_bwd"] = counts["flash_attention_bwd_dq"]
    for pair in ("layer_norm", "lean_attention"):   # two kernels each
        for name in records[pair]["launch_names"]:
            check(sum(counts.get(name, 0) for counts in paths.values()) > 0,
                  f"{name} ran in the main path runs")
        for counts in paths.values():
            if f"{pair}_fwd" in counts:
                counts[pair] = (counts[f"{pair}_fwd"]
                                + counts.get(f"{pair}_bwd", 0))
    # the FFN epilogue's three kernels: the Seq2Seq's ReLU runs no act
    # launch, so its forward and backward must run
    for name in ("ffn_epi_fwd", "ffn_epi_bwd"):
        check(sum(counts.get(name, 0) for counts in paths.values()) > 0,
              f"{name} ran in the main path runs")
    for counts in paths.values():
        if "ffn_epi_fwd" in counts:
            counts["ffn_epilogue"] = sum(
                counts.get(name, 0) for name in
                records["ffn_epilogue"]["launch_names"])
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

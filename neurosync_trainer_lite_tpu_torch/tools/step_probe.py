"""One-shot training-step probe: one configuration a process, one JSON line
(the port's counterpart of the repo root's tools/tpu_probe.py, renamed: the
card is no TPU).

Each invocation measures exactly one configuration of the full-width model
and appends one JSON line to the results file, so a shell loop composes a
sweep that a failure cannot lose. A training configuration is timed by
bench.py's _measure_train (3 warm-up steps, then --steps timed steps, the
clock read after one `.item()` of the last loss); --fwd-only times the
forward the same way. The kernel launches of the warm and timed steps go
to stderr as one line, `launches {"steps": N, "launches": {...}}`.

--patch ffn-bwd-pallas routes every FFN backward through K2 (the fused FFN
backward, models/layers.py:ffn_fused, csrc/ffn_bwd.cu) by rebinding
models/seq2seq.py's _ffn, as the JAX probe rebinds its model's. The JAX
probe's other patches ablate or prototype pieces of the XLA program, and
its --rng, --unroll, --cache, --ffn-bm, --ffn-bias and --unroll-residents
tune that program or its Pallas kernel: none applies to eager PyTorch
(tests/test_torch_surface.py maps each with its reason).

Usage: python -m neurosync_trainer_lite_tpu_torch.tools.step_probe NAME
           [--out FILE] [--b B] [--t T] [--steps N]
           [--attn auto|pallas|xla] [--remat 0|1] [--policy full|dots]
           [--scope all|encoder|decoder] [--remat-layers K] [--dropout R]
           [--fwd-only] [--amp 0|1] [--patch ffn-bwd-pallas]
           [--device cpu] [--tiny]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("name")
    p.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "step_probe_results.jsonl"))
    p.add_argument("--b", type=int, default=128)
    p.add_argument("--t", type=int, default=128)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--attn", default="auto")
    p.add_argument("--remat", type=int, default=1)
    p.add_argument("--policy", default="full")
    p.add_argument("--scope", default="all")
    p.add_argument("--remat-layers", type=int, default=-1)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--amp", type=int, default=1)
    p.add_argument("--fwd-only", action="store_true")
    p.add_argument("--patch", default=None, choices=("ffn-bwd-pallas",),
                   help="ffn-bwd-pallas: every FFN backward through K2 "
                        "(models/layers.py:ffn_fused)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--tiny", action="store_true",
                   help="config.tiny_config's geometry (CPU smoke runs)")
    args = p.parse_args(argv)

    import torch

    from neurosync_trainer_lite_tpu_torch import bench
    from neurosync_trainer_lite_tpu_torch.config import full_config, tiny_config
    from neurosync_trainer_lite_tpu_torch.models import seq2seq
    from neurosync_trainer_lite_tpu_torch.ops import kernels
    from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device

    if args.patch == "ffn-bwd-pallas":
        from neurosync_trainer_lite_tpu_torch.models import layers
        seq2seq._ffn = layers.ffn_fused

    device = resolve_device(args.device)
    cfg = (tiny_config if args.tiny else full_config)(
        dropout=args.dropout, remat=bool(args.remat),
        remat_policy=args.policy, remat_scope=args.scope,
        remat_layers=args.remat_layers, attention_impl=args.attn,
        use_amp=bool(args.amp), batch_size=args.b,
        micro_batch_size=args.t)
    kernels.reset_launches()

    if args.fwd_only:
        gen = torch.Generator(device).manual_seed(0)
        src = torch.randn(args.b, args.t, cfg.input_dim, generator=gen,
                          device=device)
        model = seq2seq.init_seq2seq(cfg, gen, device=device).eval()

        def run(n):
            with torch.inference_mode():
                for _ in range(n):
                    out = model(src)
            return out.reshape(-1)[0]

        run(bench.TRAIN_WARMUP).item()
        t0 = time.perf_counter()
        run(args.steps).item()
        dt = time.perf_counter() - t0
    else:
        dt = args.steps * args.b / bench._measure_train(cfg, args.steps,
                                                        device=device)
    # stderr, so that stdout's record keeps the JAX probe's keys: every
    # kernel launch of the warm and timed steps, read by chip_smoke.py
    print("launches " + json.dumps({
        "steps": bench.TRAIN_WARMUP + args.steps,
        "launches": dict(kernels.LAUNCHES)}), file=sys.stderr, flush=True)

    rec = {"name": args.name,
           "samples_per_sec": round(args.steps * args.b / dt, 1),
           "ms_per_step": round(dt / args.steps * 1e3, 2), "b": args.b,
           "t": args.t}
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())

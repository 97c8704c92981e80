#!/usr/bin/env python3
"""Time K3's bf16 tensor-core kernels built with other tuning constants.

    python3 k3_variants.py [--reps 2]

Needs one CUDA card (sm_90a) and nvcc, as chip_smoke.py does. Each variant
is neurosync_trainer_lite_tpu_torch/csrc/flash_attention.cu with one or more
constants of Mma<HD> replaced (the ring depths, the dq kernel's blocks an
SM, the dk/dv kernel's query tile at h <= 64); "as built" is the source as
it stands. All variants build at once with the flags of ops/kernels.py into
build/k3_variants/, and each prints the registers and spills of its h = 64
tensor-core kernels. Each is then held against the plain version within
kernel_limit at (c), (d) and a ragged shape, its backward bitwise
repeatable, and timed like chip_smoke.py's phase 5 (CUDA-graph replays):
forward and backward at (c) [32, 16, 512, 64] and (d) [8, 16, 2048, 64],
the variants taken in turn, `--reps` rounds. Exits non-zero if a variant
does not build or disagrees.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import statistics
import subprocess
import sys
import time

import chip_smoke

#: name -> {text in Mma<HD>: its replacement}
VARIANTS = {
    "as built": {},
    "forward ring 3-deep": {"kFwdStages = 2;": "kFwdStages = 3;"},
    "dq ring 3-deep, 1 block an SM": {
        "kDqStages = 2;": "kDqStages = 3;",
        "kDqBlocks = HD <= 64 ? 4 : 1;": "kDqBlocks = 1;"},
    "dq registers uncapped (1 block an SM)": {
        "kDqBlocks = HD <= 64 ? 4 : 1;": "kDqBlocks = 1;"},
    "dk/dv ring 2-deep": {
        "kDkDvStages = HD <= 64 ? 3 : 2;": "kDkDvStages = 2;"},
    "dk/dv 32 queries a tile": {
        "kQueries = HD <= 64 ? 64 : 32;": "kQueries = 32;"},
}
SHAPES = {"c": (32, 16, 512, 64), "d": (8, 16, 2048, 64)}


def build_variants(kernels) -> dict[str, str]:
    """Write and compile every variant, all nvcc processes at once; returns
    {variant: path of its library}."""
    source = (kernels.CSRC / "flash_attention.cu").read_text()
    out_dir = kernels.BUILD_DIR.parent / "k3_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    running = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits.items():
            if text.count(old) != 1:
                raise SystemExit(f"k3_variants: '{old}' is not once in "
                                 f"flash_attention.cu")
            text = text.replace(old, new)
        src, lib = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        src.write_text(text)
        cmd = kernels.nvcc_command(src, lib)
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         lib)
    built = {}
    for name, (proc, lib) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k3_variants: '{name}' did not build:\n{log}")
        summary = io.StringIO()
        with contextlib.redirect_stdout(summary):
            chip_smoke.print_ptxas_summary(log)
        for line in summary.getvalue().splitlines():
            if "mma_kernel" in line and "ILi64E" in line:
                print(f"{name}: {line}", flush=True)
        built[name] = str(lib)
    return built


def use(kernels, path: str) -> None:
    """Route the K3 wrappers to the library at `path`."""
    lib = ctypes.CDLL(path)
    for fn, argtypes in kernels._ARGTYPES["flash_attention"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    kernels._libs["flash_attention"] = lib


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device is available", file=sys.stderr)
        return 1
    from neurosync_trainer_lite_tpu_torch.ops import flash_attention as fa
    from neurosync_trainer_lite_tpu_torch.ops import kernels

    print(chip_smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    built = build_variants(kernels)
    print(f"build: {time.perf_counter() - t0:.3f} s for {len(built)} "
          f"variants", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(6)
    inputs = {label: [torch.randn(B, N, T, h, device="cuda", generator=gen)
                      .to(torch.bfloat16) for _ in range(4)]
              for label, (B, N, T, h) in SHAPES.items()}
    ragged = [torch.randn(2, 4, t, 32, device="cuda", generator=gen)
              .to(torch.bfloat16) for t in (96, 192, 192, 96)]

    for name, path in built.items():
        use(kernels, path)
        for q, k, v, do in list(inputs.values()) + [ragged]:
            scale = q.shape[-1] ** -0.5
            got = [fa.flash_attention_cuda(q, k, v, scale),
                   *fa.flash_attention_bwd_cuda(q, k, v, do, scale)]
            want = [fa.flash_attention_plain(q, k, v, scale),
                    *fa.flash_attention_bwd_plain(q, k, v, do, scale)]
            again = fa.flash_attention_bwd_cuda(q, k, v, do, scale)
            ok = all(bool(((a.float() - b.float()).abs()
                           <= fa.kernel_limit(b, torch.bfloat16)).all())
                     for a, b in zip(got, want))
            if not (ok and all(torch.equal(a, b)
                               for a, b in zip(got[1:], again))):
                print(f"k3_variants: '{name}' at {list(q.shape)} | "
                      f"{k.shape[2]} is outside kernel_limit or not "
                      f"repeatable", file=sys.stderr)
                return 1
            del got, want, again
        print(f"{name}: within kernel_limit at (c), (d) and [2, 4, 96 | "
              f"192, 32], backward bitwise repeatable", flush=True)
        torch.cuda.empty_cache()

    times = {name: {} for name in built}
    with torch.no_grad():
        for _ in range(args.reps):
            for name, path in built.items():
                use(kernels, path)
                for label, (q, k, v, do) in inputs.items():
                    scale = q.shape[-1] ** -0.5
                    iters = 10 if q.shape[2] <= 512 else 4
                    for what, fn in (
                            ("forward", lambda: fa.flash_attention_cuda(
                                q, k, v, scale)),
                            ("backward", lambda: fa.flash_attention_bwd_cuda(
                                q, k, v, do, scale))):
                        times[name].setdefault(f"{what} ({label})", []).append(
                            chip_smoke.device_ms(fn, iters=iters))
    for name, by_kernel in times.items():
        print(f"{name}: " + ", ".join(
            f"{key} {statistics.median(ms):.4f} ms "
            f"({' / '.join(f'{t:.4f}' for t in ms)})"
            for key, ms in by_kernel.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

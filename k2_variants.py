#!/usr/bin/env python3
"""Time K2 (the fused FFN backward) built with parts of it changed.

    python3 k2_variants.py [--reps 3]

Needs one CUDA card (sm_90a) and nvcc, as chip_smoke.py does. Each variant
is neurosync_trainer_lite_tpu_torch/csrc/ffn_bwd.cu with some text replaced
(VARIANTS); "as built" is the source as it stands. All variants build at
once with the flags of ops/kernels.py into build/k2_variants/, and each
prints the registers and spills of its kernels. Each is then held against
the plain version within kernel_limits at step (a)'s [16384, 1024, 4096]
and the ragged [300, 136, 520] (the outputs a variant leaves out are not
checked), bitwise repeatable, and timed like chip_smoke.py's phase 5
(CUDA-graph replays) at [16384, 1024, 4096], the variants taken in turn,
`--reps` rounds. Exits non-zero if a variant does not build or disagrees.
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

#: name -> ({text of ffn_bwd.cu: its replacement}, outputs it computes)
VARIANTS = {
    "as built": ({}, ("dh1", "db2", "db1")),
    # the db2 pass of the column-tile-0 blocks left out: its time
    "no db2 pass": ({"    if (blockIdx.x != 0) return;\n": "    return;\n"},
                    ("dh1", "db1")),
    "2-deep ring": ({"constexpr int kWgStages = 3;": "constexpr int kWgStages = 2;"},
                    ("dh1", "db2", "db1")),
    # every shape to the WMMA kernel, the one for shapes TMA cannot describe
    "WMMA kernel": ({"  const bool tma = h % 8 == 0 &&": "  const bool tma = false &&"},
                    ("dh1", "db2", "db1")),
}
SHAPES = [(16384, 1024, 4096), (300, 136, 520)]


def build_variants(kernels) -> dict[str, str]:
    """Write and compile every variant, all nvcc processes at once; returns
    {variant: path of its library}."""
    source = (kernels.CSRC / "ffn_bwd.cu").read_text()
    out_dir = kernels.BUILD_DIR.parent / "k2_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    running = {}
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits.items():
            if text.count(old) != 1:
                raise SystemExit(f"k2_variants: '{old}' is not once in "
                                 f"ffn_bwd.cu")
            text = text.replace(old, new)
        src, lib = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        src.write_text(text)
        running[name] = (subprocess.Popen(
            kernels.nvcc_command(src, lib), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k2_variants: '{name}' did not build:\n{log}")
        summary = io.StringIO()
        with contextlib.redirect_stdout(summary):
            chip_smoke.print_ptxas_summary(log)
        for line in summary.getvalue().splitlines():
            print(f"{name}: {line}", flush=True)
        built[name] = str(lib)
    return built


def use(kernels, path: str) -> None:
    """Route the K2 wrapper to the library at `path`."""
    lib = ctypes.CDLL(path)
    for fn, argtypes in kernels._ARGTYPES["ffn_bwd"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    kernels._libs["ffn_bwd"] = lib


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device is available", file=sys.stderr)
        return 1
    from neurosync_trainer_lite_tpu_torch.ops import ffn_bwd
    from neurosync_trainer_lite_tpu_torch.ops import kernels

    print(chip_smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    built = build_variants(kernels)
    print(f"build: {time.perf_counter() - t0:.3f} s for {len(built)} "
          f"variants", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(7)
    bf16 = torch.bfloat16

    def inputs(m, h, f):
        dy = torch.randn(m, h, device="cuda", generator=gen).to(bf16)
        w = (torch.randn(h, f, device="cuda", generator=gen) * 0.02).to(bf16)
        am = torch.relu(torch.randn(m, f, device="cuda", generator=gen)
                        - 0.3).to(bf16)
        return dy, w, am

    data = {shape: inputs(*shape) for shape in SHAPES}
    scale = 256 / 179
    for name, path in built.items():
        use(kernels, path)
        checked = VARIANTS[name][1]
        for (m, h, f), (dy, w, am) in data.items():
            got = ffn_bwd.ffn_bwd_dh1_cuda(dy, w, am, scale=scale)
            again = ffn_bwd.ffn_bwd_dh1_cuda(dy, w, am, scale=scale)
            want = ffn_bwd.ffn_bwd_dh1_plain(dy, w, am, scale=scale)
            ok = all(bool(((a.float() - b.float()).abs() <= limit).all())
                     and torch.equal(a, c)
                     for out, a, b, c, limit in zip(
                         ("dh1", "db2", "db1"), got, want, again,
                         ffn_bwd.kernel_limits(want)) if out in checked)
            if not ok:
                print(f"k2_variants: '{name}' at [{m}, {h}, {f}] is outside "
                      f"kernel_limits or not repeatable", file=sys.stderr)
                return 1
        print(f"{name}: {', '.join(checked)} within kernel_limits at "
              f"{[list(s) for s in SHAPES]}, bitwise repeatable", flush=True)

    dy, w, am = data[SHAPES[0]]
    times = {name: [] for name in built}
    with torch.no_grad():
        for _ in range(args.reps):
            for name, path in built.items():
                use(kernels, path)
                times[name].append(chip_smoke.device_ms(
                    lambda: ffn_bwd.ffn_bwd_dh1_cuda(dy, w, am, scale=scale),
                    iters=10))
    for name, ms in times.items():
        print(f"{name}: {list(SHAPES[0])} {statistics.median(ms):.6f} ms "
              f"({' / '.join(f'{t:.6f}' for t in ms)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build, load and count the port's hand-written CUDA kernels.

Each source in ``csrc/`` compiles with nvcc for ``sm_90a`` into a shared
library with a plain C interface, loaded with ctypes; the headers beside
them (``csrc/*.cuh``) are shared. Libraries go to ``build/torch_kernels/``
at the repository root, named by a hash of the source, the headers and the
flags, so an edited source or header builds anew. Nothing builds when a
module is imported: a wrapper builds its library at its first launch, and
``build()`` builds several at once, one nvcc process per source, all started
together.

``LAUNCHES`` counts kernel launches by name. A wrapper adds one exactly where
it launches its kernel; the plain PyTorch versions add nothing, so a run that
reads the counts shows whether the CUDA kernels ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("rope", "fused_attention", "flash_attention", "ffn_bwd",
           "layer_norm", "lean_attention", "ffn_epilogue")
# -Xptxas -v: the build log lists each kernel's registers and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches by kernel name since the last reset_launches()
LAUNCHES: Counter = Counter()

_libs: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_S = ctypes.POINTER(ctypes.c_longlong)  # an operand's three strides
_ARGTYPES = {
    "rope": {"rope_rotate": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "fused_attention": {
        "fused_rope_attention_fwd": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, ctypes.c_float, _I, _P],
        "fused_rope_attention_bwd": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]},
    "flash_attention": {
        "flash_attention_fwd": [
            _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P],
        "flash_attention_bwd_dq": [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P],
        "flash_attention_bwd_dkdv": [
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I,
            _P]},
    "ffn_bwd": {
        "ffn_bwd_dh1": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        ctypes.c_float, _P]},
    "layer_norm": {
        "layer_norm_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
        "layer_norm_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _P],
        "layer_norm_bwd_blocks": [_I, _I]},
    "lean_attention": {
        "lean_attention_fwd": [_P, _S, _P, _S, _P, _S, _P, _S, _P,
                               _I, _I, _I, _I, _I, _F, _I, _F, _P],
        "lean_attention_bwd": [_P, _S, _P, _S, _P, _S, _P, _S, _P, _S,
                               _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _F,
                               _P]},
    "ffn_epilogue": {
        "ffn_epi_fwd": [_P, _P, _P, _L, _I, _F, _I, _P, _P, _I, _I, _P],
        "ffn_epi_bwd": [_P, _P, _P, _L, _I, _F, _I, _P, _P, _P, _P, _I, _I,
                        _I, _P],
        "ffn_epi_bwd_blocks": [_I, _I]},
}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def nvcc_command(source: Path, out: Path) -> list[str]:
    """The nvcc line that builds `source` (a csrc/*.cu or an edited copy of
    one) into the shared library `out`."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(source)]


def library_path(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes()
    text += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES) -> dict[str, tuple[float, str]]:
    """Compile each named source whose library is missing, all in parallel.

    Returns {name: (seconds, compiler output)} for the sources it built;
    raises with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = nvcc_command(CSRC / f"{name}.cu", tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    built, failed = {}, []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        built[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return built


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if missing."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in _ARGTYPES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def aligned16(t):
    """t contiguous and starting on a 16-byte boundary, for kernels that
    load 16 bytes at a time (a contiguous view may start anywhere)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_launch(status: int, kernel: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t "
                           f"{status}")
    LAUNCHES[kernel] += 1

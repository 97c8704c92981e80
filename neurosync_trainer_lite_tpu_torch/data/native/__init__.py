"""ctypes binding and lazy build of the native window gather (host code).

Port of neurosync_trainer_lite_tpu/data/native/__init__.py. The library is
compiled at first use with the system g++ into ``build/native/`` at the
repository root (ignored by git), named by a hash of the source and the
flags, never next to the source. Where no compiler is available
``load_library`` returns None and the dataset takes the numpy gather, which
gives the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "window_gather.cc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
# no -march=native: the library is named by source and flags only, so one
# built on one host may be loaded on another that shares the directory
_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libwindow_gather-{digest[:12]}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if res.returncode != 0:
        return False
    os.replace(tmp, out)
    return True


def load_library():
    """The ctypes library, or None if it cannot be built. Thread-safe,
    cached for the process."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        pp = ctypes.POINTER(ctypes.c_float)
        lib.gather_windows_pair.argtypes = [
            ctypes.POINTER(pp), ctypes.POINTER(pp),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            pp, pp,
        ]
        lib.gather_windows_pair.restype = None
        _lib = lib
        return _lib


def _ptr_array(arrays: list[np.ndarray]):
    pp = ctypes.POINTER(ctypes.c_float)
    return (pp * len(arrays))(*[a.ctypes.data_as(pp) for a in arrays])


class NativeGather:
    """The gather bound to one dataset's clip buffers. Holds the per-clip
    pointer arrays and references to the numpy buffers, so that they cannot
    be freed under the native code."""

    def __init__(self, audio: list[np.ndarray], facial: list[np.ndarray],
                 table: np.ndarray, window: int):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native gather library unavailable")
        for a in audio + facial:
            if a.dtype != np.float32 or not a.flags["C_CONTIGUOUS"]:
                raise ValueError("clip buffers must be C-contiguous float32")
        self._lib = lib
        self._audio = audio
        self._facial = facial
        self._audio_ptrs = _ptr_array(audio)
        self._facial_ptrs = _ptr_array(facial)
        self._table = np.ascontiguousarray(table, dtype=np.int64)
        self.window = window
        self.audio_dim = audio[0].shape[1] if audio else 0
        self.facial_dim = facial[0].shape[1] if facial else 0

    def __call__(self, idxs: np.ndarray, out=None) -> tuple[np.ndarray, np.ndarray]:
        """Windows idxs of the table → (src [B, W, audio_dim], trg [B, W,
        facial_dim]) float32, written into `out` (a pair of such arrays,
        e.g. pinned host memory) if given."""
        idxs = np.ascontiguousarray(idxs, dtype=np.int64)
        if len(idxs) and (idxs.min() < 0 or idxs.max() >= len(self._table)):
            raise IndexError("window index out of range")
        b = len(idxs)
        if out is None:
            out = (np.empty((b, self.window, self.audio_dim), np.float32),
                   np.empty((b, self.window, self.facial_dim), np.float32))
        src, trg = out
        if (src.shape != (b, self.window, self.audio_dim)
                or trg.shape != (b, self.window, self.facial_dim)
                or src.dtype != np.float32 or trg.dtype != np.float32
                or not (src.flags["C_CONTIGUOUS"] and trg.flags["C_CONTIGUOUS"])):
            raise ValueError("gather output must be C-contiguous float32 "
                             "[B, window, dim]")
        i64p = ctypes.POINTER(ctypes.c_int64)
        fp = ctypes.POINTER(ctypes.c_float)
        self._lib.gather_windows_pair(
            self._audio_ptrs, self._facial_ptrs,
            self._table.ctypes.data_as(i64p), idxs.ctypes.data_as(i64p),
            b, self.window, self.audio_dim, self.facial_dim,
            src.ctypes.data_as(fp), trg.ctypes.data_as(fp),
        )
        return src, trg

"""The reader of a profiler trace: what the device did over a stretch.

Input is the event list of a Chrome trace as torch.profiler exports it
(``export_chrome_trace``): complete events (``"ph": "X"``) with a ``cat``,
a ``name``, a start ``ts`` and a ``dur`` in microseconds, device and host on
one clock. Device operations are the events of the categories in DEVICE_CATS;
host operations those of HOST_CATS.

- busy time is the union of the device operations' intervals inside the
  stretch, not the sum of their durations: operations on two streams that
  overlap count once;
- the idle gaps are the stretches inside the window that no device
  operation covers; the longest are each labelled by the innermost host
  operation running at its midpoint: what the host was doing while the
  card waited;
- kernels are classified by name (KERNEL_CLASSES, the first pattern that
  matches); names that match none are 'unclassified' and listed, so that a
  new kernel shows up instead of being counted silently.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from pathlib import Path

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime",
                       "cuda_driver"})

#: (class, pattern) in the order tried. 'gemm' is a matrix product on the
#: tensor cores or the CUDA cores: cuBLAS's and CUTLASS's kernels, and the
#: port's own product kernels (the attention kernels K3 and K4 and the FFN
#: backward K2, whose time is their products').
KERNEL_CLASSES = (
    ("collective", r"nccl|Nccl"),
    ("gemm", r"gemm|gemv|nvjet|xmma|cutlass|cublas|wgmma|_mma_kernel|"
             r"attn_fwd_kernel|attn_bwd_kernel|flash_\w*kernel|"
             r"ffn_bwd_\w*kernel|splitKreduce|matmul"),
    ("rope", r"rope_rows"),
    ("fft", r"fft|regular_fft|vector_fft|dft"),
    ("reduction", r"reduce_kernel|Reduce|softmax|Softmax|norm|Norm|"
                  r"_sum_|cunn_|welford"),
    ("copy", r"copy|Copy|cat_|Cat|index|Index|gather|scatter|"
             r"transpose|unfold|im2col|Memcpy|Memset|memcpy|memset"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise|"
                    r"fill|where|clamp|pointwise|distribution|random|"
                    r"philox|bernoulli|foreach|multi_tensor|"
                    r"CatArrayBatchedCopy|launch_kernel"),
)
_COMPILED = tuple((c, re.compile(p)) for c, p in KERNEL_CLASSES)


def classify(name: str) -> str:
    for cls, pattern in _COMPILED:
        if pattern.search(name):
            return cls
    return "unclassified"


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Profile:
    """The device's and the host's operations inside [start, end] (µs);
    without a window, the span of the device operations."""

    def __init__(self, events: list[dict], window: tuple[float, float]
                 | None = None):
        complete = [e for e in events if e.get("ph") == "X"
                    and "ts" in e and "dur" in e]
        self.device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e.get("name", ""), e.get("cat"))
                       for e in complete if e.get("cat") in DEVICE_CATS]
        self.host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e.get("name", ""))
                     for e in complete if e.get("cat") in HOST_CATS]
        if window is None and self.device:
            window = (min(a for a, *_ in self.device),
                      max(b for _, b, *_ in self.device))
        self.window = window or (0.0, 0.0)
        lo, hi = self.window
        self.device = [(max(a, lo), min(b, hi), n, c)
                       for a, b, n, c in self.device if b > lo and a < hi]

    @classmethod
    def from_file(cls, path, window_name: str | None = None) -> "Profile":
        events = json.loads(Path(path).read_text())
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        window = None
        if window_name is not None:
            marks = [e for e in events if e.get("name") == window_name
                     and e.get("ph") == "X" and e.get("cat") in HOST_CATS]
            if marks:
                m = max(marks, key=lambda e: float(e["dur"]))
                window = (float(m["ts"]), float(m["ts"]) + float(m["dur"]))
        return cls(events, window)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_us(self) -> float:
        return sum(b - a for a, b in _union([(a, b) for a, b, *_ in
                                             self.device]))

    def idle_pct(self) -> float | None:
        if self.window_us <= 0 or not self.device:
            return None
        return 100.0 * (1.0 - self.busy_us() / self.window_us)

    def kernel_us(self) -> Counter:
        """Device time by kernel name (kernels only, durations summed)."""
        out: Counter = Counter()
        for a, b, name, cat in self.device:
            if cat == "kernel":
                out[name] += b - a
        return out

    def class_us(self) -> Counter:
        out: Counter = Counter()
        for name, us in self.kernel_us().items():
            out[classify(name)] += us
        return out

    def unclassified(self, top: int = 5) -> list[tuple[str, float]]:
        return [(n, us) for n, us in self.kernel_us().most_common()
                if classify(n) == "unclassified"][:top]

    def kernel_stats(self, pattern: str) -> tuple[int, float]:
        """(launches, summed device µs) of the kernels matching `pattern`."""
        rx = re.compile(pattern)
        hits = [b - a for a, b, n, c in self.device
                if c == "kernel" and rx.search(n)]
        return len(hits), sum(hits)

    def exposed_us(self, pattern: str) -> float:
        """Device time in which kernels matching `pattern` run and no other
        device operation runs beside them."""
        rx = re.compile(pattern)
        mine = _union([(a, b) for a, b, n, c in self.device
                       if c == "kernel" and rx.search(n)])
        rest = _union([(a, b) for a, b, n, c in self.device
                       if not (c == "kernel" and rx.search(n))])
        covered, j = 0.0, 0
        for a, b in mine:
            while j < len(rest) and rest[j][1] <= a:
                j += 1
            k = j
            while k < len(rest) and rest[k][0] < b:
                covered += min(b, rest[k][1]) - max(a, rest[k][0])
                k += 1
        return sum(b - a for a, b in mine) - covered

    def gaps(self) -> list[tuple[float, float]]:
        """The idle stretches of the window, longest first."""
        lo, hi = self.window
        merged = _union([(a, b) for a, b, *_ in self.device])
        out, t = [], lo
        for a, b in merged:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi > t:
            out.append((t, hi))
        return sorted(out, key=lambda g: g[0] - g[1])

    def host_at(self, t: float, skip: str | None = None) -> str:
        """The innermost host operation running at t, or 'no host op'."""
        running = [(b - a, name) for a, b, name in self.host
                   if a <= t <= b and name != skip]
        return min(running)[1] if running else "no host op"

    def breakdown(self, top: int = 10, skip: str | None = None) -> dict:
        """The contract's breakdown, in seconds: the device operations that
        took most time (summed by name) and the `top` longest idle gaps,
        each named by the host operation running at its midpoint."""
        ops: Counter = Counter()
        for a, b, name, _ in self.device:
            ops[name] += b - a
        return {"device_ops": [[n[:200], us / 1e6]
                               for n, us in ops.most_common(top)],
                "idle_gaps": [[self.host_at((a + b) / 2, skip)[:200],
                               (b - a) / 1e6]
                              for a, b in self.gaps()[:top]]}

"""Lazy stride-1 windowing over per-clip feature arrays (port of
neurosync_trainer_lite_tpu/data/windowing.py).

Window semantics match the reference (reference: dataset/dataset.py:58-98):
every 128-frame window at stride 1 (starts 0..T-128), plus one extra final
window [T-128, T) whenever T % 128 != 0 (the reference's "reflection tail"
branch, which duplicates the last window). Windows are never materialized:
the dataset keeps one (audio [T, 256], facial [T, 61]) pair per clip and an
[N, 2] table of (clip, start), and batches are gathered on demand, by the
native gather (data/native) where it builds, else by numpy: the same bytes.

The split is a seeded permutation of window indices (90/10 at val_split
0.1), the batch order a seeded permutation per epoch, as in the JAX
package, so both packages see the same windows in the same order.

Under data parallelism every rank walks the same seeded batch order and
gathers only its own rows of each batch (``host_batches(mesh=...)``).

Batches for the card: ``host_batches`` gathers each batch into pinned host
memory, and ``prefetch`` runs that gather in a background thread. The copy
to the card belongs to the consumer (``to_device``: non_blocking on the
step's stream), so it is ordered with the step that reads it; a copy issued
from the prefetch thread on another stream would race the step. PyTorch's
pinned-memory allocator does not hand a buffer out again until the copies
that read it are done.
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np
import torch

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.parallel.distributed import rank_rows


class WindowedDataset:
    """Windows over a list of (audio_features, facial_data) clip pairs."""

    def __init__(self, clips: list[tuple[np.ndarray, np.ndarray]],
                 window: int = 128):
        self.window = window
        self.audio = []
        self.facial = []
        table = []
        for ci, (a, f) in enumerate(clips):
            a = np.ascontiguousarray(a, dtype=np.float32)
            f = np.ascontiguousarray(f, dtype=np.float32)
            n = min(len(a), len(f))
            a, f = a[:n], f[:n]
            self.audio.append(a)
            self.facial.append(f)
            if n < window:
                print(f"skipping clip {ci}: {n} frames < window {window}")
                continue
            starts = list(range(0, n - window + 1))
            if n % window != 0:
                starts.append(n - window)  # duplicated tail window (see above)
            table.extend((ci, s) for s in starts)
        self.table = np.asarray(table, dtype=np.int64).reshape(-1, 2)

    def __len__(self) -> int:
        return len(self.table)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        ci, s = self.table[idx]
        w = self.window
        return self.audio[ci][s: s + w], self.facial[ci][s: s + w]

    @property
    def dims(self) -> tuple[int, int]:
        """(audio_dim, facial_dim) of the clips."""
        if not self.audio:
            return 0, 0
        return self.audio[0].shape[1], self.facial[0].shape[1]

    def batch_shapes(self, n: int) -> tuple[tuple, tuple]:
        """The shapes of a batch of n windows: (src, trg)."""
        audio_dim, facial_dim = self.dims
        return (n, self.window, audio_dim), (n, self.window, facial_dim)

    def _native_gather(self):
        """The native gather over this dataset (built once), or None."""
        if not hasattr(self, "_native"):
            from neurosync_trainer_lite_tpu_torch.data.native import (
                NativeGather)

            try:
                self._native = NativeGather(self.audio, self.facial,
                                            self.table, self.window)
            except (RuntimeError, ValueError, IndexError):
                self._native = None
        return self._native

    def gather(self, idxs: np.ndarray, out=None) -> tuple[np.ndarray, np.ndarray]:
        """Batch gather → (src [B, W, audio_dim], trg [B, W, facial_dim])
        float32, into `out` (a pair of such arrays) if given."""
        native = self._native_gather()
        if native is not None:
            return native(np.asarray(idxs), out)
        w = self.window
        rows = self.table[idxs]
        src = np.stack([self.audio[ci][s: s + w] for ci, s in rows])
        trg = np.stack([self.facial[ci][s: s + w] for ci, s in rows])
        if out is None:
            return src, trg
        out[0][...] = src
        out[1][...] = trg
        return out

    def split(self, val_fraction: float, seed: int) -> tuple["_View", "_View"]:
        """Deterministic shuffled split into (train, val) views."""
        perm = np.random.default_rng(seed).permutation(len(self.table))
        n_val = int(len(perm) * val_fraction)
        return _View(self, perm[n_val:]), _View(self, perm[:n_val])

    def batches(self, batch_size: int, *, shuffle: bool = False,
                seed: int = 0, drop_last: bool = False,
                wrap: bool = False) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        return _iterate(self, np.arange(len(self)), batch_size,
                        shuffle=shuffle, seed=seed, drop_last=drop_last,
                        wrap=wrap)

    def index_batches(self, batch_size: int, *, shuffle: bool = False,
                      seed: int = 0, drop_last: bool = False,
                      wrap: bool = False) -> Iterator[np.ndarray]:
        """Same order as batches(), but yields base-index chunks ungathered."""
        return _iter_index_chunks(np.arange(len(self)), batch_size,
                                  shuffle=shuffle, seed=seed,
                                  drop_last=drop_last, wrap=wrap)


class _View:
    """An index-subset view over a WindowedDataset."""

    def __init__(self, base: WindowedDataset, idxs: np.ndarray):
        self.base = base
        self.idxs = np.asarray(idxs)

    def __len__(self) -> int:
        return len(self.idxs)

    def __getitem__(self, i: int):
        return self.base[self.idxs[i]]

    def gather(self, idxs: np.ndarray, out=None):
        return self.base.gather(self.idxs[idxs], out)

    def batches(self, batch_size: int, *, shuffle: bool = False,
                seed: int = 0, drop_last: bool = False, wrap: bool = False):
        return _iterate(self.base, self.idxs, batch_size, shuffle=shuffle,
                        seed=seed, drop_last=drop_last, wrap=wrap)

    def index_batches(self, batch_size: int, *, shuffle: bool = False,
                      seed: int = 0, drop_last: bool = False,
                      wrap: bool = False) -> Iterator[np.ndarray]:
        """Same order as batches(), but yields base-index chunks ungathered."""
        return _iter_index_chunks(self.idxs, batch_size, shuffle=shuffle,
                                  seed=seed, drop_last=drop_last, wrap=wrap)


def _iter_index_chunks(idxs: np.ndarray, batch_size: int, *, shuffle: bool,
                       seed: int, drop_last: bool, wrap: bool
                       ) -> Iterator[np.ndarray]:
    """The batch order, as base-index chunks: a seeded permutation when
    shuffling; with wrap, the last batch is padded by cycling the order (also
    when the whole view is smaller than one batch)."""
    order = np.array(idxs)
    if shuffle:
        order = np.random.default_rng(seed).permutation(order)
    n = len(order)
    if wrap and n > 0 and n % batch_size != 0:
        pad = batch_size - n % batch_size
        reps = np.concatenate([order] * (pad // n + 1))
        order = np.concatenate([order, reps[:pad]])
    stop = (n // batch_size * batch_size) if drop_last else len(order)
    for i in range(0, stop, batch_size):
        chunk = order[i: i + batch_size]
        if drop_last and len(chunk) < batch_size:
            break
        yield chunk


def _iterate(base: WindowedDataset, idxs: np.ndarray, batch_size: int, *,
             shuffle: bool, seed: int, drop_last: bool, wrap: bool):
    for chunk in _iter_index_chunks(idxs, batch_size, shuffle=shuffle,
                                    seed=seed, drop_last=drop_last, wrap=wrap):
        yield base.gather(chunk)


def host_batches(view, batch_size: int, *, pin_memory: bool, mesh=None,
                 accum: int = 1, busy: list[float] | None = None, **order
                 ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """view.batches(batch_size, **order) as fp32 torch tensors, each batch
    gathered straight into newly allocated (pinned, if asked) host memory.

    Under a mesh each batch is this rank's rows of the global one
    (parallel/distributed.py:rank_rows, laid out for `accum` micro-batches),
    and only those windows are gathered. The batch order stays a function
    of the seed, the same on every rank. busy: a one-item list of seconds
    that each batch's allocation and gather adds to (the training loop's
    gather_seconds)."""
    base = getattr(view, "base", view)
    for chunk in view.index_batches(batch_size, **order):
        start = time.perf_counter()
        if mesh is not None:
            chunk = rank_rows(chunk, mesh, accum)
        src_shape, trg_shape = base.batch_shapes(len(chunk))
        src = torch.empty(src_shape, pin_memory=pin_memory)
        trg = torch.empty(trg_shape, pin_memory=pin_memory)
        base.gather(chunk, (src.numpy(), trg.numpy()))
        if busy is not None:
            busy[0] += time.perf_counter() - start
        yield src, trg


def to_device(batch, device: torch.device):
    """Host batch → device, on the current stream: non-blocking from pinned
    memory, so the copy is ordered before the step that reads it."""
    return tuple(t.to(device, non_blocking=True) for t in batch)


def prefetch(iterator, depth: int = 2):
    """Run `iterator` (the batch gather) in a background thread, `depth`
    items ahead of the consumer. An exception in the thread is raised in
    the consumer; a consumer that stops early releases the thread."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()  # set when the consumer abandons the generator

    def _offer(item) -> bool:
        # a plain q.put would block forever once the consumer is gone
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not _offer(item):
                    return
            _offer(sentinel)
        except BaseException as e:  # raised again in the consumer
            _offer(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def feature_windows(cfg: Config, clips=None, device=None) -> WindowedDataset:
    """The Seq2Seq's dataset (models/architectures.py): the given clips, or
    cfg.root_dir's with features from the device frontend on `device`."""
    if clips is None:
        from neurosync_trainer_lite_tpu_torch.data.processing import load_data

        clips = load_data(cfg.root_dir, cfg.sr, ffmpeg_path=cfg.ffmpeg_path,
                          device=device)
    return WindowedDataset(clips, window=cfg.micro_batch_size)


def prepare_datasets(cfg: Config, clips=None, device=None):
    """The dataset cfg.architecture takes (models/architectures.py), over
    the given clips or those loaded from cfg.root_dir, and return (dataset,
    train_view, val_view) with the seeded split (reference:
    dataset.py:12-21)."""
    from neurosync_trainer_lite_tpu_torch.models.architectures import (
        architecture,
    )

    ds = architecture(cfg.architecture).dataset(cfg, clips, device)
    train, val = ds.split(cfg.val_split, cfg.seed)
    return ds, train, val

"""The training batches as the loop's stated order cuts them from the
corpus, worked out again from the seed for the check.

Windows: every `window`-frame window of each clip at stride 1, and the
clip's last window once more where its length is not a multiple of
`window`. The split: a permutation of the windows seeded with the run's
seed (numpy's default_rng); its first val_split of them validate, the rest
train. Epoch e: a permutation of the training windows seeded with
seed + e, cut into batches of `batch` windows in that order.
"""

from __future__ import annotations

import numpy as np


def window_table(frames: list[int], window: int) -> np.ndarray:
    """[N, 2] rows of (clip, start), clip by clip."""
    parts = []
    for ci, n in enumerate(frames):
        if n < window:
            continue
        starts = np.arange(n - window + 1)
        if n % window:
            starts = np.append(starts, n - window)
        parts.append(np.stack([np.full_like(starts, ci), starts], 1))
    return np.concatenate(parts).astype(np.int64)


def epoch_batches(frames: list[int], window: int, val_split: float,
                  seed: int, epoch: int, batch: int, steps: int
                  ) -> list[np.ndarray]:
    """The first `steps` batches of epoch `epoch`, each [batch, 2] rows of
    (clip, start)."""
    table = window_table(frames, window)
    perm = np.random.default_rng(seed).permutation(len(table))
    train = perm[int(len(perm) * val_split):]
    order = np.random.default_rng(seed + epoch).permutation(train)
    return [table[order[i * batch:(i + 1) * batch]] for i in range(steps)]


def gather(series, frames: list[int], rows: np.ndarray, window: int):
    """The windows `rows` of `series` (the clips' frames end to end, a
    tensor [sum(frames), dim]) as a tensor [len(rows), window, dim]."""
    import torch

    offsets = np.concatenate([[0], np.cumsum(frames)[:-1]])
    first = offsets[rows[:, 0]] + rows[:, 1]
    idx = torch.as_tensor(first[:, None] + np.arange(window)[None, :],
                          device=series.device)
    return series[idx]

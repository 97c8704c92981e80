"""Tiny contexts of the benchmark's cells for the CPU: the cells' own files
with the widths, depth, batch and corpus cut, everything else as run."""

from __future__ import annotations

import copy

from benchmark.common import harness

TINY_MODEL = dict(hidden_dim=64, n_layers=2, num_heads=4)
TINY = {
    "train-w128-b128": (dict(batch_size=8, micro_batch_size=16),
                        dict(clips=2, clip_frames=300, profile_steps=2,
                             reference_rows=4)),
    "serve-utterances": ({}, dict(rungs=5, max_s=3.0, profile_requests=2,
                                  check_requests=3)),
    # four CPU ranks over gloo in place of four cards
    "train-dp4-w128-b128": (dict(micro_batch_size=16),
                            dict(batch_size_per_chip=2, clips=2,
                                 clip_frames=300, profile_steps=2,
                                 reference_rows=4)),
}


def context(cell: str, seed: int = 12345, *, seconds: float = 0.5,
            trace: bool = False, **config) -> harness.Context:
    work = copy.deepcopy(harness.workload(cell))
    cfg = harness.config(work["config"])
    cut_config, cut_params = TINY[cell]
    cfg.update(TINY_MODEL, **cut_config)
    cfg.update(config)
    work["params"].update(cut_params)
    return harness.Context(cell=cell, workload=work, config=cfg, seed=seed,
                           seconds=seconds, trace=trace, device="cpu",
                           chips=int(work["chips"]))

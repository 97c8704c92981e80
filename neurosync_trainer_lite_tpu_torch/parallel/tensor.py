"""Tensor parallelism: the sum over the rank mesh's 'model' group that the
Megatron column- and row-parallel linears (parallel/mesh.py:param_specs)
put inside their autograd Functions, and its count.

The JAX package shards its parameters over 'model' and lets GSPMD insert
the collectives: two all-reduces a transformer block forward. Here they
are explicit. A column-parallel linear (q, k, v, linear1) takes the
replicated input and returns this rank's columns: its forward is local,
its backward all-reduces the input gradient's partial product. A
row-parallel linear (out, linear2) takes this rank's columns and returns
the replicated output: its forward all-reduces the partial product, its
backward is local.

Rounding. ops/attention.py:_linear accumulates in fp32, adds the fp32
bias and rounds once to the compute type; in bf16 its backward rounds dx
once. Given a mesh and a kind, its Function sums the fp32 partial products
over 'model' before that one rounding: the row-parallel forward adds the
bias and rounds after the sum, the column-parallel backward rounds dx
after it. So bf16 at tp = 2 is tp = 1 up to the order of fp32 sums. The
reduction is one a column-parallel linear (no shared "f" operator on the
common input of q, k and v, which would round each linear's dx to bf16
before summing them in fp32, where tp = 1 sums them in bf16 as autograd
accumulates).
models/layers.py's FFN core puts the same two sums inside its own
Function (reduce_model_).

Counts: COLLECTIVES counts the 'model' all-reduces by kind, as
ops/kernels.LAUNCHES counts launches: 'forward' (one a row-parallel
linear: 2 an encoder layer, 3 a decoder layer), 'backward' (one a
column-parallel linear: 4 an encoder layer, 7 a decoder layer), and the
step's 'grad_norm' (one a step, training/optim.py:global_norm). A remat
recompute runs its forward's all-reduces again inside the backward.
"""

from __future__ import annotations

from collections import Counter

import torch

from neurosync_trainer_lite_tpu_torch.parallel.distributed import (
    all_reduce_sum_,
)

#: 'model' all-reduces by kind since the last reset_collectives()
COLLECTIVES: Counter = Counter()


def reset_collectives() -> None:
    COLLECTIVES.clear()


def reduce_model_(t: torch.Tensor, mesh, kind: str) -> torch.Tensor:
    """t ← its sum over the mesh's 'model' ranks, in place, counted under
    `kind`; a no-op without a mesh. A 'forward' sum runs on a copy of t: t
    is a product's output there, which remat_policy='dots' keeps for the
    recompute, and an in-place sum would hand the recompute the sum."""
    if mesh is None:
        return t
    COLLECTIVES[kind] += 1
    return all_reduce_sum_(t.clone() if kind == "forward" else t, mesh)

"""Rotary positional encodings (interleaved-pair convention), in PyTorch.

Port of neurosync_trainer_lite_tpu/ops/rope.py. Pairs are the interleaved
even/odd features, the base is 10000, and the angle of pair i at position p
is p * 10000**(-2i/d), with d the rotated width (d_model for the global
RoPE, head_dim for the per-head one). The rotation keeps full-width layouts:

    out = x * cos_full + roll(x, -1) * A + roll(x, +1) * B

with A = -sin on even lanes and B = +sin on odd lanes. Per-head RoPE runs
before the head split, with the head_dim tables tiled across the heads
(rope_qk_preheads), or on q and k already split into heads (rope_qk).

The tables are always fp32. CUDA tensors go through kernel K1
(ops/rope_kernel.py); CPU tensors through its plain version, which keeps
the kernel's fp32 math and single rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from neurosync_trainer_lite_tpu_torch.ops.rope_kernel import rope_rotate


@functools.lru_cache(maxsize=64)
def _rope_tables_np(seq_len: int, dim: int, tile: int = 1,
                    base: float = 10000.0):
    """Full-width (cos_full, sin_even, sin_odd) tables, [seq_len, dim*tile] fp32."""
    position = np.arange(seq_len, dtype=np.float32)[:, None]          # [T,1]
    dim_idx = np.arange(0, dim, 2, dtype=np.float32)                  # [d/2]
    inv_freq = np.exp(-np.log(base) * dim_idx / dim)[None, :]         # [1,d/2]
    angle = position * inv_freq                                       # [T,d/2]
    sin = np.sin(angle)
    cos_full = np.repeat(np.cos(angle), 2, axis=1)                    # [T,d]
    sin_even = np.zeros_like(cos_full)
    sin_odd = np.zeros_like(cos_full)
    sin_even[:, 0::2] = -sin      # multiplies roll(x,-1): x[2i+1] at even lanes
    sin_odd[:, 1::2] = sin        # multiplies roll(x,+1): x[2i]   at odd lanes
    if tile > 1:
        cos_full = np.tile(cos_full, (1, tile))
        sin_even = np.tile(sin_even, (1, tile))
        sin_odd = np.tile(sin_odd, (1, tile))
    return cos_full, sin_even, sin_odd


@functools.lru_cache(maxsize=64)
def _rope_tables_on(seq_len: int, dim: int, tile: int, device: torch.device):
    # the numpy tables may be float64 (numpy 2 promotion); they are cast to
    # fp32 once, as the JAX package's rope_tables casts them. They are built
    # as normal tensors even when the first caller runs in inference mode:
    # a training step that follows saves them for its backward.
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(t.astype(np.float32)).to(device)
                     for t in _rope_tables_np(seq_len, dim, tile))


def rope_tables(seq_len: int, dim: int, device, tile: int = 1):
    """(cos_full, sin_even, sin_odd) as fp32 [seq_len, dim*tile] on device."""
    return _rope_tables_on(seq_len, dim, tile, torch.device(device))


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotate interleaved pairs of the last dim. x [..., T, d']; tables [T, d']."""
    x3 =x.reshape((-1,) + tuple(x.shape[-2:])).contiguous()
    return rope_rotate(x3, *tables).reshape(x.shape)


def rope_embed(x: torch.Tensor) -> torch.Tensor:
    """'Global' RoPE over the full model dim. x [B, T, d_model]."""
    seq_len, d = x.shape[-2], x.shape[-1]
    return apply_rope(x, rope_tables(seq_len, d, x.device))


def rope_qk_preheads(q: torch.Tensor, k: torch.Tensor, num_heads: int):
    """'Local' per-head RoPE before the head split. q, k [B, T, H]."""
    head_dim = q.shape[-1] // num_heads
    tq = rope_tables(q.shape[-2], head_dim, q.device, tile=num_heads)
    tk = rope_tables(k.shape[-2], head_dim, k.device, tile=num_heads)
    return apply_rope(q, tq), apply_rope(k, tk)


def rope_qk(q: torch.Tensor, k: torch.Tensor):
    """Per-head RoPE on already-split q, k [B, n_heads, T, head_dim]."""
    d = q.shape[-1]
    return (apply_rope(q, rope_tables(q.shape[-2], d, q.device)),
            apply_rope(k, rope_tables(k.shape[-2], d, k.device)))

"""K2: the fused FFN backward (dh1, db2, db1).

Port of neurosync_trainer_lite_tpu/ops/ffn_bwd_pallas.py's ffn_bwd_dh1; its
ffn_lean_core_fused and ffn_fused are models/layers.py's FFN core with k2
and ffn_fused. The kernel is csrc/ffn_bwd.cu (its head note says what
bounds it on the H100 and how its design answers that):

    dh1 = where(am > 0, (dy · W) · scale, 0)   fp32, rounded once to dy's type
    db2 = Σ_rows dy                            fp32
    db1 = Σ_rows of the fp32 dh1, before its rounding

W is torch's linear2.weight [H, F], so dh1 = dy · W with no transpose (the
JAX kernel reads its [F, H] w2 "natively", contracting H). scale is the
fp32 inverted-dropout scale 256 / (256 - q): the forward's am was scaled by
its bf16 rounding, the epilogue multiplies by the unrounded value, as the
Pallas body does with its static Python float. CPU tensors take the plain
version; CUDA tensors launch the kernel (bf16 only) or raise.

As in the JAX package, no configuration reaches K2: the bf16 training step
goes through it where a caller routes the model's FFN through
models/layers.py's ffn_fused, by rebinding models/seq2seq.py's _ffn to it
(seq2seq._ffn = layers.ffn_fused), as tools/tpu_probe.py does for the JAX
model. Under tensor parallelism K2
needs no change: dh1 = dy·W2 takes the replicated dy and this rank's W2
[H, F/tp], and db2 = Σdy is the same on every 'model' rank, as a
replicated bias's gradient must be. The Pallas tile (FFN_BWD_BM) and its
bias-partial ablation (FFN_BWD_WITH_BIAS) are TPU tuning knobs and are
ported as semantics only: the kernel always writes the partials.
"""

from __future__ import annotations

import torch

from neurosync_trainer_lite_tpu_torch.ops import kernels
from neurosync_trainer_lite_tpu_torch.ops.attention import _mm_f32

#: rows of csrc/ffn_bwd.cu's output tile, so the partial sums' row count is
#: ceil(M / ROW_TILE); the kernel refuses any other
ROW_TILE = 128


def ffn_bwd_dh1_plain(dy, w2, am, *, scale: float):
    """dy [M, H], w2 [H, F], am [M, F] → (dh1 [M, F] in dy's type, db2 [H]
    fp32, db1 [F] fp32), with the kernel's rounding points."""
    dh1f = torch.where(am.float() > 0, _mm_f32(dy, w2) * scale, 0.0)
    return dh1f.to(dy.dtype), dy.float().sum(0), dh1f.sum(0)


def kernel_limits(ref):
    """Elementwise bounds on |kernel − plain| for a plain (dh1, db2, db1).
    dh1: one bf16 ulp of the plain value (2^-7 of it) plus 1e-5 of the
    largest, where the tensor cores' fp32 sums, taken in another order,
    round to the neighbouring bf16 value or cancel; the fp32 column sums:
    2e-4 of the largest (the same terms summed in another order)."""
    dh1, db2, db1 = (t.float() for t in ref)
    return (2.0 ** -7 * dh1.abs() + 1e-5 * dh1.abs().max(),
            2e-4 * db2.abs().max().expand_as(db2),
            2e-4 * db1.abs().max().expand_as(db1))


def ffn_bwd_dh1_cuda(dy, w2, am, *, scale: float):
    """Launch csrc/ffn_bwd.cu; raises on anything it does not take."""
    if not (dy.is_cuda and w2.device == dy.device and am.device == dy.device):
        raise ValueError("ffn_bwd_dh1 needs its tensors on one CUDA device")
    if not all(t.dtype == torch.bfloat16 for t in (dy, w2, am)):
        raise TypeError(f"ffn_bwd_dh1 (kernel K2) takes bf16, got "
                        f"{[t.dtype for t in (dy, w2, am)]}")
    if dy.dim() != 2 or w2.dim() != 2 or am.dim() != 2:
        raise ValueError("ffn_bwd_dh1: dy [M, H], w2 [H, F], am [M, F]")
    m, h = dy.shape
    f = w2.shape[1]
    if w2.shape != (h, f) or am.shape != (m, f):
        raise ValueError(f"ffn_bwd_dh1: shapes {tuple(dy.shape)}, "
                         f"{tuple(w2.shape)}, {tuple(am.shape)}")
    dy, w2, am = dy.contiguous(), w2.contiguous(), am.contiguous()
    dh1 = torch.empty(m, f, dtype=dy.dtype, device=dy.device)
    tiles = -(-m // ROW_TILE)
    db2p = torch.empty(tiles, h, dtype=torch.float32, device=dy.device)
    db1p = torch.empty(tiles, f, dtype=torch.float32, device=dy.device)
    status = kernels.library("ffn_bwd").ffn_bwd_dh1(
        dy.data_ptr(), w2.data_ptr(), am.data_ptr(), dh1.data_ptr(),
        db2p.data_ptr(), db1p.data_ptr(), m, h, f, tiles, float(scale),
        torch.cuda.current_stream(dy.device).cuda_stream)
    kernels.check_launch(status, "ffn_bwd_dh1")
    return dh1, db2p.sum(0), db1p.sum(0)


def ffn_bwd_dh1(dy, w2, am, *, scale: float):
    """The fused (dh1, db2, db1): the plain version on CPU tensors, the
    kernel on CUDA tensors."""
    if dy.device.type == "cpu":
        return ffn_bwd_dh1_plain(dy, w2, am, scale=scale)
    return ffn_bwd_dh1_cuda(dy, w2, am, scale=scale)

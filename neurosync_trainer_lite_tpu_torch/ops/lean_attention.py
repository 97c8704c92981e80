"""The bf16 training attention core as a pair of CUDA kernels: their shape
gate and their ctypes wrappers.

Training in bf16 runs every attention site's core through
ops/attention.py:_SdpaLeanCore, the port of the JAX package's
_sdpa_lean_core: softmax(q·kᵀ·c) with weight dropout, times v, keeping only
(q, k, v) and the dropout seed for its backward, which recomputes the rest.
The kernels are csrc/lean_attention.cu (its head note says what bounds them
on the H100 and how their design answers that). Their plain pair,
attention.lean_attention_plain_fwd / _bwd, is the contract in PyTorch ops,
with JAX's rounding points: c = bf16(h^-0.5),
r = bf16(256 / (256 - q)), keep = bits >= q over the uint8 bits of
attention.dropout_bits (q = 0 drops nothing),

    forward   s = bf16(bf16(q·kᵀ)·c), w = bf16(softmax_fp32(s)),
              wd = keep ? bf16(w·r) : 0, out = bf16(wd·v)
    backward  w, wd recomputed; dv = bf16(wdᵀ·dout);
              dw = bf16(dout·vᵀ), then keep ? bf16(dw·r) : 0;
              ds = bf16(bf16(w·(dw − Σ dw·w))·c) in fp32 from the bf16 values;
              dq = bf16(ds·k), dk = bf16(dsᵀ·q)

The plain pair is what a CPU tensor gets, what a CUDA tensor outside
`supports` gets, and what the kernels are held against on the card: their
row sums and products sum in another order than PyTorch's softmax and
cuBLAS's, so an element may lie a bf16 ulp from plain's. Both draw the
same bits from the seed, so they drop the same elements.

One stated dispatch difference: the kernels hold whole key rows in a block,
so they take Tq, Tk <= MAX_LEN and the head widths of fa.HEAD_DIMS; longer
windows would want K3's online-softmax tiling, a different kernel, and take
the plain pair on the card too.
"""

from __future__ import annotations

import ctypes

import torch

from neurosync_trainer_lite_tpu_torch.ops import flash_attention as fa
from neurosync_trainer_lite_tpu_torch.ops import kernels

#: the longest query or key strip the kernels take (a block holds it whole)
MAX_LEN = 128


def supports(tq: int, tk: int, head_dim: int) -> bool:
    """Whether the kernels take these shapes: 1..MAX_LEN queries and keys,
    a head width of fa.HEAD_DIMS (multiples of 16 up to 128)."""
    return 1 <= tq <= MAX_LEN and 1 <= tk <= MAX_LEN and head_dim in fa.HEAD_DIMS


def takes_kernel(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the kernels run this core: bf16 CUDA tensors of shapes they
    take. Anything else takes the plain pair."""
    return (q.is_cuda and q.dtype == torch.bfloat16
            and supports(q.shape[-2], k.shape[-2], q.shape[-1]))


def _fits(t: torch.Tensor) -> bool:
    """t as the kernels load it: last stride 1, the others multiples of 8
    elements, the data on a 16-byte boundary."""
    return (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def kernel_view(t: torch.Tensor) -> torch.Tensor:
    """t itself where the kernels load it as it lies (the head split's
    views do), else a contiguous aligned copy."""
    return t if _fits(t) else kernels.aligned16(t)


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def _check(q, k, v, dout, bits, qthresh) -> tuple[int, int, int, int, int]:
    """Raise on what the kernels do not take; return (B, n, Tq, Tk, h)."""
    named = [("q", q), ("k", k), ("v", v)] + ([("dout", dout)]
                                              if dout is not None else [])
    for name, t in named:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"lean_attention: {name} must be bf16, got "
                            f"{t.dtype}")
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"lean_attention: {name} must be a CUDA tensor "
                             f"on {q.device}, got {t.device}")
        if t.dim() != 4:
            raise ValueError(f"lean_attention: {name} must be [B, n, T, h], "
                             f"got {tuple(t.shape)}")
        if not _fits(t):
            raise ValueError(f"lean_attention: {name} needs a last stride of "
                             f"1, other strides that are multiples of 8 and "
                             f"16-byte aligned data, got strides {t.stride()}")
    B, n, tq, h = q.shape
    tk = k.shape[2]
    if k.shape != (B, n, tk, h) or v.shape != k.shape or (
            dout is not None and dout.shape != q.shape):
        raise ValueError(f"lean_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if not supports(tq, tk, h):
        raise ValueError(f"lean_attention: Tq {tq}, Tk {tk}, h {h}: the "
                         f"kernels take 1..{MAX_LEN} and widths "
                         f"{fa.HEAD_DIMS}")
    if not 0 <= qthresh < 256:
        raise ValueError(f"lean_attention: threshold {qthresh} not in 0..255")
    if (bits is None) != (qthresh == 0):
        raise ValueError("lean_attention: bits are given exactly where the "
                         "threshold is above 0")
    if bits is not None and (bits.dtype != torch.uint8
                             or bits.shape != (B, n, tq, tk)
                             or bits.device != q.device
                             or bits.stride(-1) != 1):
        raise ValueError(f"lean_attention: bits must be uint8 [{B}, {n}, "
                         f"{tq}, {tk}] on {q.device} with a last stride of 1")
    return B, n, tq, tk, h


def _scales(scale: float, qthresh: int) -> tuple[float, float]:
    """(c, r) rounded to bf16, as attention._bf16_value rounds them."""
    r = 256.0 / (256 - qthresh) if qthresh else 1.0
    return (float(torch.tensor(scale, dtype=torch.bfloat16)),
            float(torch.tensor(r, dtype=torch.bfloat16)))


def _bits_arg(bits):
    if bits is None:
        return None, None
    return bits.data_ptr(), _strides(bits)


def lean_attention_fwd_cuda(q, k, v, bits, scale: float, qthresh: int):
    """Launch nsync_lattn_fwd on CUDA tensors; raises on anything it does not
    take. Returns out [B, n, Tq, h] as a view of a [B, Tq, n, h]-contiguous
    buffer, so that merging the heads copies nothing."""
    B, n, tq, tk, h = _check(q, k, v, None, bits, qthresh)
    out = torch.empty(B, tq, n, h, dtype=q.dtype, device=q.device)
    if B * n == 0:
        return out.transpose(1, 2)
    c, r = _scales(scale, qthresh)
    bits_ptr, bits_strides = _bits_arg(bits)
    status = kernels.library("lean_attention").lean_attention_fwd(
        q.data_ptr(), _strides(q), k.data_ptr(), _strides(k), v.data_ptr(),
        _strides(v), bits_ptr, bits_strides, out.data_ptr(), B, n, tq, tk, h,
        c, qthresh, r, torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(status, "lean_attention_fwd")
    return out.transpose(1, 2)


def lean_attention_bwd_cuda(dout, q, k, v, bits, scale: float, qthresh: int):
    """Launch nsync_lattn_bwd on CUDA tensors; raises on anything it does not
    take. Returns (dq, dk, dv), each a [B, n, T, h] view of a [B, T, n, h]
    buffer."""
    B, n, tq, tk, h = _check(q, k, v, dout, bits, qthresh)
    dq = torch.empty(B, tq, n, h, dtype=q.dtype, device=q.device)
    dk = torch.empty(B, tk, n, h, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if B * n > 0:
        c, r = _scales(scale, qthresh)
        bits_ptr, bits_strides = _bits_arg(bits)
        status = kernels.library("lean_attention").lean_attention_bwd(
            q.data_ptr(), _strides(q), k.data_ptr(), _strides(k),
            v.data_ptr(), _strides(v), dout.data_ptr(), _strides(dout),
            bits_ptr, bits_strides, dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, n, tq, tk, h, c, qthresh, r,
            torch.cuda.current_stream(q.device).cuda_stream)
        kernels.check_launch(status, "lean_attention_bwd")
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)

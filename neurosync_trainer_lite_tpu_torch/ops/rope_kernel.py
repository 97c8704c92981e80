"""K1: the full-width RoPE rotation, as a CUDA kernel and its plain version.

Port of neurosync_trainer_lite_tpu/ops/rope_pallas.py:rope_rotate. The kernel
is csrc/rope.cu (its head note says what bounds it on the H100 and how its
design answers that). The plain version below is the TPU kernel's contract
in PyTorch ops: fp32 math, one rounding to x's type. It is what a CPU tensor
gets, and what the kernel is held against on the card (bitwise).

    forward    out = x*cos + roll(x, -1)*a + roll(x, +1)*b
    transpose  out = cos*y + roll(a*y, +1) + roll(b*y, -1)

The rolls are circular over the last dimension, for any tables.
"""

from __future__ import annotations

import torch

from neurosync_trainer_lite_tpu_torch.ops import kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the widest row rope_rotate_cuda takes (12,288 columns), part of its
#: interface; the kernel itself keeps no row in shared memory
MAX_WIDTH = 48 * 1024 // 4


def rope_rotate_plain(x: torch.Tensor, cos: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """x [B, T, d]; cos/a/b fp32 [T, d] → rotated x, fp32 math, x.dtype out."""
    xf = x.float()
    if transpose:
        o = xf * cos + torch.roll(xf * a, 1, -1) + torch.roll(xf * b, -1, -1)
    else:
        o = xf * cos + torch.roll(xf, -1, -1) * a + torch.roll(xf, 1, -1) * b
    return o.to(x.dtype)


def rope_rotate_cuda(x: torch.Tensor, cos: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Launch csrc/rope.cu on CUDA tensors; raises on anything it does not take."""
    if not x.is_cuda:
        raise ValueError(f"rope_rotate_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"rope_rotate: unsupported dtype {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"rope_rotate: x must be [B, T, d], got {tuple(x.shape)}")
    _, t_len, d = x.shape
    if d > MAX_WIDTH:
        raise ValueError(f"rope_rotate: width {d} exceeds {MAX_WIDTH}")
    for name, tab in (("cos", cos), ("a", a), ("b", b)):
        if (tab.dtype != torch.float32 or tab.shape != (t_len, d)
                or tab.device != x.device or not tab.is_contiguous()):
            raise ValueError(f"rope_rotate: table {name} must be contiguous fp32 "
                             f"[{t_len}, {d}] on {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = kernels.library("rope")
    status = lib.rope_rotate(
        x.data_ptr(), cos.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
        x.shape[0] * t_len, t_len, d, int(transpose), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check_launch(status, "rope_rotate")
    return out


def _rotate(x, cos, a, b, transpose: bool):
    if x.device.type == "cpu":
        return rope_rotate_plain(x, cos, a, b, transpose)
    return rope_rotate_cuda(x, cos, a, b, transpose)


class _RopeRotate(torch.autograd.Function):
    """The rotation with its transpose as the backward (rope_pallas.py:66-81)."""

    @staticmethod
    def forward(ctx, x, cos, a, b):
        ctx.save_for_backward(cos, a, b)
        return _rotate(x, cos, a, b, False)

    @staticmethod
    def backward(ctx, dy):
        cos, a, b = ctx.saved_tensors
        return _rotate(dy.contiguous(), cos, a, b, True), None, None, None


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """x [B, T, d], tables [T, d] fp32 → rotated x. CUDA tensors launch the
    kernel, CPU tensors take the plain version; the forward is differentiable."""
    if transpose:
        return _rotate(x, cos, a, b, True)
    return _RopeRotate.apply(x, cos, a, b)

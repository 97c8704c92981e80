"""K4: RoPE + per-head scores, softmax and ·v on unsplit [B, T, H], with its
backward.

Port of neurosync_trainer_lite_tpu/ops/fused_attention.py (_fwd_kernel,
_bwd_kernel, the custom VJP fused_rope_attention, make_tables). Both kernels
are in csrc/fused_attention.cu (its head note says what bounds them on the
H100 and how their design answers that). The plain versions below mirror
the Pallas bodies: rotate q and k over the full H row in fp32, then per head
softmax(q·kᵀ·scale)·v in fp32, written once in v's type; the backward
recomputes p, runs the softmax-attention VJP per head in fp32, applies the
transpose rotation to dq and dk and rounds each output once.

The Pallas kernel's VMEM gates (fits_vmem, _rows_per_cell) become one
shared-memory gate, fits_smem. Like fits_vmem it budgets the backward, the
larger of the two kernels, so that a shape whose backward cannot launch
never takes the forward in training. multi_head_attention checks it before
dispatch, on every device, so the CPU and the card take the same branch.
"""

from __future__ import annotations

import torch

from neurosync_trainer_lite_tpu_torch.ops import kernels
from neurosync_trainer_lite_tpu_torch.ops.rope import rope_tables
from neurosync_trainer_lite_tpu_torch.ops.rope_kernel import (
    rope_rotate_cuda,
    rope_rotate_plain,
)

#: shared memory one block may use on Hopper (232,448 bytes, opt-in above 48 KB)
SMEM_BUDGET = 232_448
#: head widths csrc/fused_attention.cu is instantiated for
HEAD_DIMS = (16, 32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fwd_smem_bytes(tk: int, head_dim: int) -> int:
    """A forward block: the head's rotated K and its V, fp32."""
    return 2 * tk * head_dim * 4


def bwd_smem_bytes(tq: int, tk: int, head_dim: int, itemsize: int) -> int:
    """A backward block: rotated Q and K (fp32), V and dO (input type), and
    three fp32 statistics per query row (csrc bwd_smem_bytes)."""
    return (tq + tk) * head_dim * (4 + itemsize) + 3 * tq * 4


def fits_smem(tq: int, tk: int, head_dim: int, itemsize: int) -> bool:
    """Can one block of the forward and of the backward hold its head?"""
    return head_dim in HEAD_DIMS and max(
        fwd_smem_bytes(tk, head_dim),
        bwd_smem_bytes(tq, tk, head_dim, itemsize)) <= SMEM_BUDGET


def make_tables(tq: int, tk: int, head_dim: int, num_heads: int, device):
    """The 6 fp32 tables: (cos, a, b) for q [Tq, H], then for k [Tk, H]."""
    return (*rope_tables(tq, head_dim, device, tile=num_heads),
            *rope_tables(tk, head_dim, device, tile=num_heads))


def _rot(x, cos, a, b):
    return x * cos + torch.roll(x, -1, -1) * a + torch.roll(x, 1, -1) * b


def fused_rope_attention_plain(q, k, v, tables, num_heads: int,
                               scale: float) -> torch.Tensor:
    """q [B, Tq, H], k, v [B, Tk, H] → [B, Tq, H] in v.dtype, fp32 inside."""
    qf = _rot(q.float(), *tables[:3])
    kf = _rot(k.float(), *tables[3:])
    vf = v.float()
    hd = q.shape[-1] // num_heads
    out = torch.empty_like(qf)
    for h in range(num_heads):
        sl = slice(h * hd, (h + 1) * hd)
        s = torch.matmul(qf[..., sl], kf[..., sl].transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1)
        out[..., sl] = torch.matmul(p, vf[..., sl])
    return out.to(v.dtype)


def fused_rope_attention_bwd_plain(q, k, v, do, tables, num_heads: int,
                                   scale: float):
    """The VJP of fused_rope_attention_plain as _bwd_kernel computes it:
    (dq, dk, dv) in the inputs' types, fp32 inside."""
    qf = _rot(q.float(), *tables[:3])
    kf = _rot(k.float(), *tables[3:])
    vf, dof = v.float(), do.float()
    hd = q.shape[-1] // num_heads
    dq, dk, dv = torch.empty_like(qf), torch.empty_like(kf), torch.empty_like(vf)
    for h in range(num_heads):
        sl = slice(h * hd, (h + 1) * hd)
        s = torch.matmul(qf[..., sl], kf[..., sl].transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1)
        doh = dof[..., sl]
        dv[..., sl] = torch.matmul(p.transpose(-1, -2), doh)
        dp = torch.matmul(doh, vf[..., sl].transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dq[..., sl] = torch.matmul(ds, kf[..., sl]) * scale
        dk[..., sl] = torch.matmul(ds.transpose(-1, -2), qf[..., sl]) * scale
    # the transpose rotation (_rot_t) in fp32, then one rounding
    dq = rope_rotate_plain(dq, *tables[:3], transpose=True)
    dk = rope_rotate_plain(dk, *tables[3:], transpose=True)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_inputs(name, q, k, v, tables, num_heads, more=()):
    """Raise on anything csrc/fused_attention.cu does not take (the forward
    with `more` empty, the backward with `more` = (dO,))."""
    if not (q.is_cuda and all(t.device == q.device for t in (k, v, *more))):
        raise ValueError(f"{name} needs its tensors on one CUDA device")
    if not (all(t.dtype == q.dtype for t in (k, v, *more))
            and q.dtype in _DTYPE_CODE):
        raise TypeError(f"{name}: unsupported dtypes "
                        f"{[t.dtype for t in (q, k, v, *more)]}")
    batch, tq, width = q.shape
    tk = k.shape[1]
    if (k.shape != (batch, tk, width) or v.shape != k.shape
            or any(t.shape != q.shape for t in more)):
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    head_dim = width // num_heads
    smem = (bwd_smem_bytes(tq, tk, head_dim, q.element_size()) if more
            else fwd_smem_bytes(tk, head_dim))
    if width % num_heads or head_dim not in HEAD_DIMS or smem > SMEM_BUDGET:
        raise ValueError(f"{name}: Tq={tq}, Tk={tk}, H={width}, "
                         f"heads={num_heads} fail the shared-memory gate")
    if len(tables) != 6:
        raise ValueError(f"{name}: expected 6 tables")
    for n, tab in enumerate(tables):
        rows = tq if n < 3 else tk
        if (tab.dtype != torch.float32 or tab.shape != (rows, width)
                or tab.device != q.device or not tab.is_contiguous()):
            raise ValueError(f"{name}: table {n} must be contiguous fp32 "
                             f"[{rows}, {width}] on {q.device}")
    return batch, tq, tk, width


def fused_rope_attention_cuda(q, k, v, tables, num_heads: int,
                              scale: float) -> torch.Tensor:
    """Launch the forward kernel; raises on anything it does not take."""
    batch, tq, tk, width = _check_inputs("fused_rope_attention", q, k, v,
                                         tables, num_heads)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = kernels.library("fused_attention")
    status = lib.fused_rope_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *(t.data_ptr() for t in tables), out.data_ptr(),
        batch, tq, tk, width, num_heads, float(scale),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(status, "fused_rope_attention")
    return out


def fused_rope_attention_bwd_cuda(q, k, v, do, tables, num_heads: int,
                                  scale: float):
    """Launch the backward kernel (bf16: the tensor-core one, fp32: the
    CUDA-core one), then the transpose rotation of dq and dk (K1 on the
    kernel's fp32 workspaces) and one rounding each."""
    batch, tq, tk, width = _check_inputs("fused_rope_attention_bwd", q, k, v,
                                         tables, num_heads, more=(do,))
    q, k, v, do = (kernels.aligned16(t) for t in (q, k, v, do))
    dq_rot = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk_rot = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(v)
    if dv.numel() == 0 or dq_rot.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    lib = kernels.library("fused_attention")
    status = lib.fused_rope_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        *(t.data_ptr() for t in tables), dq_rot.data_ptr(), dk_rot.data_ptr(),
        dv.data_ptr(), batch, tq, tk, width, num_heads, float(scale),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(status, "fused_rope_attention_bwd")
    dq = rope_rotate_cuda(dq_rot, *tables[:3], transpose=True).to(q.dtype)
    dk = rope_rotate_cuda(dk_rot, *tables[3:], transpose=True).to(k.dtype)
    return dq, dk, dv


class _FusedRopeAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its VJP; saves
    (q, k, v) and the tables, as _vjp_fwd does."""

    @staticmethod
    def forward(ctx, q, k, v, tables, num_heads, scale):
        ctx.save_for_backward(q, k, v, *tables)
        ctx.num_heads, ctx.scale = num_heads, scale
        if q.device.type == "cpu":
            return fused_rope_attention_plain(q, k, v, tables, num_heads, scale)
        return fused_rope_attention_cuda(q, k, v, tables, num_heads, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, *tables = ctx.saved_tensors
        bwd = (fused_rope_attention_bwd_plain if q.device.type == "cpu"
               else fused_rope_attention_bwd_cuda)
        dq, dk, dv = bwd(q, k, v, do, tables, ctx.num_heads, ctx.scale)
        return dq, dk, dv, None, None, None


def fused_rope_attention(q, k, v, tables, num_heads: int,
                         scale: float) -> torch.Tensor:
    """Differentiable in q, k and v. CUDA tensors launch the kernels, CPU
    tensors take the plain versions."""
    return _FusedRopeAttention.apply(q, k, v, tuple(tables), num_heads, scale)

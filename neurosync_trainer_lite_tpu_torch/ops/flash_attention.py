"""K3: non-causal flash attention over [B, N, T, h], forward and backward.

Port of neurosync_trainer_lite_tpu/ops/flash_attention.py (_fwd_kernel,
_bwd_kernel, the custom VJP flash_attention, supports). The kernels are in
csrc/flash_attention.cu (its head note says what bounds them on the H100 and
how their design answers that). The plain versions below keep the Pallas
bodies' rounding points:

- forward: s = q·kᵀ in fp32 times scale, max, exp and normalise in fp32,
  the normalised p rounded to v's type, p·v accumulated in fp32, the output
  rounded once;
- backward: p recomputed in fp32 and left unrounded, dv = pᵀ·dO,
  dp = dO·vᵀ, ds = p·(dp − Σ dp·p), dq = ds·k·scale, dk = dsᵀ·q·scale, all
  fp32, each output rounded once to its input's type.

On the card bf16 runs every product on the tensor cores: q·kᵀ, dO·vᵀ and the
forward's rounded p·v as bf16 products, the backward's fp32 p and ds split
into bf16(x) + bf16(x − bf16(x)) for pᵀ·dO, ds·k and dsᵀ·q (two bf16
products into one fp32 sum; the other operand is a bf16 input, so exact).
fp32 runs on the CUDA cores.

Only (q, k, v) are kept for the backward, as _vjp_fwd does; the backward
recomputes the softmax statistics. CPU tensors take the plain versions,
CUDA tensors launch the kernels, which take head widths HEAD_DIMS: every
multiple of 16 up to 128, what mma.sync's k = 16 and ldmatrix's 16-column
loads tile. supports(head_dim=...) declines other widths, which then take
the composed path where the JAX kernel takes any width: the one dispatch
difference from the JAX package.
"""

from __future__ import annotations

import torch

from neurosync_trainer_lite_tpu_torch.ops import kernels

#: the JAX kernel keeps the whole K/V strip in VMEM up to this key length;
#: both packages take the composed path above it
MAX_KV_LEN = 2048
#: 'auto' dispatches here from this key length (JAX flash_attention.py:37)
MIN_KV_LEN_AUTO = 512
#: head widths csrc/flash_attention.cu is instantiated for
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def supports(kv_len: int, dropout_rate: float, seed,
             head_dim: int | None = None) -> bool:
    """Whether the kernel path applies (no attention dropout, K/V at most
    MAX_KV_LEN), as the JAX supports(); given a head width, also whether the
    kernels take it (HEAD_DIMS), which the JAX kernel does not ask."""
    return ((dropout_rate == 0.0 or seed is None) and kv_len <= MAX_KV_LEN
            and (head_dim is None or head_dim in HEAD_DIMS))


def _probs(qf, kf, scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale) in fp32, normalised by division as the Pallas body."""
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def flash_attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """q [B, N, Tq, h], k, v [B, N, Tk, h] → [B, N, Tq, h] in v's type."""
    p = _probs(q.float(), k.float(), scale)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def flash_attention_bwd_plain(q, k, v, do, scale: float):
    """The VJP as _bwd_kernel computes it: (dq, dk, dv) in the inputs' types."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = _probs(qf, kf, scale)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def kernel_limit(ref: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Elementwise bound on |kernel − plain| for a plain result `ref`.

    bf16: one bf16 ulp of the plain value (2^-7 of it), plus 2^-9 of the
    largest value where a normalised p, rounded to bf16 after a sum taken in
    another order, falls to the neighbouring bf16 value (forward), or a
    cancelling sum carries its terms' fp32 rounding (backward). fp32: 1e-5
    of the largest value (sums in another order)."""
    ref = ref.float()
    if dtype == torch.bfloat16:
        return 2.0 ** -7 * ref.abs() + 2.0 ** -9 * ref.abs().max()
    return 1e-5 * ref.abs().max() + 1e-30


def _check_inputs(name, q, k, v, more=()):
    """Raise on anything csrc/flash_attention.cu does not take (the forward
    with `more` empty, the backward with `more` = (dO,)); returns
    (B·N, Tq, Tk, h)."""
    if not (q.is_cuda and all(t.device == q.device for t in (k, v, *more))):
        raise ValueError(f"{name} needs its tensors on one CUDA device")
    if not (all(t.dtype == q.dtype for t in (k, v, *more))
            and q.dtype in _DTYPE_CODE):
        raise TypeError(f"{name}: unsupported dtypes "
                        f"{[t.dtype for t in (q, k, v, *more)]}")
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, N, T, h], got {tuple(q.shape)}")
    batch, heads, tq, head_dim = q.shape
    tk = k.shape[2]
    if (k.shape != (batch, heads, tk, head_dim) or v.shape != k.shape
            or any(t.shape != q.shape for t in more)):
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{name} (kernel K3) takes head widths {HEAD_DIMS}, "
                         f"got {head_dim}")
    return batch * heads, tq, tk, head_dim


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_cuda(q, k, v, scale: float) -> torch.Tensor:
    """Launch the forward kernel; raises on anything it does not take."""
    bn, tq, tk, head_dim = _check_inputs("flash_attention", q, k, v)
    q, k, v = (kernels.aligned16(t) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    status = kernels.library("flash_attention").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bn, tq, tk,
        head_dim, float(scale), _DTYPE_CODE[q.dtype], _stream(q))
    kernels.check_launch(status, "flash_attention")
    return out


def flash_attention_bwd_cuda(q, k, v, do, scale: float):
    """Launch the two backward kernels: per query tile the row statistics,
    D and dq; then per key tile dk and dv from those statistics, which pass
    through fp32 workspaces [B·N, Tq]. Every sum has one owner: no atomics."""
    bn, tq, tk, head_dim = _check_inputs("flash_attention_bwd", q, k, v,
                                         more=(do,))
    q, k, v, do = (kernels.aligned16(t) for t in (q, k, v, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty(3, bn, tq, dtype=torch.float32, device=q.device)
    lib = kernels.library("flash_attention")
    common = (bn, tq, tk, head_dim, float(scale), _DTYPE_CODE[q.dtype],
              _stream(q))
    status = lib.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        stats.data_ptr(), dq.data_ptr(), *common)
    kernels.check_launch(status, "flash_attention_bwd_dq")
    status = lib.flash_attention_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        stats.data_ptr(), dk.data_ptr(), dv.data_ptr(), *common)
    kernels.check_launch(status, "flash_attention_bwd_dkdv")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernels as its VJP; saves only
    (q, k, v), as _vjp_fwd does."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, scale)
        return flash_attention_cuda(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        bwd = (flash_attention_bwd_plain if q.device.type == "cpu"
               else flash_attention_bwd_cuda)
        dq, dk, dv = bwd(q, k, v, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: float | None = None) -> torch.Tensor:
    """q [B, N, Tq, h], k, v [B, N, Tk, h] → [B, N, Tq, h]; softmax in fp32,
    non-causal, differentiable in q, k and v. scale=None means h ** -0.5."""
    s = scale if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, s)

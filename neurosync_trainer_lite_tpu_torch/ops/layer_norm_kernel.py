"""The bf16 LayerNorm as a pair of CUDA kernels, and its plain version.

The model's bf16 LayerNorm (models/layers.py:_LayerNormBf16, the port of
the JAX package's _layer_norm_bf16) keeps only x and the per-row fp32 mean
and rsqrt for its backward. The kernels are csrc/layer_norm.cu (its head
note says what bounds them on the H100 and how their design answers that).
The plain version below is the contract in PyTorch ops, fp32 math with one
rounding to bf16:

    forward   mean = mean(x), var = mean((x - mean)^2), r = rsqrt(var + eps)
              out = (x - mean) * r * weight + bias
    backward  y = (x - mean) * r, dy = dout * weight
              dx = r * (dy - mean(dy) - y * mean(dy * y))
              dweight = sum(dout * y), dbias = sum(dout) over the rows

It is what a CPU tensor gets, and what the kernels are held against on the
card: their row sums run in another order
than PyTorch's reductions, so an output may lie one bf16 ulp from plain's.
"""

from __future__ import annotations

import torch

from neurosync_trainer_lite_tpu_torch.ops import kernels

#: the model's LayerNorm epsilon, also csrc/layer_norm.cu's kEps
EPS = 1e-5
#: the widest row the kernels take (1,024 columns, the model's: a warp's 32
#: lanes hold 32 values each in registers), part of their interface; the
#: wrappers refuse wider rows
MAX_WIDTH = 1024


def layer_norm_plain_fwd(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor):
    """x [..., H] bf16; weight, bias fp32 [H] → (out [..., H] in x.dtype,
    mean [..., 1], r [..., 1] fp32)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + EPS)
    return ((xf - mean) * r * weight + bias).to(x.dtype), mean, r


def layer_norm_plain_bwd(dout: torch.Tensor, x: torch.Tensor,
                         mean: torch.Tensor, r: torch.Tensor,
                         weight: torch.Tensor):
    """The forward's residuals and dout [..., H] → (dx in x.dtype, dweight
    [H], dbias [H] fp32)."""
    y = (x.float() - mean) * r
    df = dout.float()
    width = df.shape[-1]
    dweight = (df * y).reshape(-1, width).sum(0)
    dbias = df.reshape(-1, width).sum(0)
    dy = df * weight
    m1 = dy.mean(dim=-1, keepdim=True)
    m2 = (dy * y).mean(dim=-1, keepdim=True)
    return (r * (dy - m1 - y * m2)).to(x.dtype), dweight, dbias


def _check(x: torch.Tensor, name: str = "x") -> int:
    """Raise on what the kernels do not take; return the width."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"layer_norm: {name} must be bf16, got {x.dtype}")
    width = x.shape[-1] if x.dim() else 0
    if not 0 < width <= MAX_WIDTH:
        raise ValueError(f"layer_norm: width {width} is not in 1..{MAX_WIDTH}")
    if not x.is_cuda:
        raise ValueError(f"layer_norm: {name} must be a CUDA tensor, got "
                         f"{x.device}")
    return width


def _check_vector(t: torch.Tensor, name: str, numel: int, device) -> None:
    if (t.dtype != torch.float32 or t.numel() != numel or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"layer_norm: {name} must be contiguous fp32 with "
                         f"{numel} elements on {device}")


def layer_norm_fwd_cuda(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor):
    """Launch nsync_ln_fwd on CUDA tensors; raises on anything it does not
    take. Returns what layer_norm_plain_fwd returns."""
    width = _check(x)
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dim() != 1:
            raise ValueError(f"layer_norm: {name} must be [{width}]")
        _check_vector(p, name, width, x.device)
    x = x.contiguous()
    rows = x.numel() // width
    out = torch.empty_like(x)
    mean = torch.empty(*x.shape[:-1], 1, device=x.device)
    r = torch.empty_like(mean)
    if rows == 0:
        return out, mean, r
    status = kernels.library("layer_norm").layer_norm_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        mean.data_ptr(), r.data_ptr(), rows, width,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check_launch(status, "layer_norm_fwd")
    return out, mean, r


def layer_norm_bwd_cuda(dout: torch.Tensor, x: torch.Tensor,
                        mean: torch.Tensor, r: torch.Tensor,
                        weight: torch.Tensor):
    """Launch nsync_ln_bwd and nsync_ln_bwd_params on CUDA tensors; raises on
    anything they do not take. Returns what layer_norm_plain_bwd returns."""
    _check(dout, "dout")
    width = _check(x)
    if dout.shape != x.shape:
        raise ValueError(f"layer_norm: dout {tuple(dout.shape)} and x "
                         f"{tuple(x.shape)} differ")
    rows = x.numel() // width
    for name, t, n in (("mean", mean, rows), ("r", r, rows),
                       ("weight", weight, width)):
        _check_vector(t, name, n, x.device)
    x, dout = x.contiguous(), dout.contiguous()
    dx = torch.empty_like(x)
    if rows == 0:
        zeros = torch.zeros(width, device=x.device)
        return dx, zeros, zeros.clone()
    dweight = torch.empty(width, device=x.device)
    dbias = torch.empty(width, device=x.device)
    lib = kernels.library("layer_norm")
    blocks = lib.layer_norm_bwd_blocks(rows, width)
    part = torch.empty(blocks, 2, width, device=x.device)
    status = lib.layer_norm_bwd(
        x.data_ptr(), dout.data_ptr(), mean.data_ptr(), r.data_ptr(),
        weight.data_ptr(), dx.data_ptr(), part.data_ptr(), dweight.data_ptr(),
        dbias.data_ptr(), rows, width, blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check_launch(status, "layer_norm_bwd")
    return dx, dweight, dbias


def takes_kernel(x) -> bool:
    """Whether the kernels run x: every CUDA tensor, and the wrappers raise
    on one they do not take; a CPU tensor takes the plain version."""
    return x.device.type == "cuda"


def layer_norm_fwd(x, weight, bias):
    """The forward: the kernel for a CUDA tensor, plain for a CPU one."""
    if takes_kernel(x):
        return layer_norm_fwd_cuda(x, weight, bias)
    return layer_norm_plain_fwd(x, weight, bias)


def layer_norm_bwd(dout, x, mean, r, weight):
    """The backward, routed as layer_norm_fwd."""
    if takes_kernel(x):
        return layer_norm_bwd_cuda(dout, x, mean, r, weight)
    return layer_norm_plain_bwd(dout, x, mean, r, weight)

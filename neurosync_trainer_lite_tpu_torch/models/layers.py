"""The building blocks both architectures share: the fp32-accumulating
Linear, the LayerNorm, the FFN and the remat runner.

- Linear: weight [out, in] and bias [out] through ops/attention.py:_linear
  (fp32 accumulation, one rounding; under a mesh, a Megatron column- or
  row-parallel block).
- LayerNorm: fp32 math rounded once; in bf16 an autograd Function with JAX's
  lean residuals (_layer_norm_bf16), a pair of CUDA kernels on the card
  (csrc/layer_norm.cu, ops/layer_norm_kernel.py); fp32 keeps plain
  autograd, as in JAX.
- ffn: linear → ReLU or exact GELU → dropout → linear. bf16 training takes
  one Function (_FfnCore) that draws its dropout bits from the seed and
  keeps one activation-sized residual; the passes over its hidden width
  between the two products are one kernel each way on the card
  (csrc/ffn_epilogue.cu, ops/ffn_epilogue.py); ffn_fused routes the
  Seq2Seq's ReLU FFN backward through kernel K2 (ops/ffn_bwd.py).
- run_layers: the layer loop, with cfg.remat (remat_scope, remat_layers,
  remat_policy): the first remat_layers layers of each stack in scope run
  under torch.utils.checkpoint and are recomputed in the backward; 'dots'
  keeps the matrix products' outputs and recomputes the rest.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.ops import ffn_bwd
from neurosync_trainer_lite_tpu_torch.ops.attention import (
    _linear,
    _mm_f32,
    dropout,
    dropout_bits,
    dropout_mask_q,
)
from neurosync_trainer_lite_tpu_torch.ops.ffn_epilogue import (
    ACTIVATIONS,
    ffn_epi_bwd,
    ffn_epi_fwd,
)
from neurosync_trainer_lite_tpu_torch.ops.layer_norm_kernel import (
    EPS as _LN_EPS,
    layer_norm_bwd,
    layer_norm_fwd,
)
from neurosync_trainer_lite_tpu_torch.parallel.mesh import model_sharded
from neurosync_trainer_lite_tpu_torch.parallel.tensor import reduce_model_


class Linear(nn.Module):
    """weight [out, in] and bias [out], applied with one rounding (_linear);
    under a mesh that shards the model, this rank's block of a 'column' or
    'row' parallel linear."""

    def __init__(self, d_in: int, d_out: int, device, mesh=None,
                 kind: str | None = None):
        super().__init__()
        self.mesh, self.kind = (mesh, kind) if model_sharded(mesh) else (None,
                                                                    None)
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))
        self.bias = nn.Parameter(torch.empty(d_out, device=device))

    def forward(self, x):
        return _linear(x, self.weight, self.bias, self.mesh, self.kind)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


class _LayerNormBf16(torch.autograd.Function):
    """LayerNorm of bf16 x with fp32 math that keeps only x and the [..., 1]
    fp32 mean and rsqrt for the backward, which is the complete analytic
    derivative (through mean and variance) in fp32: csrc/layer_norm.cu's
    kernels on the card, their plain version on the CPU
    (ops/layer_norm_kernel.py)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        out, mean, r = layer_norm_fwd(x, weight, bias)
        ctx.save_for_backward(x, mean, r, weight)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, mean, r, weight = ctx.saved_tensors
        return layer_norm_bwd(dout, x, mean, r, weight)


def layer_norm(x, weight, bias):
    """LayerNorm over the last dim with fp32 math, rounded once to x.dtype."""
    if x.dtype == torch.bfloat16:
        return _LayerNormBf16.apply(x, weight.float(), bias.float())
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + _LN_EPS)
    return (y * weight.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# the FFN


def _ffn_bits(seed, q: int, shape, width: int, device):
    """The FFN's dropout bits [rows, width] over its hidden units (keep iff
    bits >= q), or None at q 0: the plain path's draw (same seed, shape and
    split dim), so under tensor parallelism this rank's columns of the
    global width's draw, a view whose rows lie the global width apart."""
    if q <= 0:
        return None
    return dropout_bits(seed, (*shape[:-1], width), device,
                        split_dim=-1).reshape(-1, width)


class _FfnCore(torch.autograd.Function):
    """bf16 linear → activation → dropout → linear, its mask drawn from
    (seed, q). The backward keeps x, the weights in x's type and one
    activation-sized tensor: for ReLU the dropped activation a (where kept,
    a > 0 ⟺ h1 > 0, and dropped elements get a zero cotangent either way,
    so the mask is not a residual); for GELU the pre-activation h1, from
    which it takes GELU's derivative, redrawing the bits. The passes between
    the products (bias, rounding, activation, dropout; GELU's derivative
    and dw2's operand) are ops/ffn_epilogue.py's, one kernel each way on
    the card. The forward
    scales by the bf16-rounded scale; the weight gradients stay fp32 (JAX's
    einsums). Under a mesh that shards the model (w1 [F/tp, H], w2 [H,
    F/tp]) the fp32 partials of a·w2ᵀ and of dx are summed over 'model'
    before their roundings. k2: the ReLU backward takes (dh1, db2, db1) from
    kernel K2 (ops/ffn_bwd.py) at the fp32 scale, as JAX's Pallas body does
    with its static Python float; dw2, dw1 and dx stay products."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, seed, q, activation, mesh, k2):
        if k2 and activation != "relu":
            raise ValueError(f"K2's epilogue is the ReLU's, not {activation}'s")
        x2 = x.reshape(-1, x.shape[-1])
        w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
        p1 = _mm_f32(x2, w1c.t())
        bits = _ffn_bits(seed, q, x.shape, p1.shape[-1], x.device)
        a, h1 = ffn_epi_fwd(p1, b1, bits, q, activation, x.dtype)
        del p1, bits
        y = reduce_model_(_mm_f32(a, w2c.t()), mesh, "forward")
        y = (y + b2.float()).to(x.dtype)
        ctx.save_for_backward(x2, a if activation == "relu" else h1, w1c, w2c)
        ctx.seed, ctx.q, ctx.activation = seed, q, activation
        ctx.mesh, ctx.k2, ctx.shape = mesh, k2, x.shape
        return y.reshape(*x.shape[:-1], w2.shape[0])

    @staticmethod
    def backward(ctx, dy):
        x2, r, w1c, w2c = ctx.saved_tensors
        dy2 = dy.reshape(-1, dy.shape[-1])
        q, scale = ctx.q, 256.0 / (256 - ctx.q)
        if ctx.k2:
            dh1, db2, db1 = ffn_bwd.ffn_bwd_dh1(dy2, w2c, r, scale=scale)
            dw2 = _mm_f32(dy2.t(), r)
        else:
            db2 = dy2.float().sum(0)
            bits = None if ctx.activation == "relu" else _ffn_bits(
                ctx.seed, q, ctx.shape, r.shape[-1], r.device)
            dh1, db1, a = ffn_epi_bwd(_mm_f32(dy2, w2c), r, bits, q,
                                      ctx.activation)
            del bits
            dw2 = _mm_f32(dy2.t(), r if a is None else a)
            del a
        dw1 = _mm_f32(dh1.t(), x2)
        dx = reduce_model_(_mm_f32(dh1, w1c), ctx.mesh, "backward")
        return (dx.to(dy.dtype).reshape(ctx.shape), dw1, db1, dw2, db2, None,
                None, None, None, None)


def ffn(x, linear1: Linear, linear2: Linear, rate: float, seed=None,
        activation: str = "relu", k2: bool = False):
    """linear1 → activation → dropout → linear2, the dropout over the hidden
    units (split over 'model' under a mesh that shards them). bf16 training
    (a seed, and a rate that keeps anything) takes _FfnCore; everything
    else (fp32, eval, rate ≈ 1.0) the plain composition. Both draw the same
    mask from the same seed."""
    q = dropout_mask_q(rate) if seed is not None else 0
    if x.dtype == torch.bfloat16 and seed is not None and q < 256:
        return _FfnCore.apply(x, linear1.weight, linear1.bias, linear2.weight,
                              linear2.bias, seed, q, activation, linear2.mesh,
                              k2)
    h = ACTIVATIONS[activation](linear1(x))
    return linear2(dropout(h, rate, seed, seed is not None, split_dim=-1))


def ffn_fused(module, x, seed=None):
    """models/seq2seq._ffn with K2 in the bf16 training backward: the same
    gates, mask and forward, so a step routed here drops the elements the
    default step drops. Rebinding seq2seq._ffn to it routes the model, as
    tools/tpu_probe.py routes the JAX model."""
    return ffn(x, module.linear1, module.linear2, module.rate, seed, k2=True)


# ---------------------------------------------------------------------------
# remat


#: the products the port's matmuls reach at the dispatcher (torch.mm with an
#: fp32 output in _mm_f32, torch.matmul in _matmul_round_once and the fp32
#: @): what jax.checkpoint_policies.checkpoint_dots saves
_DOT_OPS = frozenset({torch.ops.aten.mm, torch.ops.aten.bmm,
                      torch.ops.aten.addmm, torch.ops.aten.baddbmm,
                      torch.ops.aten.matmul})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_count(cfg: Config, scope: str, n_layers: int) -> int:
    """How many leading layers of the `scope` stack are rematted: JAX's
    _maybe_remat and _scan_layers (all of them at remat_layers -1 or
    >= n_layers, none out of scope)."""
    if not cfg.remat or cfg.remat_scope not in ("all", scope):
        return 0
    k = cfg.remat_layers
    return n_layers if k < 0 or k >= n_layers else k


def run_layers(layers, x, seeds, cfg: Config, scope: str, *memory):
    """Apply the layers in order; the first _remat_count of them keep only
    their inputs and are recomputed in the backward (checkpoint per layer,
    non-reentrant, so the autograd Functions inside work unchanged and the
    recompute redraws every dropout mask from its per-site seed). Where no
    backward can follow (grad disabled, as in serving) nothing changes, as
    in JAX. cfg.unroll_residents is semantics only here: JAX unrolls the
    resident layers so that lax.scan does not stack their residuals; an
    eager Python loop stacks nothing."""
    n_remat = (_remat_count(cfg, scope, len(layers))
               if torch.is_grad_enabled() else 0)
    kw = {}
    if cfg.remat_policy == "dots":   # any other policy: full remat, as JAX
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    for i, (layer, s) in enumerate(zip(layers, seeds)):
        if i < n_remat:
            x = checkpoint(layer, x, *memory, s, use_reentrant=False, **kw)
        else:
            x = layer(x, *memory, s)
    return x

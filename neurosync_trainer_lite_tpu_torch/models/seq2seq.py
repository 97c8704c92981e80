"""The audio→blendshape Seq2Seq transformer as nn.Modules, eval and training.

Port of neurosync_trainer_lite_tpu/models/seq2seq.py. Module and parameter
names are the reference checkpoint's state-dict keys, so a reference
``model.pth`` loads with strict=True (utils/weights.py):

- Encoder: Linear embed → global RoPE over the model dim → n_layers of
  [post-LN self-attention, post-LN ReLU FFN(4x)] → final LayerNorm.
- Decoder: its input stream IS the encoder output, which is also the
  cross-attention memory → global RoPE → n_layers of [self-attn,
  cross-attn, FFN, all post-LN] → LayerNorm → Linear(output_dim).
- Dropout sits where the reference puts it, including the double dropout
  on attention outputs (inside the attention and again in the layer).

Parameters are fp32; with cfg.use_amp the compute runs in bf16 with fp32
accumulation, LayerNorm in fp32. A Python loop over the layers takes the
place of lax.scan. In bf16, LayerNorm and the training FFN are autograd
Functions with JAX's lean residuals and rounding points (_layer_norm_bf16,
_ffn_lean_core), the LayerNorm a pair of CUDA kernels on the card
(csrc/layer_norm.cu); fp32 keeps plain autograd, as in JAX.

Remat (cfg.remat, remat_scope, remat_layers, remat_policy): the first
remat_layers layers of each stack in scope run under
torch.utils.checkpoint and are recomputed in the backward (_run_layers);
'dots' keeps the matrix products' outputs and recomputes the rest.

Training: model.train() and a torch.Generator passed to forward turn
dropout on; the forward draws one seed from the generator and splits it
into per-layer and per-site seeds (ops/attention.py:split_seed) in the tree
shape of the JAX keys. Without a generator, or in eval mode, the forward is
the eval forward.

Tensor parallelism (Seq2Seq(cfg, device, mesh) with mesh.tp > 1): each
attention holds num_heads / tp heads (q, k, v [H/tp, H], out [H, H/tp])
and each FFN ffn_dim / tp hidden units (linear1 [F/tp, H], linear2
[H, F/tp]), as Megatron column- and row-parallel linears
(ops/attention.py:_linear, parallel/tensor.py); the rest is replicated.
The parameter names stay the reference's, so a rank's state dict is
parallel/mesh.py:shard_state_dict of the full one. The lean FFN
cores sum their second product's fp32 partials over 'model' before the
bias and the rounding, and their dx partials before dx's rounding.
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
from neurosync_trainer_lite_tpu_torch.ops.attention import (
    _bf16_value,
    _linear,
    _mm_f32,
    draw_seed,
    dropout,
    dropout_keep,
    dropout_mask_q,
    multi_head_attention,
    split_or_none,
)
from neurosync_trainer_lite_tpu_torch.ops.layer_norm_kernel import (
    EPS as _LN_EPS,
    layer_norm_bwd,
    layer_norm_fwd,
)
from neurosync_trainer_lite_tpu_torch.ops.rope import rope_embed
from neurosync_trainer_lite_tpu_torch.parallel.mesh import (
    model_sharded,
    param_spec,
    shard_tensor,
)
from neurosync_trainer_lite_tpu_torch.parallel.tensor import reduce_model_
from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device


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


def _local(n: int, mesh) -> int:
    """This rank's share of a width sharded over 'model'."""
    return n // mesh.tp if model_sharded(mesh) else n


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


class MultiHeadAttention(nn.Module):
    """num_heads heads over the width hidden; under a mesh that shards the
    model, this rank's num_heads / tp of them."""

    def __init__(self, hidden: int, num_heads: int, impl: str, device,
                 rate: float = 0.0, mesh=None):
        super().__init__()
        local = _local(hidden, mesh)
        self.num_heads, self.impl, self.rate = (_local(num_heads, mesh), impl,
                                                rate)
        self.q_linear = Linear(hidden, local, device, mesh, "column")
        self.k_linear = Linear(hidden, local, device, mesh, "column")
        self.v_linear = Linear(hidden, local, device, mesh, "column")
        self.out_linear = Linear(local, hidden, device, mesh, "row")

    def forward(self, query, key, value, seed=None):
        return multi_head_attention(self, query, key, value,
                                    num_heads=self.num_heads,
                                    dropout_rate=self.rate, seed=seed,
                                    train=seed is not None, impl=self.impl)


class _FfnLeanCore(torch.autograd.Function):
    """bf16 linear → relu → dropout → linear that keeps only x and the
    masked activation am for the backward: where kept, am > 0 ⟺ h1 > 0, and
    dropped elements get a zero cotangent either way, so the mask is not a
    residual. The weight gradients stay fp32 (JAX's einsums). Under a mesh
    that shards the model (w1 [F/tp, H], w2 [H, F/tp]) the fp32 partials
    of am·w2ᵀ and of dx are summed over 'model' before their roundings."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, keep, scale, mesh=None):
        x2 = x.reshape(-1, x.shape[-1])
        w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
        h1 = (_mm_f32(x2, w1c.t()) + b1.float()).to(x.dtype)
        am = torch.relu(h1)
        if keep is not None:
            am = torch.where(keep.reshape(am.shape), am * scale, 0)
        y = reduce_model_(_mm_f32(am, w2c.t()), mesh, "forward")
        y = (y + b2.float()).to(x.dtype)
        ctx.save_for_backward(x2, am, w1c, w2c)
        ctx.scale, ctx.shape, ctx.mesh = scale, x.shape, mesh
        return y.reshape(*x.shape[:-1], w2.shape[0])

    @staticmethod
    def backward(ctx, dy):
        x2, am, w1c, w2c = ctx.saved_tensors
        dy2 = dy.reshape(-1, dy.shape[-1])
        db2 = dy2.float().sum(0)
        dw2 = _mm_f32(dy2.t(), am)
        dam = _mm_f32(dy2, w2c).to(dy.dtype)
        dh1 = torch.where(am > 0, dam * ctx.scale, 0)
        db1 = dh1.float().sum(0)
        dw1 = _mm_f32(dh1.t(), x2)
        dx = reduce_model_(_mm_f32(dh1, w1c), ctx.mesh, "backward")
        return (dx.to(dy.dtype).reshape(ctx.shape), dw1, db1, dw2, db2, None,
                None, None)


def lean_ffn_mask(module, x, seed):
    """(keep, scale) for a lean FFN core, or None where the plain composition
    runs: the lean cores take bf16 training only, and rate ≈ 1.0 (which drops
    everything) goes plain. keep is None at rate 0; otherwise it is the plain
    path's draw (same seed, shape and threshold), so every path drops the
    same elements; under tensor parallelism this rank's columns of the
    global hidden width's draw. scale is the unrounded 256 / (256 - q)."""
    if x.dtype != torch.bfloat16 or seed is None:
        return None
    q = dropout_mask_q(module.rate)
    if q >= 256:
        return None
    if q <= 0:
        return None, 1.0
    keep = dropout_keep(seed, (*x.shape[:-1], module.linear1.weight.shape[0]),
                        q, x.device, split_dim=-1)
    return keep, 256.0 / (256 - q)


def ffn_plain(module, x, seed):
    """linear → relu → dropout → linear, plain autograd."""
    h = torch.relu(module.linear1(x))
    return module.linear2(dropout(h, module.rate, seed, seed is not None,
                                  split_dim=-1))


def _ffn(module, x, seed=None):
    """ReLU FFN with dropout after the activation (JAX models/seq2seq._ffn).
    bf16 training takes the lean core, which scales by the bf16-rounded
    scale, as JAX's. FeedForward.forward calls it through this module's
    global, so a caller may route the FFN elsewhere by rebinding
    seq2seq._ffn (ops/ffn_bwd.py:ffn_fused takes kernel K2)."""
    lean = lean_ffn_mask(module, x, seed)
    if lean is None:
        return ffn_plain(module, x, seed)
    keep, scale = lean
    return _FfnLeanCore.apply(x, module.linear1.weight, module.linear1.bias,
                              module.linear2.weight, module.linear2.bias, keep,
                              _bf16_value(scale), module.linear2.mesh)


class FeedForward(nn.Module):
    """linear1 [ffn_dim, hidden] → relu → linear2; under a mesh that shards
    the model, this rank's ffn_dim / tp hidden units."""

    def __init__(self, hidden: int, ffn_dim: int, device, rate: float = 0.0,
                 mesh=None):
        super().__init__()
        self.rate = rate
        local = _local(ffn_dim, mesh)
        self.linear1 = Linear(hidden, local, device, mesh, "column")
        self.linear2 = Linear(local, hidden, device, mesh, "row")

    def forward(self, x, seed=None):
        return _ffn(self, x, seed)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: Config, device, mesh=None):
        super().__init__()
        H, rate = cfg.hidden_dim, cfg.dropout
        self.rate = rate
        self.self_attn = MultiHeadAttention(H, cfg.num_heads,
                                            cfg.attention_impl, device, rate,
                                            mesh)
        self.ffn = FeedForward(H, cfg.ffn_dim, device, rate, mesh)
        self.norm1 = LayerNorm(H, device)
        self.norm2 = LayerNorm(H, device)

    def forward(self, x, seed=None):
        s_attn, s_d1, s_ffn, s_d2 = split_or_none(seed, 4)
        train = seed is not None
        a = self.self_attn(x, x, x, s_attn)
        x = self.norm1(x + dropout(a, self.rate, s_d1, train))
        f = self.ffn(x, s_ffn)
        return self.norm2(x + dropout(f, self.rate, s_d2, train))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: Config, device, mesh=None):
        super().__init__()
        H, rate = cfg.hidden_dim, cfg.dropout
        self.rate = rate
        self.self_attn = MultiHeadAttention(H, cfg.num_heads,
                                            cfg.attention_impl, device, rate,
                                            mesh)
        self.multihead_attn = MultiHeadAttention(H, cfg.num_heads,
                                                 cfg.attention_impl, device,
                                                 rate, mesh)
        self.ffn = FeedForward(H, cfg.ffn_dim, device, rate, mesh)
        self.norm1 = LayerNorm(H, device)
        self.norm2 = LayerNorm(H, device)
        self.norm3 = LayerNorm(H, device)

    def forward(self, x, memory, seed=None):
        s_self, s_d1, s_cross, s_d2, s_ffn, s_d3 = split_or_none(seed, 6)
        train = seed is not None
        a = self.self_attn(x, x, x, s_self)
        x = self.norm1(x + dropout(a, self.rate, s_d1, train))
        c = self.multihead_attn(x, memory, memory, s_cross)
        x = self.norm2(x + dropout(c, self.rate, s_d2, train))
        f = self.ffn(x, s_ffn)
        return self.norm3(x + dropout(f, self.rate, s_d3, train))


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


def _run_layers(layers, x, seeds, cfg: Config, scope: str, *memory):
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


class Encoder(nn.Module):
    def __init__(self, cfg: Config, device, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.embedding = Linear(cfg.input_dim, cfg.hidden_dim, device)
        self.transformer_encoder = nn.ModuleList(
            EncoderLayer(cfg, device, mesh) for _ in range(cfg.n_layers))
        self.layer_norm = LayerNorm(cfg.hidden_dim, device)

    def forward(self, x, seed=None):
        x = rope_embed(self.embedding(x))
        seeds = split_or_none(seed, len(self.transformer_encoder))
        x = _run_layers(self.transformer_encoder, x, seeds, self.cfg,
                        "encoder")
        return self.layer_norm(x)


class Decoder(nn.Module):
    def __init__(self, cfg: Config, device, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.transformer_decoder = nn.ModuleList(
            DecoderLayer(cfg, device, mesh) for _ in range(cfg.n_layers))
        self.fc_output = Linear(cfg.hidden_dim, cfg.output_dim, device)
        self.layer_norm = LayerNorm(cfg.hidden_dim, device)

    def forward(self, encoder_outputs, seed=None):
        x = rope_embed(encoder_outputs)
        seeds = split_or_none(seed, len(self.transformer_decoder))
        x = _run_layers(self.transformer_decoder, x, seeds, self.cfg,
                        "decoder", encoder_outputs)
        return self.fc_output(self.layer_norm(x)).float()


class Seq2Seq(nn.Module):
    """src [B, T, input_dim] → predictions [B, T, output_dim] (fp32).

    The weights start uninitialised: fill them with init_seq2seq or a
    state dict (utils/weights.py). mesh: a rank mesh whose 'model' axis
    shards the model (this rank's shard; None, or tp = 1, builds it whole).
    """

    def __init__(self, cfg: Config, device=None, mesh=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh if model_sharded(mesh) else None
        self.encoder = Encoder(cfg, device, self.mesh)
        self.decoder = Decoder(cfg, device, self.mesh)

    def forward(self, src, generator: torch.Generator | None = None):
        """In train mode with a generator, dropout is on: the forward draws
        one seed from the generator (seq2seq_apply's rng)."""
        dtype = torch.bfloat16 if self.cfg.use_amp else torch.float32
        seed = (draw_seed(generator)
                if self.training and generator is not None else None)
        seed_enc, seed_dec = split_or_none(seed, 2)
        return self.decoder(self.encoder(src.to(dtype), seed_enc), seed_dec)


@torch.no_grad()
def init_seq2seq(cfg: Config, generator: torch.Generator, device=None,
                 mesh=None) -> Seq2Seq:
    """A model with N(0, 0.02) weights and zero biases (LayerNorm: ones and
    zeros), drawn from `generator`, which must live on the model's device.
    Under a mesh that shards the model, this rank's shard of that model:
    each weight is drawn whole, in the same order, and only this rank's
    block of it kept, so no rank holds more than one full leaf."""
    model = Seq2Seq(cfg, device, mesh)
    for name, module in model.named_modules():
        if isinstance(module, Linear):
            dim = param_spec(f"{name}.weight") if module.mesh else None
            if dim is None:
                module.weight.normal_(0.0, 0.02, generator=generator)
            else:
                shape = list(module.weight.shape)
                shape[dim] *= mesh.tp
                full = module.weight.new_empty(shape).normal_(
                    0.0, 0.02, generator=generator)
                module.weight.copy_(shard_tensor(full, dim, mesh))
            module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model


def count_parameters(model: nn.Module) -> int:
    """The model's parameter count. Under a mesh that shards the model, the
    full model's: each leaf sharded over 'model' counts at its global
    shape (parallel/mesh.py:param_spec), as the JAX package's .size counts
    a GSPMD-sharded array, and the replicated leaves once."""
    mesh = getattr(model, "mesh", None)
    tp = mesh.tp if model_sharded(mesh) else 1
    return sum(p.numel() * (1 if param_spec(k) is None else tp)
               for k, p in model.named_parameters())

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
accumulation, LayerNorm in fp32. The Linear, the LayerNorm, the FFN and
the layer loop (run_layers, which applies cfg.remat) are models/layers.py's;
a Python loop over the layers takes the place of lax.scan.

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
parallel/mesh.py:shard_state_dict of the full one.
"""

from __future__ import annotations

import torch
from torch import nn

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.models.layers import (
    LayerNorm,
    Linear,
    ffn,
    layer_norm,  # noqa: F401 (the JAX module's public name)
    run_layers,
)
from neurosync_trainer_lite_tpu_torch.ops.attention import (
    draw_seed,
    dropout,
    multi_head_attention,
    split_or_none,
)
from neurosync_trainer_lite_tpu_torch.ops.rope import rope_embed
from neurosync_trainer_lite_tpu_torch.parallel.mesh import (
    model_sharded,
    param_spec,
    shard_tensor,
)
from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device


def _local(n: int, mesh) -> int:
    """This rank's share of a width sharded over 'model'."""
    return n // mesh.tp if model_sharded(mesh) else n


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


def _ffn(module, x, seed=None):
    """ReLU FFN with dropout after the activation (JAX models/seq2seq._ffn):
    models/layers.py:ffn. FeedForward.forward calls it through this
    module's global, so a caller may route the FFN elsewhere by rebinding
    seq2seq._ffn (models/layers.py:ffn_fused takes kernel K2)."""
    return ffn(x, module.linear1, module.linear2, module.rate, seed)


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
        x = run_layers(self.transformer_encoder, x, seeds, self.cfg,
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
        x = run_layers(self.transformer_decoder, x, seeds, self.cfg,
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

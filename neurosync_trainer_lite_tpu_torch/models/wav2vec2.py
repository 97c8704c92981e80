"""wav2vec 2.0 large (LV-60) as the port's second architecture: raw 16 kHz
waveform windows → 61 blendshapes at the window's frames, for training.

The architecture is the published one (Baevski et al. 2020,
arXiv:2006.11477; the public facebook/wav2vec2-large-lv60 config:
feat_extract_norm 'layer', conv_bias, do_stable_layer_norm) with
FaceFormer's recipe for face animation (Fan et al., CVPR 2022,
wav2vec.py): the conv feature encoder frozen, its 50 Hz frames linearly
interpolated to the motion frames before the feature projection.

- Frontend (no gradient while frozen; span nsync.w2v.frontend): each
  window normalised to zero mean and unit variance (eps 1e-7, the feature
  extractor's do_normalize), len(conv_dim) × [Conv1d with bias → LayerNorm
  over the channels (eps 1e-5) → GELU] with the published kernels and
  strides (CONV_KERNEL, CONV_STRIDE),
  then linear interpolation (align_corners=True) from the encoder's frames
  to the window's frames (frames_of(samples)).
- Feature projection: LayerNorm(conv_dim[-1]) → Linear(→ hidden) → dropout.
- Positional conv embedding (span nsync.w2v.pos_conv; its backward opens
  nsync.w2v.pos_conv_bwd, _PosConv): Conv1d(hidden → hidden, kernel K,
  padding K // 2, groups G, bias) under weight norm over dim 2 (weight =
  g · v / ‖v‖, the norm over dims 0 and 1 for each tap), the last output
  frame dropped (K even), GELU, added to its input; then dropout.
- n_layers pre-LN layers: x + drop(Attn(LN₁(x))), then
  x + drop(W₂·drop(GELU(W₁·LN₂(x) + b₁)) + b₂): hidden / num_heads wide
  heads with biased projections, softmax(q·kᵀ/√h) with dropout on the
  weights, no RoPE and no second dropout inside (ops/attention.py's
  multi_head_attention with use_rope and out_dropout off); the FFN's GELU
  is the exact erf form, 4 × hidden wide.
- The final LayerNorm, then Linear(hidden → output_dim): the trainer's
  blendshape head in place of the source's CTC head.

Dropout: cfg.dropout at the two residual sites, after the positional
embedding, on the attention weights and on the FFN's activation (the
source's hidden, attention and activation dropout, equal in its config);
FEAT_PROJ_DROPOUT after the projection; the masks are ops/attention.py's (uint8 thresholds drawn from
per-site seeds). The seed tree: the forward draws one seed from the step's
generator, as the Seq2Seq does, and splits it (ops/attention.py:split_seed)
into (projection, positional, layers); the layers' into one a layer; a
layer's into (attention, attention output, FFN activation, FFN output);
the attention's into (weights, unused) as multi_head_attention splits it.

Precision: with cfg.use_amp the frontend's convs, the positional conv, the
products and the FFN run in bf16 with fp32 accumulation. The Linear, the
LayerNorm (bf16: the kernel pair of csrc/layer_norm.cu, widths hidden and
conv_dim[-1]), the FFN (bf16 training: its one core, with the GELU) and the
layer loop are models/layers.py's; fp32 is plain autograd. The 24 layers go
through run_layers at scope 'encoder', so cfg.remat applies.

Parameter names are the source checkpoint's where the port's modules allow
(feature_extractor.conv_layers.{i}.conv, .layer_norm;
feature_projection.layer_norm, .projection; encoder.pos_conv_embed.conv
.weight_g, .weight_v, .bias; encoder.layers.{i}.layer_norm, .attention,
.final_layer_norm, .feed_forward.intermediate_dense, .output_dense;
encoder.layer_norm), but for the attention's q_linear, k_linear, v_linear
and out_linear (the source's q_proj ... out_proj; multi_head_attention's
names) and the head, fc_output. Data and tensor parallelism: the model
trains data-parallel through the step's all-reduce; no form of it is
sharded (config.check_tp_split refuses tp > 1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from neurosync_trainer_lite_tpu_torch.config import Config, check_tp_split
from neurosync_trainer_lite_tpu_torch.models.layers import (
    LayerNorm,
    Linear,
    ffn,
    run_layers,
)
from neurosync_trainer_lite_tpu_torch.ops.attention import (
    draw_seed,
    dropout,
    multi_head_attention,
    split_or_none,
)
from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device
from neurosync_trainer_lite_tpu_torch.utils.profiling import span

#: the waveform normalisation's epsilon (Wav2Vec2FeatureExtractor's)
NORM_EPS = 1e-7
#: the dropout after the feature projection (the source's feat_proj_dropout)
FEAT_PROJ_DROPOUT = 0.0
#: the published feature encoder's kernels and strides (conv_kernel,
#: conv_stride): 320 samples a frame, a receptive field of 400
CONV_KERNEL = (10, 3, 3, 3, 3, 2, 2)
CONV_STRIDE = (5, 2, 2, 2, 2, 2, 2)


def frames_of(samples: int, cfg: Config) -> int:
    """The frames of a window of `samples` samples: the one whole number T
    with floor(T · sr / frame_rate) == samples (cfg.window_samples)."""
    return -(-samples * cfg.frame_rate // cfg.sr)


def normalize_waveform(x: torch.Tensor) -> torch.Tensor:
    """Each row of x [B, S] to zero mean and unit (population) variance."""
    mean = x.mean(-1, keepdim=True)
    var = torch.square(x - mean).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + NORM_EPS)


class Conv(nn.Module):
    """A Conv1d's weight [out, in / groups, kernel] and bias [out]."""

    def __init__(self, c_in: int, c_out: int, kernel: int, device,
                 groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in // groups, kernel,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(c_out, device=device))


class WeightNormConv(nn.Module):
    """A Conv1d's weight as weight_g [1, 1, kernel] · weight_v / ‖weight_v‖
    (weight norm over dim 2), and its bias."""

    def __init__(self, width: int, kernel: int, groups: int, device):
        super().__init__()
        self.weight_g = nn.Parameter(torch.empty(1, 1, kernel, device=device))
        self.weight_v = nn.Parameter(torch.empty(width, width // groups,
                                                 kernel, device=device))
        self.bias = nn.Parameter(torch.empty(width, device=device))

    def weight(self) -> torch.Tensor:
        v = self.weight_v
        return v * (self.weight_g / v.norm(dim=(0, 1), keepdim=True))


class ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 device):
        super().__init__()
        self.stride = stride
        self.conv = Conv(c_in, c_out, kernel, device)
        self.layer_norm = LayerNorm(c_out, device)

    def forward(self, x):
        """x [B, C_in, L] → [B, C_out, L'] (a view of [B, L', C_out])."""
        y = F.conv1d(x, self.conv.weight.to(x.dtype),
                     self.conv.bias.to(x.dtype), self.stride)
        y = self.layer_norm(y.transpose(1, 2))
        return F.gelu(y).transpose(1, 2)


class FeatureEncoder(nn.Module):
    def __init__(self, cfg: Config, device):
        super().__init__()
        if len(cfg.conv_dim) != len(CONV_KERNEL):
            raise ValueError(f"conv_dim {cfg.conv_dim} must give the "
                             f"{len(CONV_KERNEL)} convs' widths")
        widths = (1, *cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            ConvLayer(widths[i], widths[i + 1], k, s, device)
            for i, (k, s) in enumerate(zip(CONV_KERNEL, CONV_STRIDE)))

    def forward(self, wave, frames: int, dtype):
        """wave [B, S] → features [B, frames, conv_dim[-1]] in dtype."""
        x = normalize_waveform(wave.float()).to(dtype)[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        x = F.interpolate(x, size=frames, mode="linear", align_corners=True)
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, c_in: int, hidden: int, device, rate: float):
        super().__init__()
        self.rate = rate
        self.layer_norm = LayerNorm(c_in, device)
        self.projection = Linear(c_in, hidden, device)

    def forward(self, x, seed=None):
        return dropout(self.projection(self.layer_norm(x)), self.rate, seed,
                       seed is not None)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Config, device):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.padding, self.groups = k // 2, cfg.num_conv_pos_embedding_groups
        self.conv = WeightNormConv(cfg.hidden_dim, k, self.groups, device)


class _PosConv(torch.autograd.Function):
    """The grouped positional conv over x [B, H, T], its output cut to T
    frames; the weight (fp32, weight-normed) is cast to x's type once. The
    backward takes dx and dweight in one convolution_backward, in span
    nsync.w2v.pos_conv_bwd, and the bias gradient in fp32."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding, groups):
        w = weight.to(x.dtype)
        y = F.conv1d(x, w, bias.to(x.dtype), padding=padding, groups=groups)
        ctx.save_for_backward(x, w)
        ctx.padding, ctx.groups = padding, groups
        ctx.cut = y.shape[-1] - x.shape[-1]
        return y[..., :x.shape[-1]]

    @staticmethod
    def backward(ctx, dy):
        with span("nsync.w2v.pos_conv_bwd"):
            x, w = ctx.saved_tensors
            dy = F.pad(dy, (0, ctx.cut))
            dx, dw, _ = torch.ops.aten.convolution_backward(
                dy, x, w, None, [1], [ctx.padding], [1], False, [0],
                ctx.groups, [True, True, False])
            db = dy.float().sum((0, 2))
        return dx, dw.float(), db, None, None


def pos_conv(module: PositionalConvEmbedding, x: torch.Tensor):
    """x [B, T, H] → the positional embedding GELU(conv(x)) [B, T, H]. The
    model calls it through this module's global, so that a check can take
    it off the path."""
    y = _PosConv.apply(x.transpose(1, 2), module.conv.weight(),
                       module.conv.bias, module.padding, module.groups)
    return F.gelu(y).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, hidden: int, num_heads: int, impl: str, device,
                 rate: float):
        super().__init__()
        self.num_heads, self.impl, self.rate = num_heads, impl, rate
        self.q_linear = Linear(hidden, hidden, device)
        self.k_linear = Linear(hidden, hidden, device)
        self.v_linear = Linear(hidden, hidden, device)
        self.out_linear = Linear(hidden, hidden, device)

    def forward(self, x, seed=None):
        return multi_head_attention(
            self, x, x, x, num_heads=self.num_heads, dropout_rate=self.rate,
            seed=seed, train=seed is not None, use_rope=False,
            impl=self.impl, out_dropout=False)


class FeedForward(nn.Module):
    def __init__(self, hidden: int, ffn_dim: int, device, rate: float):
        super().__init__()
        self.rate = rate
        self.intermediate_dense = Linear(hidden, ffn_dim, device)
        self.output_dense = Linear(ffn_dim, hidden, device)

    def forward(self, x, seed=None):
        return ffn(x, self.intermediate_dense, self.output_dense, self.rate,
                   seed, "gelu")


class EncoderLayer(nn.Module):
    """The pre-LN layer (do_stable_layer_norm)."""

    def __init__(self, cfg: Config, device):
        super().__init__()
        H = cfg.hidden_dim
        self.rate = cfg.dropout
        self.layer_norm = LayerNorm(H, device)
        self.attention = Attention(H, cfg.num_heads, cfg.attention_impl,
                                   device, cfg.dropout)
        self.final_layer_norm = LayerNorm(H, device)
        self.feed_forward = FeedForward(H, cfg.ffn_dim, device, cfg.dropout)

    def forward(self, x, seed=None):
        s_attn, s_d1, s_ffn, s_d2 = split_or_none(seed, 4)
        train = seed is not None
        a = self.attention(self.layer_norm(x), s_attn)
        x = x + dropout(a, self.rate, s_d1, train)
        f = self.feed_forward(self.final_layer_norm(x), s_ffn)
        return x + dropout(f, self.rate, s_d2, train)


class Encoder(nn.Module):
    def __init__(self, cfg: Config, device):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg, device)
        self.layers = nn.ModuleList(EncoderLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.layer_norm = LayerNorm(cfg.hidden_dim, device)


class Wav2Vec2(nn.Module):
    """src [B, S] waveform windows (S = cfg.window_samples) → predictions
    [B, frames_of(S), output_dim] (fp32).

    The weights start uninitialised: fill them with init_wav2vec2 or a
    state dict. With cfg.freeze_feature_encoder the frontend's parameters
    take no gradient (and so no Adam state)."""

    def __init__(self, cfg: Config, device=None, mesh=None):
        super().__init__()
        if mesh is not None:
            check_tp_split(cfg, mesh.tp)
        device = resolve_device(device)
        self.cfg, self.mesh = cfg, None
        self.feature_extractor = FeatureEncoder(cfg, device)
        self.feature_projection = FeatureProjection(
            cfg.conv_dim[-1], cfg.hidden_dim, device, FEAT_PROJ_DROPOUT)
        self.encoder = Encoder(cfg, device)
        self.fc_output = Linear(cfg.hidden_dim, cfg.output_dim, device)
        if cfg.freeze_feature_encoder:
            self.feature_extractor.requires_grad_(False)

    def forward(self, src, generator: torch.Generator | None = None):
        """In train mode with a generator, dropout is on (one seed drawn
        from the generator, split as the module's docstring says)."""
        cfg = self.cfg
        dtype = torch.bfloat16 if cfg.use_amp else torch.float32
        seed = (draw_seed(generator)
                if self.training and generator is not None else None)
        s_proj, s_pos, s_layers = split_or_none(seed, 3)
        frames = frames_of(src.shape[-1], cfg)
        with span("nsync.w2v.frontend"):
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not cfg.freeze_feature_encoder):
                x = self.feature_extractor(src, frames, dtype)
        x = self.feature_projection(x, s_proj)
        with span("nsync.w2v.pos_conv"):
            x = x + pos_conv(self.encoder.pos_conv_embed, x)
        x = dropout(x, cfg.dropout, s_pos, seed is not None)
        layers = self.encoder.layers
        x = run_layers(layers, x, split_or_none(s_layers, len(layers)), cfg,
                       "encoder")
        return self.fc_output(self.encoder.layer_norm(x)).float()


@torch.no_grad()
def init_wav2vec2(cfg: Config, generator: torch.Generator, device=None,
                  mesh=None) -> Wav2Vec2:
    """A model drawn from `generator` (on the model's device): Linear
    weights N(0, 0.02), every bias 0, LayerNorms 1 and 0, conv weights
    N(0, 2 / fan_in) (Kaiming's normal), and weight_g = ‖weight_v‖ a tap,
    so that the weight-normed positional conv starts at weight_v."""
    model = Wav2Vec2(cfg, device, mesh)
    for module in model.modules():
        if isinstance(module, Linear):
            module.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
        elif isinstance(module, Conv):
            fan_in = module.weight[0].numel()
            module.weight.normal_(0.0, math.sqrt(2.0 / fan_in),
                                  generator=generator)
        elif isinstance(module, WeightNormConv):
            v = module.weight_v
            v.normal_(0.0, math.sqrt(2.0 / v[0].numel()), generator=generator)
            module.weight_g.copy_(v.norm(dim=(0, 1), keepdim=True))
        else:
            continue
        module.bias.zero_()
    return model

"""The plain reference of wav2vec 2.0 large (LV-60) as the trainer trains
it: forward, loss, backward, clip and Adam, in float32 PyTorch with TF32
off.

Written from the published equations (Baevski et al. 2020,
arXiv:2006.11477; the facebook/wav2vec2-large-lv60 config.json:
feat_extract_norm 'layer', conv_bias, do_stable_layer_norm, exact GELU;
FaceFormer's wav2vec.py for the frozen encoder and the interpolation to
the motion frames) and from nothing of the port: no kernel, no lean core,
no cache, autograd for every gradient. It imports torch and numpy alone.

- Each window normalised to zero mean and unit population variance (eps
  1e-7); 7 × [Conv1d with bias → LayerNorm over the channels (eps 1e-5)
  → GELU], frozen: no gradient, no Adam state.
- Linear interpolation, written out: frame j of T reads the encoder's
  frames at position j·(L − 1)/(T − 1) (align_corners).
- LayerNorm(512) → Linear(512 → 1024) → dropout (rate 0).
- The positional conv: weight = g · v / ‖v‖ with the norm over dims 0 and
  1 for each of the 128 taps; Conv1d(groups 16, padding 64, bias), the
  last output frame dropped, GELU, added to its input; then dropout.
- 24 pre-LN layers: x + drop(Attn(LN₁(x))), x + drop(FFN(LN₂(x))); Attn:
  16 heads of 64, biased projections, softmax(q·kᵀ/8), dropout on the
  weights; FFN: Linear → GELU → dropout → Linear.
- The final LayerNorm and Linear(1024 → 61): the trainer's blendshape
  head in place of the source's CTC head (a departure of the trainer's,
  as the interpolation to 60 fps is FaceFormer's).
- Loss: SmoothL1(β=delta) + L1 of the frame deltas + (1 − mean cosine of
  the frame deltas), the trainer's. Clip: g·max/‖g‖ where ‖g‖ ≥ max.
  Adam with L2 weight decay added to the gradient (torch.optim.Adam's).

Dropout is inverted dropout with the masks of the program's stated
convention, which a reference has to share to follow its steps: each
site's keep mask is uint8 bits from a Philox generator seeded with the
site's seed, drawn over the whole batch, kept where bits ≥ q =
round(rate·256), scaled by 256/(256 − q). The seeds form a tree split
from one seed a step: (projection, positional, layers), one a layer, and
a layer's (attention → (weights, unused), attention output, FFN
activation, FFN output). The bits come from the device's generator, so
the masks are drawn on the device the program trained on.

The control (`prec='fp8'`): float8 e4m3 with one scale a tensor (its
largest magnitude to 448) for every operand of every product and
convolution, forward and backward, and every activation where the bf16
program rounds; `prec='fp8mm'` the products' and convolutions' operands
alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS, NORM_EPS = 1e-5, 1e-7
#: the published conv feature encoder's kernels and strides
CONV_KERNEL, CONV_STRIDE = (10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2)
SEED_HIGH = 1 << 62
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
#: the published config's feat_proj_dropout; its hidden, attention and
#: activation dropout are one rate, the configuration's dropout
FEAT_PROJ_DROPOUT = 0.0
SEED_MASK = (1 << 63) - 1


def plain_precision() -> None:
    """float32 products and convolutions in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dims(config: dict) -> dict:
    """The sizes of a configuration (the port's Config keys) that the
    model and its counts read."""
    hidden = int(config["hidden_dim"])
    frames = int(config["micro_batch_size"])
    return {"hidden": hidden, "layers": int(config["n_layers"]),
            "heads": int(config["num_heads"]), "ffn": 4 * hidden,
            "output_dim": int(config["output_dim"]),
            "conv_dim": [int(c) for c in config["conv_dim"]],
            "conv_kernel": list(CONV_KERNEL), "conv_stride": list(CONV_STRIDE),
            "pos_kernel": int(config["num_conv_pos_embeddings"]),
            "pos_groups": int(config["num_conv_pos_embedding_groups"]),
            "frames": frames,
            "samples": frames * int(config["sr"]) // int(config["frame_rate"]),
            "dropout": float(config["dropout"]),
            "frozen": bool(config["freeze_feature_encoder"])}


def encoder_frames(d: dict) -> list[int]:
    """The conv stack's output frames, layer by layer, for one window."""
    out, n = [], d["samples"]
    for k, s in zip(d["conv_kernel"], d["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def param_shapes(d: dict) -> dict:
    """Every parameter's name and shape, in the order they are drawn."""
    h, f = d["hidden"], d["ffn"]
    out: dict = {}

    def lin(name, n_in, n_out):
        out[f"{name}.weight"] = (n_out, n_in)
        out[f"{name}.bias"] = (n_out,)

    def ln(name, width):
        out[f"{name}.weight"] = (width,)
        out[f"{name}.bias"] = (width,)

    c_in = 1
    for i, (c, k) in enumerate(zip(d["conv_dim"], d["conv_kernel"])):
        p = f"feature_extractor.conv_layers.{i}"
        out[f"{p}.conv.weight"] = (c, c_in, k)
        out[f"{p}.conv.bias"] = (c,)
        ln(f"{p}.layer_norm", c)
        c_in = c
    ln("feature_projection.layer_norm", c_in)
    lin("feature_projection.projection", c_in, h)
    p = "encoder.pos_conv_embed.conv"
    out[f"{p}.weight_g"] = (1, 1, d["pos_kernel"])
    out[f"{p}.weight_v"] = (h, h // d["pos_groups"], d["pos_kernel"])
    out[f"{p}.bias"] = (h,)
    for i in range(d["layers"]):
        p = f"encoder.layers.{i}"
        ln(f"{p}.layer_norm", h)
        for name in ("q", "k", "v", "out"):
            lin(f"{p}.attention.{name}_linear", h, h)
        ln(f"{p}.final_layer_norm", h)
        lin(f"{p}.feed_forward.intermediate_dense", h, f)
        lin(f"{p}.feed_forward.output_dense", f, h)
    ln("encoder.layer_norm", h)
    lin("fc_output", h, d["output_dim"])
    return out


def frozen(name: str, d: dict) -> bool:
    return d["frozen"] and name.startswith("feature_extractor.")


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on `device` for one purpose (`stream`) of one seed."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) & SEED_MASK)
    return g


def seeded_weights(d: dict, seed: int, device) -> dict:
    """The model at its initialisation, drawn from the seed: every Linear
    weight N(0, 0.02) (one draw for all), conv weights N(0, 2 / fan_in)
    (Kaiming's normal; one draw for all, each scaled), weight_g = ‖v‖ a tap
    (the weight-normed conv starts at v), biases 0, LayerNorms 1 and 0."""
    shapes = param_shapes(d)
    mats = [k for k, s in shapes.items() if len(s) == 2]
    convs = [k for k, s in shapes.items() if len(s) == 3
             and not k.endswith("weight_g")]
    out = {}
    for keys, stream in ((mats, 1), (convs, 3)):
        flat = torch.randn(sum(math.prod(shapes[k]) for k in keys),
                           generator=generator(seed, device, stream),
                           device=device)
        offset = 0
        for k in keys:
            n = math.prod(shapes[k])
            w = flat[offset: offset + n].view(shapes[k])
            out[k] = w.mul_(0.02 if stream == 1 else
                            math.sqrt(2.0 / math.prod(shapes[k][1:])))
            offset += n
    for k, s in shapes.items():
        if k.endswith("weight_g"):
            out[k] = out[k[:-1] + "v"].norm(dim=(0, 1), keepdim=True)
        elif k not in out:
            fill = 1.0 if ("norm" in k and k.endswith(".weight")) else 0.0
            out[k] = torch.full(s, fill, device=device)
    return {k: out[k] for k in shapes}


# ---------------------------------------------------------------------------
# dropout's seed tree and masks


def split_seed(seed: int, n: int) -> list[int]:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, SEED_HIGH, (n,), generator=g).tolist()


def split_or_none(seed, n: int) -> list:
    return [None] * n if seed is None else split_seed(seed, n)


def step_seed(run_seed: int, batch_step: int) -> int:
    """The root seed of training step `batch_step`: a generator seeded from
    (run_seed + 1, batch_step) through numpy's SeedSequence, and one draw."""
    root = np.random.SeedSequence([run_seed + 1, batch_step]).generate_state(
        1, np.uint64)[0]
    g = torch.Generator().manual_seed(int(root) >> 1)
    return int(torch.randint(0, SEED_HIGH, (1,), generator=g).item())


class Dropout:
    """The masks of one forward: rows [r0, r0 + rows) of a batch of
    `batch` rows; seed None or rate 0 drops nothing."""

    def __init__(self, batch: int, r0: int = 0):
        self.batch, self.r0 = batch, r0

    def __call__(self, x: torch.Tensor, seed, rate: float) -> torch.Tensor:
        q = int(round(rate * 256))
        if seed is None or q <= 0:
            return x
        g = torch.Generator(device=x.device)
        g.manual_seed(seed)
        bits = torch.empty((self.batch, *x.shape[1:]), dtype=torch.uint8,
                           device=x.device)
        bits.random_(generator=g)
        keep = bits[self.r0: self.r0 + x.shape[0]] >= q
        return torch.where(keep, x * (256.0 / (256 - q)), 0.0)


# ---------------------------------------------------------------------------
# products and convolutions, and the float8 control


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one scale (its largest magnitude to
    448), back in float32."""
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, 448.0 / amax, 1.0)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fake_fp8(a), fake_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, dy):
        qa, qb = ctx.saved_tensors
        qd = fake_fp8(dy)
        return qd @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qd


class _Fp8Conv(torch.autograd.Function):
    """conv1d of float8-rounded operands; the backward rounds dy too."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        qx, qw = fake_fp8(x), fake_fp8(w)
        ctx.save_for_backward(qx, qw)
        ctx.args = (stride, padding, groups)
        return F.conv1d(qx, qw, None, stride, padding, 1, groups)

    @staticmethod
    def backward(ctx, dy):
        qx, qw = ctx.saved_tensors
        stride, padding, groups = ctx.args
        qd = fake_fp8(dy)
        dx = torch.nn.grad.conv1d_input(qx.shape, qw, qd, stride, padding,
                                        1, groups)
        dw = torch.nn.grad.conv1d_weight(qx, qw.shape, qd, stride, padding,
                                         1, groups)
        return dx, dw, None, None, None


class _Fp8Round(torch.autograd.Function):
    """An activation stored in float8: rounded forward, and its gradient
    rounded backward."""

    @staticmethod
    def forward(ctx, x):
        return fake_fp8(x)

    @staticmethod
    def backward(ctx, dy):
        return fake_fp8(dy)


def matmul(a, b, prec: str):
    if prec == "fp32":
        return a @ b
    if prec in ("fp8", "fp8mm"):
        return _Fp8Matmul.apply(a, b)
    raise ValueError(f"precision {prec!r}")


def conv1d(x, w, b, prec: str, stride=1, padding=0, groups=1):
    if prec == "fp32":
        y = F.conv1d(x, w, None, stride, padding, 1, groups)
    elif prec in ("fp8", "fp8mm"):
        y = _Fp8Conv.apply(x, w, stride, padding, groups)
    else:
        raise ValueError(f"precision {prec!r}")
    return y + b[:, None]


def act(x, prec: str):
    """x as the compute type holds it: as is but under 'fp8'."""
    return _Fp8Round.apply(x) if prec == "fp8" else x


# ---------------------------------------------------------------------------
# the model


def gelu(x):
    """The exact GELU: x · Φ(x)."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def layer_norm(x, w, b, prec):
    """Over the last dim."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return act((x - mean) / torch.sqrt(var + LN_EPS) * w + b, prec)


def linear(P, name, x, prec):
    w = P[f"{name}.weight"]
    y = matmul(x.reshape(-1, x.shape[-1]), w.t(), prec) + P[f"{name}.bias"]
    return act(y.reshape(*x.shape[:-1], w.shape[0]), prec)


def interpolate(x, frames: int):
    """x [B, C, L] → [B, C, frames]: frame j reads position j·(L−1)/(frames−1)
    between the two frames around it."""
    L = x.shape[-1]
    pos = torch.arange(frames, dtype=torch.float64) * ((L - 1) / (frames - 1))
    lo = pos.floor().long().clamp(max=L - 1)
    hi = (lo + 1).clamp(max=L - 1)
    frac = (pos - lo).to(x.dtype).to(x.device)
    lo, hi = lo.to(x.device), hi.to(x.device)
    return x[..., lo] * (1.0 - frac) + x[..., hi] * frac


def frontend(P, wave, d, prec):
    """wave [B, S] → features [B, frames, conv_dim[-1]]."""
    mean = wave.mean(-1, keepdim=True)
    var = ((wave - mean) ** 2).mean(-1, keepdim=True)
    x = act((wave - mean) / torch.sqrt(var + NORM_EPS), prec)[:, None, :]
    for i, s in enumerate(d["conv_stride"]):
        p = f"feature_extractor.conv_layers.{i}"
        x = act(conv1d(x, P[f"{p}.conv.weight"], P[f"{p}.conv.bias"], prec,
                       stride=s), prec)
        x = layer_norm(x.transpose(1, 2), P[f"{p}.layer_norm.weight"],
                       P[f"{p}.layer_norm.bias"], prec)
        x = act(gelu(x), prec).transpose(1, 2)
    return act(interpolate(x, d["frames"]), prec).transpose(1, 2)


def forward(P: dict, wave: torch.Tensor, d: dict, *, prec: str = "fp32",
            drop: Dropout | None = None, seed: int | None = None):
    """wave [B, S] → [B, frames, output_dim]; dropout where `seed` (the
    step's root seed) and `drop` are given."""
    drop = drop or Dropout(wave.shape[0])
    s_proj, s_pos, s_layers = split_or_none(seed, 3)
    H, heads, L = d["hidden"], d["heads"], d["layers"]
    h = H // heads
    with torch.set_grad_enabled(torch.is_grad_enabled() and not d["frozen"]):
        x = frontend(P, wave, d, prec)
    x = layer_norm(x, P["feature_projection.layer_norm.weight"],
                   P["feature_projection.layer_norm.bias"], prec)
    x = drop(linear(P, "feature_projection.projection", x, prec), s_proj,
             FEAT_PROJ_DROPOUT)

    p = "encoder.pos_conv_embed.conv"
    v = P[f"{p}.weight_v"]
    w = v * (P[f"{p}.weight_g"] / v.norm(dim=(0, 1), keepdim=True))
    B, T, _ = x.shape
    y = conv1d(x.transpose(1, 2), w, P[f"{p}.bias"], prec,
               padding=d["pos_kernel"] // 2, groups=d["pos_groups"])
    y = act(gelu(act(y[..., :T], prec)), prec).transpose(1, 2)
    x = drop(act(x + y, prec), s_pos, d["dropout"])

    for i, s in enumerate(split_or_none(s_layers, L)):
        p = f"encoder.layers.{i}"
        s_attn, s_d1, s_ffn, s_d2 = split_or_none(s, 4)
        s_weights, _ = split_or_none(s_attn, 2)
        a = layer_norm(x, P[f"{p}.layer_norm.weight"],
                       P[f"{p}.layer_norm.bias"], prec)
        q, k, vv = (linear(P, f"{p}.attention.{n}_linear", a, prec)
                    .reshape(B, T, heads, h).transpose(1, 2)
                    for n in ("q", "k", "v"))
        sc = act(matmul(q, k.transpose(-1, -2), prec) / math.sqrt(h), prec)
        wts = act(torch.softmax(sc, dim=-1), prec)
        o = act(matmul(drop(wts, s_weights, d["dropout"]), vv,
                       prec), prec)
        o = linear(P, f"{p}.attention.out_linear",
                   o.transpose(1, 2).reshape(B, T, H), prec)
        x = act(x + drop(o, s_d1, d["dropout"]), prec)
        f = layer_norm(x, P[f"{p}.final_layer_norm.weight"],
                       P[f"{p}.final_layer_norm.bias"], prec)
        f = act(gelu(linear(P, f"{p}.feed_forward.intermediate_dense", f,
                            prec)), prec)
        f = linear(P, f"{p}.feed_forward.output_dense",
                   drop(f, s_ffn, d["dropout"]), prec)
        x = act(x + drop(f, s_d2, d["dropout"]), prec)
    x = layer_norm(x, P["encoder.layer_norm.weight"],
                   P["encoder.layer_norm.bias"], prec)
    return linear(P, "fc_output", x, prec).float()


# ---------------------------------------------------------------------------
# loss and optimiser


def _abs(x):
    """|x| with derivative +1 at 0."""
    return torch.where(x >= 0, x, -x)


def loss_fn(pred, target, delta: float = 1.0):
    diff = _abs(pred - target)
    rec = torch.where(diff < delta, 0.5 * diff * diff / delta,
                      diff - 0.5 * delta).mean()
    dp = pred[:, 1:] - pred[:, :-1]
    dt = target[:, 1:] - target[:, :-1]
    temporal = _abs(dp - dt).mean()
    nx = torch.sqrt((dp * dp).sum(-1) + 1e-24).clamp(min=1e-8)
    ny = torch.sqrt((dt * dt).sum(-1) + 1e-24).clamp(min=1e-8)
    direction = 1.0 - ((dp * dt).sum(-1) / (nx * ny)).mean()
    return rec + temporal + direction


def train_steps(weights: dict, batches, seeds, d: dict, opt: dict, *,
                prec: str = "fp32", rows: int = 64) -> dict:
    """len(batches) training steps from `weights` (name → float32 tensor on
    the device); batches: [(wave, trg)] on the device, seeds: each step's
    root seed. The batch runs in blocks of `rows` rows whose gradients add
    up to the batch's (every term of the loss is a mean over rows). The
    frozen leaves take no gradient and no Adam state.

    Returns per trainable leaf: 'grad1' (step 1's gradient norm before the
    clip), 'm1' (Adam's first moment after step 1), 'delta' (the change
    over all the steps); and 'losses'."""
    P = {k: v.detach().clone().requires_grad_(not frozen(k, d))
         for k, v in weights.items()}
    keys = [k for k in P if not frozen(k, d)]
    start = {k: P[k].detach().clone() for k in keys}
    m = {k: torch.zeros_like(v) for k, v in start.items()}
    v2 = {k: torch.zeros_like(v) for k, v in start.items()}
    out: dict = {"losses": []}
    for t, ((wave, trg), seed) in enumerate(zip(batches, seeds), start=1):
        B = wave.shape[0]
        grads = {k: torch.zeros_like(start[k]) for k in keys}
        loss = 0.0
        for r0 in range(0, B, rows):
            s, y = wave[r0:r0 + rows], trg[r0:r0 + rows]
            pred = forward(P, s, d, prec=prec, drop=Dropout(B, r0),
                           seed=seed)
            part = loss_fn(pred, y, opt["delta"]) * (s.shape[0] / B)
            gs = torch.autograd.grad(part, [P[k] for k in keys])
            for k, g in zip(keys, gs):
                grads[k] += g
            loss += float(part.detach())
        out["losses"].append(loss)
        if t == 1:
            out["grad1"] = {k: float(g.norm()) for k, g in grads.items()}
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        factor = torch.where(norm < opt["grad_clip"], 1.0,
                             opt["grad_clip"] / norm)
        with torch.no_grad():
            for k in keys:
                g = grads[k] * factor + opt["weight_decay"] * P[k]
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                mh = m[k] / (1 - BETAS[0] ** t)
                vh = v2[k] / (1 - BETAS[1] ** t)
                P[k] -= opt["lr"] * mh / (torch.sqrt(vh) + ADAM_EPS)
        if t == 1:
            out["m1"] = {k: float(m[k].norm()) for k in keys}
        del grads
    out["delta"] = {k: float((P[k].detach() - start[k]).norm())
                    for k in keys}
    return out

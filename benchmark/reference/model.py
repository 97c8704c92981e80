"""The plain reference of the NeuroSync Seq2Seq: forward, loss, backward,
clip and Adam, in float32 PyTorch with TF32 off.

Written from the published architecture (the reference repository's
``utils/model.py``, ``utils/training_utils.py`` and ``utils/model_utils.py``)
and from nothing of the port: no kernel, no cache, no batching trick,
autograd for every gradient.

- Encoder: Linear embedding, RoPE over the model width, n_layers post-LN
  layers of [self-attention, ReLU FFN (4x)], a final LayerNorm.
- Decoder: the encoder output, RoPE'd, is its input stream, and the
  un-rotated encoder output is the cross-attention memory; n_layers post-LN
  layers of [self-attention, cross-attention, FFN], a LayerNorm, a Linear.
- Attention: per-head RoPE on q and k (pairs of interleaved features, base
  10000), softmax(q·kᵀ/√h), dropout on the weights, ·v, the output
  projection, dropout; the layer drops the attention's output again (the
  reference's double dropout).
- Loss: SmoothL1(β=delta) + L1 of the frame deltas + (1 − mean cosine of
  the frame deltas), the reference's active loss.
- Optimiser: the global-norm clip (g·max/‖g‖ where ‖g‖ ≥ max), then Adam
  with L2 weight decay added to the gradient (torch.optim.Adam's), at the
  schedule's first-epoch rate.

Dropout is inverted dropout with the masks of a stated convention, which a
reference has to share with the program to follow its steps: each site's
keep mask is uint8 bits from a Philox generator seeded with the site's seed,
kept where bits ≥ q = round(rate·256), scaled by 256/(256 − q); the sites'
seeds form a tree split from one seed a step (step_seed, split_seed). The
bits come from the card's generator, so the masks are drawn on the device
that the program trained on.

The control computes in float8 e4m3, the step below the bf16 that the
configurations state (one scale a tensor, its largest magnitude to 448):
`prec='fp8'` rounds every operand of every product (the linears and both
attention products, forward and backward) and every activation where the
bf16 program rounds to bf16 (each layer's outputs, scores, weights,
residual sums, LayerNorm outputs, forward and backward), and
`prec='fp8mm'` the products' operands alone, with float32 everywhere else.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LN_EPS = 1e-5
SEED_HIGH = 1 << 62
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def plain_precision() -> None:
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def param_shapes(d: dict) -> dict:
    """Every parameter's name (the reference checkpoint's keys) and shape."""
    h, f, L = d["hidden"], d["ffn"], d["layers"]
    out: dict = {}

    def lin(name, n_in, n_out):
        out[f"{name}.weight"] = (n_out, n_in)
        out[f"{name}.bias"] = (n_out,)

    def ln(name):
        out[f"{name}.weight"] = (h,)
        out[f"{name}.bias"] = (h,)

    def attn(name):
        for p in ("q", "k", "v", "out"):
            lin(f"{name}.{p}_linear", h, h)

    lin("encoder.embedding", d["input_dim"], h)
    for i in range(L):
        p = f"encoder.transformer_encoder.{i}"
        attn(f"{p}.self_attn")
        lin(f"{p}.ffn.linear1", h, f)
        lin(f"{p}.ffn.linear2", f, h)
        ln(f"{p}.norm1")
        ln(f"{p}.norm2")
    ln("encoder.layer_norm")
    for i in range(L):
        p = f"decoder.transformer_decoder.{i}"
        attn(f"{p}.self_attn")
        attn(f"{p}.multihead_attn")
        lin(f"{p}.ffn.linear1", h, f)
        lin(f"{p}.ffn.linear2", f, h)
        for j in (1, 2, 3):
            ln(f"{p}.norm{j}")
    lin("decoder.fc_output", h, d["output_dim"])
    ln("decoder.layer_norm")
    return out


# ---------------------------------------------------------------------------
# dropout's seed tree and masks


def split_seed(seed: int, n: int) -> list[int]:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, SEED_HIGH, (n,), generator=g).tolist()


def step_seed(run_seed: int, batch_step: int) -> int:
    """The root seed of training step `batch_step`: a generator seeded from
    (run_seed + 1, batch_step) through numpy's SeedSequence, and one draw."""
    root = np.random.SeedSequence([run_seed + 1, batch_step]).generate_state(
        1, np.uint64)[0]
    g = torch.Generator().manual_seed(int(root) >> 1)
    return int(torch.randint(0, SEED_HIGH, (1,), generator=g).item())


class Dropout:
    """The masks of one forward: rows [r0, r0 + rows) of a batch of
    `batch` rows, at `rate`; seed None or rate 0 drops nothing."""

    def __init__(self, rate: float, batch: int, r0: int = 0):
        self.q = int(round(rate * 256))
        self.batch, self.r0 = batch, r0

    def __call__(self, x: torch.Tensor, seed) -> torch.Tensor:
        if seed is None or self.q <= 0:
            return x
        shape = (self.batch, *x.shape[1:])
        g = torch.Generator(device=x.device)
        g.manual_seed(seed)
        bits = torch.empty(shape, dtype=torch.uint8, device=x.device)
        bits.random_(generator=g)
        keep = bits[self.r0: self.r0 + x.shape[0]] >= self.q
        return torch.where(keep, x * (256.0 / (256 - self.q)), 0.0)


# ---------------------------------------------------------------------------
# products


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


class _Fp8Round(torch.autograd.Function):
    """An activation stored in float8: rounded forward, and its gradient
    rounded backward, as a cast to the compute type rounds both."""

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


def act(x, prec: str):
    """x as the compute type holds it: as is but under 'fp8'."""
    return _Fp8Round.apply(x) if prec == "fp8" else x


# ---------------------------------------------------------------------------
# the model


def _rope(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Rotate interleaved pairs of each `dim`-wide group of x's last axis;
    pair i of a group at position p turns by p·10000^(−2i/dim)."""
    T, W = x.shape[-2], x.shape[-1]
    pos = torch.arange(T, dtype=torch.float64)[:, None]
    inv = 10000.0 ** (-torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    ang = pos * inv[None, :]
    cos = torch.cos(ang).to(x.dtype).to(x.device)[:, None, :]
    sin = torch.sin(ang).to(x.dtype).to(x.device)[:, None, :]
    xr = x.reshape(*x.shape[:-1], W // dim, dim // 2, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return out.reshape(x.shape)


def _linear(P, name, x, prec):
    w = P[f"{name}.weight"]
    y = matmul(x.reshape(-1, x.shape[-1]), w.t(), prec) + P[f"{name}.bias"]
    return act(y.reshape(*x.shape[:-1], w.shape[0]), prec)


def _layer_norm(P, name, x, prec):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return act((x - mean) / torch.sqrt(var + LN_EPS) * P[f"{name}.weight"]
               + P[f"{name}.bias"], prec)


def _attention(P, name, xq, xkv, heads, prec, drop, seed):
    s_weights, s_out = (None, None) if seed is None else split_seed(seed, 2)
    B, Tq, H = xq.shape
    Tk, h = xkv.shape[1], H // heads
    q = act(_rope(_linear(P, f"{name}.q_linear", xq, prec), h), prec)
    k = act(_rope(_linear(P, f"{name}.k_linear", xkv, prec), h), prec)
    v = _linear(P, f"{name}.v_linear", xkv, prec)
    q = q.reshape(B, Tq, heads, h).transpose(1, 2)
    k = k.reshape(B, Tk, heads, h).transpose(1, 2)
    v = v.reshape(B, Tk, heads, h).transpose(1, 2)
    s = act(matmul(q, k.transpose(-1, -2), prec) / math.sqrt(h), prec)
    w = act(torch.softmax(s, dim=-1), prec)
    o = act(matmul(drop(w, s_weights), v, prec), prec)
    o = o.transpose(1, 2).reshape(B, Tq, H)
    return drop(_linear(P, f"{name}.out_linear", o, prec), s_out)


def _ffn(P, name, x, prec, drop, seed):
    hid = torch.relu(_linear(P, f"{name}.linear1", x, prec))
    return _linear(P, f"{name}.linear2", drop(hid, seed), prec)


def forward(P: dict, src: torch.Tensor, d: dict, *, prec: str = "fp32",
            drop: Dropout | None = None, seed: int | None = None):
    """src [B, T, input_dim] → [B, T, output_dim]; dropout where `seed`
    (the step's root seed) and `drop` are given."""
    drop = drop or Dropout(0.0, src.shape[0])
    s_enc, s_dec = (None, None) if seed is None else split_seed(seed, 2)
    L, heads, H = d["layers"], d["heads"], d["hidden"]
    enc_seeds = [None] * L if s_enc is None else split_seed(s_enc, L)
    dec_seeds = [None] * L if s_dec is None else split_seed(s_dec, L)

    def add(x, y):
        return act(x + y, prec)

    x = act(_rope(_linear(P, "encoder.embedding", act(src, prec), prec), H),
            prec)
    for i, s in enumerate(enc_seeds):
        p = f"encoder.transformer_encoder.{i}"
        sa, s1, sf, s2 = [None] * 4 if s is None else split_seed(s, 4)
        a = _attention(P, f"{p}.self_attn", x, x, heads, prec, drop, sa)
        x = _layer_norm(P, f"{p}.norm1", add(x, drop(a, s1)), prec)
        f = _ffn(P, f"{p}.ffn", x, prec, drop, sf)
        x = _layer_norm(P, f"{p}.norm2", add(x, drop(f, s2)), prec)
    memory = _layer_norm(P, "encoder.layer_norm", x, prec)

    x = act(_rope(memory, H), prec)
    for i, s in enumerate(dec_seeds):
        p = f"decoder.transformer_decoder.{i}"
        ss, s1, sc, s2, sf, s3 = [None] * 6 if s is None else split_seed(s, 6)
        a = _attention(P, f"{p}.self_attn", x, x, heads, prec, drop, ss)
        x = _layer_norm(P, f"{p}.norm1", add(x, drop(a, s1)), prec)
        c = _attention(P, f"{p}.multihead_attn", x, memory, heads, prec, drop,
                       sc)
        x = _layer_norm(P, f"{p}.norm2", add(x, drop(c, s2)), prec)
        f = _ffn(P, f"{p}.ffn", x, prec, drop, sf)
        x = _layer_norm(P, f"{p}.norm3", add(x, drop(f, s3)), prec)
    x = _layer_norm(P, "decoder.layer_norm", x, prec)
    return _linear(P, "decoder.fc_output", x, prec).float()


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
    the device); batches: [(src, trg)] on the device, seeds: each step's
    root seed. The batch runs in blocks of `rows` rows whose gradients add
    up to the batch's (every term of the loss is a mean over rows).

    Returns per-leaf norms: 'grad1' (step 1's gradient before the clip),
    'm1' (Adam's first moment after step 1), 'delta' (the parameters'
    change over all the steps), and 'losses'."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in
         weights.items()}
    start = {k: v.detach().clone() for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in start.items()}
    v2 = {k: torch.zeros_like(v) for k, v in start.items()}
    keys = list(P)
    out: dict = {"losses": []}
    for t, ((src, trg), seed) in enumerate(zip(batches, seeds), start=1):
        B = src.shape[0]
        grads = {k: torch.zeros_like(start[k]) for k in keys}
        loss = 0.0
        for r0 in range(0, B, rows):
            s, y = src[r0:r0 + rows], trg[r0:r0 + rows]
            drop = Dropout(opt["dropout"], B, r0)
            pred = forward(P, s, d, prec=prec, drop=drop, seed=seed)
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


@torch.no_grad()
def eval_forward(weights: dict, src: torch.Tensor, d: dict, *,
                 prec: str = "fp32", rows: int = 64) -> torch.Tensor:
    """Serving's forward (no dropout) of src [N, T, input_dim], in blocks
    of `rows` rows."""
    return torch.cat([forward(weights, src[r0:r0 + rows], d, prec=prec)
                      for r0 in range(0, src.shape[0], rows)])

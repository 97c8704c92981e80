"""Multi-head attention with per-head RoPE, dropout and the lean training
cores, in PyTorch.

Port of neurosync_trainer_lite_tpu/ops/attention.py. Rounding follows the
JAX path:

- _linear accumulates in fp32, adds the fp32 bias, then rounds once to the
  compute type. In bf16 it is an autograd Function with the rounding points
  of JAX's transposed dots: dx rounded to bf16 once, the bias gradient
  summed in fp32, the weight gradient rounded to bf16 once and widened to
  the fp32 parameter (the transpose of w.astype(x.dtype)). Its products go
  through _mm_f32: torch.mm with an fp32 output on the card (that overload
  has no derivative, hence the Function), widened operands on the CPU (the
  products of bf16 values are exact in fp32).
- bf16 scores are rounded to bf16, scaled by the bf16 scale, softmaxed in
  fp32 and rounded to bf16; weights·v accumulates in fp32 and rounds once.
- Training in bf16 runs _sdpa_lean_core, whose backward recomputes the
  scores, the softmax and the dropout mask from (q, k, v, seed) with bf16
  scores and ds and fp32 softmax statistics, as the JAX custom VJP does.
- sdpa takes the flash-attention kernel K3 (ops/flash_attention.py), fp32
  inside, where the JAX sdpa takes its Pallas flash kernel: long key
  strips at 'auto', any length at 'pallas', never with attention dropout;
  and only at the head widths K3 takes (multiples of 16 up to 128), where
  the JAX kernel takes any.

Dropout keeps JAX's uint8 thresholds: q = round(rate * 256), keep iff
bits >= q, scale 256 / (256 - q). JAX draws the bits from jax keys, which
torch cannot redraw: the port draws them from a generator seeded with a
per-site integer seed (Philox on the card), and its backward redraws the
mask from the saved seed instead of keeping it. Per-site seeds come from the
training step's torch.Generator through split_seed, in the tree shape of the
JAX keys (seq2seq → layers → sites → attention and residual).

Data parallelism: a JAX mask is a function of the key and the global shape,
whatever the sharding. Under dropout_rows(n, i) a rank holding one of n
equal row blocks of a micro-batch draws the global micro-batch's bits
(n times its own rows, from the same per-site seed) and keeps block i, so
its masks are the rows of the one-process masks (the training step sets
it; parallel/mesh.py:batch_rows lays the rows out to match).
"""

from __future__ import annotations

import contextlib

import torch

from neurosync_trainer_lite_tpu_torch.ops import flash_attention as fa
from neurosync_trainer_lite_tpu_torch.ops import fused_attention as fua
from neurosync_trainer_lite_tpu_torch.ops.rope import rope_qk_preheads

_SEED_HIGH = 1 << 62


def split_seed(seed: int, n: int) -> list[int]:
    """n child seeds of `seed`, a pure function of both (jax.random.split)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, _SEED_HIGH, (n,), generator=g).tolist()


def split_or_none(seed, n: int) -> list:
    return [None] * n if seed is None else split_seed(seed, n)


def draw_seed(generator: torch.Generator) -> int:
    """One seed from a step's generator (the root of a forward's sites)."""
    return int(torch.randint(0, _SEED_HIGH, (1,), generator=generator,
                             device=generator.device).item())


def _bf16_value(v: float) -> float:
    """v rounded to bf16, as jnp.asarray(v, jnp.bfloat16): bf16 tensors
    multiplied by it round once, as bf16 * bf16 does in JAX."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two bf16 matrices, accumulated and returned in fp32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _LinearBf16(torch.autograd.Function):
    """x2 [N, in] bf16 @ weight[out, in]ᵀ + bias, JAX's rounding points."""

    @staticmethod
    def forward(ctx, x2, weight, bias):
        w = weight.to(x2.dtype)
        ctx.save_for_backward(x2, w)
        return (_mm_f32(x2, w.t()) + bias.float()).to(x2.dtype)

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        dx = _mm_f32(dy, w).to(x2.dtype)
        dw = _mm_f32(dy.t(), x2).to(x2.dtype).float()
        return dx, dw, dy.float().sum(0)


def _linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor):
    """x [..., in] @ weight[out, in]ᵀ + bias, fp32 accumulation, one rounding."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        y = x2 @ weight.t() + bias
    else:
        y = _LinearBf16.apply(x2, weight, bias)
    return y.reshape(*x.shape[:-1], weight.shape[0])


def _matmul_round_once(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for bf16 operands with fp32 accumulation and one bf16 rounding."""
    if a.is_cuda:
        return torch.matmul(a, b)
    return torch.matmul(a.float(), b.float()).to(a.dtype)


# ---------------------------------------------------------------------------
# dropout


def dropout_mask_q(rate: float) -> int:
    """rate → the shared uint8 drop threshold (keep iff bits >= q)."""
    return int(round(rate * 256))


#: (n, i): every mask is row block i of a draw over n times its rows. A
#: process-wide setting, not a thread-local: the backward and the remat
#: recompute run on autograd's device threads, inside the step that set it.
_ROW_BLOCK = (1, 0)


@contextlib.contextmanager
def dropout_rows(n_blocks: int, index: int):
    """Inside the block, every dropout draw covers n_blocks times the rows
    (the leading dimension) it is asked for and keeps the index-th block of
    them: a rank's rows of the global micro-batch's masks."""
    global _ROW_BLOCK
    if not 0 <= index < n_blocks:
        raise ValueError(f"row block {index} of {n_blocks}")
    saved, _ROW_BLOCK = _ROW_BLOCK, (n_blocks, index)
    try:
        yield
    finally:
        _ROW_BLOCK = saved


def dropout_keep(seed: int, shape, q: int, device) -> torch.Tensor:
    """The shared keep-mask draw: uint8 bits from a generator seeded with
    `seed`, keep iff bits >= q. A pure function of (seed, shape, device)
    and the row block (dropout_rows), so every caller redrawing with the
    same seed gets the same mask."""
    n, i = _ROW_BLOCK
    rows = shape[0]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    bits = torch.empty((n * rows, *shape[1:]), dtype=torch.uint8,
                       device=device)
    bits.random_(generator=g)
    return bits[i * rows: (i + 1) * rows] >= q


def _drop(x: torch.Tensor, keep: torch.Tensor, q: int) -> torch.Tensor:
    """where(keep, x * scale, 0) with the scale in x's type, as JAX."""
    scale = 256.0 / (256 - q)
    if x.dtype == torch.bfloat16:
        scale = _bf16_value(scale)
    return torch.where(keep, x * scale, 0)


class _DropoutCore(torch.autograd.Function):
    """Inverted dropout whose backward redraws the mask from the seed."""

    @staticmethod
    def forward(ctx, x, seed, q):
        ctx.seed, ctx.q = seed, q
        return _drop(x, dropout_keep(seed, x.shape, q, x.device), q)

    @staticmethod
    def backward(ctx, dy):
        keep = dropout_keep(ctx.seed, dy.shape, ctx.q, dy.device)
        return _drop(dy, keep, ctx.q), None, None


def dropout(x: torch.Tensor, rate: float, seed, train: bool) -> torch.Tensor:
    """Inverted dropout (torch.nn.Dropout semantics) with uint8 thresholds."""
    if not train or rate == 0.0 or seed is None:
        return x
    q = dropout_mask_q(rate)
    if q <= 0:
        return x
    if q >= 256:  # rate ≈ 1.0: everything dropped (torch nn.Dropout(1.0))
        return torch.zeros_like(x)
    return _DropoutCore.apply(x, seed, q)


# ---------------------------------------------------------------------------
# the bf16 softmax and the lean attention core


class _SoftmaxResidualBf16(torch.autograd.Function):
    """softmax of bf16 logits with fp32 statistics, bf16 out, and a bf16
    residual; the backward ds = w·(dw − Σ dw·w) runs in fp32."""

    @staticmethod
    def forward(ctx, s):
        w = torch.softmax(s.float(), dim=-1).to(torch.bfloat16)
        ctx.save_for_backward(w)
        return w

    @staticmethod
    def backward(ctx, dw):
        (w,) = ctx.saved_tensors
        wf, dwf = w.float(), dw.float()
        return (wf * (dwf - (dwf * wf).sum(-1, keepdim=True))).to(torch.bfloat16)


def _lean_weights(q, k, seed, scale, qthresh):
    """The forward chain up to the dropped weights: (w, wd, keep)."""
    s = _matmul_round_once(q, k.transpose(-1, -2)) * _bf16_value(scale)
    w = torch.softmax(s.float(), dim=-1).to(torch.bfloat16)
    if qthresh == 0:
        return w, w, None
    keep = dropout_keep(seed, w.shape, qthresh, w.device)
    return w, _drop(w, keep, qthresh), keep


class _SdpaLeanCore(torch.autograd.Function):
    """bf16 training attention: scores → softmax → weight dropout → ·v, with
    only (q, k, v, seed) kept for the backward, which recomputes the rest."""

    @staticmethod
    def forward(ctx, q, k, v, seed, scale, qthresh):
        ctx.save_for_backward(q, k, v)
        ctx.seed, ctx.scale, ctx.qthresh = seed, scale, qthresh
        _, wd, _ = _lean_weights(q, k, seed, scale, qthresh)
        return _matmul_round_once(wd, v)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        w, wd, keep = _lean_weights(q, k, ctx.seed, ctx.scale, ctx.qthresh)
        dv = _matmul_round_once(wd.transpose(-1, -2), dout)
        dw = _matmul_round_once(dout, v.transpose(-1, -2))
        if keep is not None:
            dw = _drop(dw, keep, ctx.qthresh)
        wf, dwf = w.float(), dw.float()
        ds = (wf * (dwf - (dwf * wf).sum(-1, keepdim=True))).to(torch.bfloat16)
        ds = ds * _bf16_value(ctx.scale)
        dq = _matmul_round_once(ds, k)
        dk = _matmul_round_once(ds.transpose(-1, -2), q)
        return dq, dk, dv, None, None, None


def sdpa(q, k, v, *, dropout_rate: float = 0.0, seed=None, train: bool = False,
         impl: str = "auto"):
    """Scaled dot-product attention. q, k, v: [B, n, T, h].

    As the JAX sdpa: 'auto' takes the flash kernel K3 (ops/flash_attention.py)
    from kv_len MIN_KV_LEN_AUTO, 'pallas' at any length, both only where it
    applies (no active attention dropout, kv_len <= MAX_KV_LEN); the rest
    takes the composed path. One stated difference: a head width K3 does not
    take (not a multiple of 16, or above 128: fa.HEAD_DIMS) takes the
    composed path too, where the JAX kernel takes any width. CPU and card
    take the same branch."""
    scale = q.shape[-1] ** -0.5
    kv_len = k.shape[-2]
    use_flash = impl == "pallas" or (impl == "auto"
                                     and kv_len >= fa.MIN_KV_LEN_AUTO)
    if use_flash and fa.supports(kv_len, dropout_rate if train else 0.0, seed,
                                 head_dim=q.shape[-1]):
        return fa.flash_attention(q, k, v, scale)
    kt = k.transpose(-1, -2)
    if v.dtype == torch.bfloat16:
        if train:
            drop = dropout_rate > 0.0 and seed is not None
            qthresh = dropout_mask_q(dropout_rate) if drop else 0
            if qthresh < 256:  # rate ≈ 1.0 takes the composed path's zeros
                return _SdpaLeanCore.apply(q, k, v, seed, scale, qthresh)
        scores = _matmul_round_once(q, kt) * _bf16_value(scale)
        weights = _SoftmaxResidualBf16.apply(scores)
        weights = dropout(weights, dropout_rate, seed, train)
        return _matmul_round_once(weights, v)
    scores = torch.matmul(q, kt) * scale
    weights = torch.softmax(scores.float(), dim=-1)
    weights = dropout(weights, dropout_rate, seed, train)
    return torch.matmul(weights.to(v.dtype), v)


def multi_head_attention(p, query, key, value, *, num_heads: int,
                         dropout_rate: float = 0.0, seed=None,
                         train: bool = False, use_rope: bool = True,
                         impl: str = "auto"):
    """p has q_linear, k_linear, v_linear, out_linear (weight [H, H], bias [H]).

    query [B, Tq, H], key/value [B, Tk, H] → [B, Tq, H]. In training, `seed`
    splits into the attention-weight and the residual dropout sites.
    """
    B, Tq, H = query.shape
    h = H // num_heads
    q = _linear(query, p.q_linear.weight, p.q_linear.bias)
    k = _linear(key, p.k_linear.weight, p.k_linear.bias)
    v = _linear(value, p.v_linear.weight, p.v_linear.bias)
    seed_attn, seed_resid = split_or_none(seed if train else None, 2)

    drop_active = train and dropout_rate > 0.0 and seed_attn is not None
    Tk = k.shape[1]
    if (impl == "pallas" and not drop_active and use_rope
            and fua.fits_smem(Tq, Tk, h, q.element_size()) and h % 2 == 0):
        # RoPE + per-head scores/softmax/·v in one kernel on unsplit [B, T, H]
        tables = fua.make_tables(Tq, Tk, h, num_heads, q.device)
        out = fua.fused_rope_attention(q, k, v, tables, num_heads, h ** -0.5)
    else:
        if use_rope:
            q, k = rope_qk_preheads(q, k, num_heads)

        def split_heads(x):
            return x.reshape(B, x.shape[1], num_heads, h).transpose(1, 2)

        out = sdpa(split_heads(q), split_heads(k), split_heads(v),
                   dropout_rate=dropout_rate, seed=seed_attn, train=train,
                   impl=impl)
        out = out.transpose(1, 2).reshape(B, Tq, H)
    out = _linear(out, p.out_linear.weight, p.out_linear.bias)
    return dropout(out, dropout_rate, seed_resid, train)

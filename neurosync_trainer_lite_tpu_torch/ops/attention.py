"""Multi-head attention with per-head RoPE, dropout and the lean training
cores, in PyTorch.

Port of neurosync_trainer_lite_tpu/ops/attention.py. Rounding follows the
JAX path:

- _linear accumulates in fp32, adds the fp32 bias, then rounds once to the
  compute type. It is an autograd Function with the rounding points of
  JAX's transposed dots, in bf16: dx rounded to bf16 once, the bias gradient
  summed in fp32, the weight gradient rounded to bf16 once and widened to
  the fp32 parameter (the transpose of w.astype(x.dtype)). Its products go
  through _mm_f32: torch.mm with an fp32 output on the card (that overload
  has no derivative, hence the Function), widened operands on the CPU (the
  products of bf16 values are exact in fp32).
- bf16 scores are rounded to bf16, scaled by the bf16 scale, softmaxed in
  fp32 and rounded to bf16; weights·v accumulates in fp32 and rounds once.
- Training in bf16 runs _SdpaLeanCore, whose backward recomputes the
  scores, the softmax and the dropout mask from (q, k, v, seed) with bf16
  scores and ds and fp32 softmax statistics, as the JAX custom VJP does;
  on the card one hand-written kernel a pass (ops/lean_attention.py,
  csrc/lean_attention.cu) at windows up to 128 and the head widths K3
  takes, the plain pair below beyond (lean_attention.supports).
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

The rank mesh: a JAX mask is a function of the key and the global shape,
whatever the sharding. Under dropout_rows(n, i, nw, j) a rank holding row
block i of n of a micro-batch ('data') and width block j of nw of the
model ('model') draws the global micro-batch's bits at the global width
(from the same per-site seed) and keeps its block: its rows of every mask,
and of a mask over a sharded width its block there too, the heads (dim 1)
of an attention-weight mask and the columns (the last dim) of the FFN
hidden mask; a residual mask over the replicated model width is kept
whole. So its masks are blocks of the one-process masks (the training step
sets it; parallel/mesh.py:batch_rows lays the rows out to match).
"""

from __future__ import annotations

import contextlib
import functools

import torch

from neurosync_trainer_lite_tpu_torch.ops import flash_attention as fa
from neurosync_trainer_lite_tpu_torch.ops import fused_attention as fua
from neurosync_trainer_lite_tpu_torch.ops import lean_attention as la
from neurosync_trainer_lite_tpu_torch.ops.rope import rope_qk_preheads
from neurosync_trainer_lite_tpu_torch.parallel.tensor import reduce_model_

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


@functools.lru_cache(maxsize=None)
def _bf16_value(v: float) -> float:
    """v rounded to bf16, as jnp.asarray(v, jnp.bfloat16): bf16 tensors
    multiplied by it round once, as bf16 * bf16 does in JAX. Cached: the
    few scales a model uses are asked for hundreds of times a step."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two bf16 matrices, accumulated and returned in fp32 (of two
    fp32 matrices, their product)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _Linear(torch.autograd.Function):
    """x2 [N, in] @ weight[out, in]ᵀ + bias, JAX's rounding points. Under a
    mesh it is this rank's block of a Megatron linear over the 'model'
    group (parallel/tensor.py): a 'row' one sums its fp32 partial product
    over 'model' before the bias and the rounding, a 'column' one sums dx's
    fp32 partial before dx's rounding."""

    @staticmethod
    def forward(ctx, x2, weight, bias, mesh, kind):
        w = weight.to(x2.dtype)
        ctx.save_for_backward(x2, w)
        ctx.mesh = mesh if kind == "column" else None
        y = _mm_f32(x2, w.t())
        if kind == "row":
            y = reduce_model_(y, mesh, "forward")
        return (y + bias.float()).to(x2.dtype)

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        dx = reduce_model_(_mm_f32(dy, w), ctx.mesh, "backward").to(x2.dtype)
        dw = _mm_f32(dy.t(), x2)
        if x2.dtype != torch.float32:
            dw = dw.to(x2.dtype).float()
        return dx, dw, dy.float().sum(0), None, None


def _linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            mesh=None, kind: str | None = None):
    """x [..., in] @ weight[out, in]ᵀ + bias, fp32 accumulation, one
    rounding; with a mesh, this rank's block of a 'column' or 'row'
    parallel linear."""
    x2 = x.reshape(-1, x.shape[-1])
    y = _Linear.apply(x2, weight, bias, mesh, kind)
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


#: (n, i, nw, j): every mask is row block i of a draw over n times its
#: rows and, over a sharded width, width block j of nw. A process-wide
#: setting, not a thread-local: the backward and the remat recompute run on
#: autograd's device threads, inside the step that set it.
_BLOCKS = (1, 0, 1, 0)


@contextlib.contextmanager
def dropout_rows(n_blocks: int, index: int, width_blocks: int = 1,
                 width_index: int = 0):
    """Inside the block, every dropout draw covers n_blocks times the rows
    (the leading dimension) it is asked for and keeps the index-th block of
    them, and a draw over a sharded width (dropout_keep's split_dim) covers
    width_blocks times that width and keeps its width_index-th block: a
    rank's block of the global micro-batch's masks."""
    global _BLOCKS
    for i, n in ((index, n_blocks), (width_index, width_blocks)):
        if not 0 <= i < n:
            raise ValueError(f"block {i} of {n}")
    saved = _BLOCKS
    _BLOCKS = (n_blocks, index, width_blocks, width_index)
    try:
        yield
    finally:
        _BLOCKS = saved


def dropout_bits(seed: int, shape, device,
                 split_dim: int | None = None) -> torch.Tensor:
    """The shared mask draw: uint8 bits of `shape` from a generator seeded
    with `seed`. A pure function of (seed, shape, device, split_dim) and the
    blocks (dropout_rows), so every caller redrawing with the same seed gets
    the same bits. split_dim: the dim of `shape` that holds this rank's
    block of a width sharded over 'model'. The bits are a view of the
    global draw: rows (dim 0) a contiguous block of it, a split_dim block
    strided."""
    n, i, nw, j = _BLOCKS
    full = [*shape]
    full[0] *= n
    if split_dim is not None:
        full[split_dim] *= nw
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    bits = torch.empty(full, dtype=torch.uint8, device=device)
    bits.random_(generator=g)
    bits = bits.narrow(0, i * shape[0], shape[0])
    if split_dim is not None:
        bits = bits.narrow(split_dim, j * shape[split_dim], shape[split_dim])
    return bits


def dropout_keep(seed: int, shape, q: int, device,
                 split_dim: int | None = None) -> torch.Tensor:
    """The shared keep mask: keep iff dropout_bits(...) >= q."""
    return dropout_bits(seed, shape, device, split_dim) >= q


def _drop(x: torch.Tensor, keep: torch.Tensor, q: int) -> torch.Tensor:
    """where(keep, x * scale, 0) with the scale in x's type, as JAX."""
    scale = 256.0 / (256 - q)
    if x.dtype == torch.bfloat16:
        scale = _bf16_value(scale)
    return torch.where(keep, x * scale, 0)


class _DropoutCore(torch.autograd.Function):
    """Inverted dropout whose backward redraws the mask from the seed."""

    @staticmethod
    def forward(ctx, x, seed, q, split_dim):
        ctx.seed, ctx.q, ctx.split_dim = seed, q, split_dim
        return _drop(x, dropout_keep(seed, x.shape, q, x.device, split_dim),
                     q)

    @staticmethod
    def backward(ctx, dy):
        keep = dropout_keep(ctx.seed, dy.shape, ctx.q, dy.device,
                            ctx.split_dim)
        return _drop(dy, keep, ctx.q), None, None, None


def dropout(x: torch.Tensor, rate: float, seed, train: bool,
            split_dim: int | None = None) -> torch.Tensor:
    """Inverted dropout (torch.nn.Dropout semantics) with uint8 thresholds;
    split_dim: the dim that holds a width sharded over 'model'
    (dropout_keep)."""
    if not train or rate == 0.0 or seed is None:
        return x
    q = dropout_mask_q(rate)
    if q <= 0:
        return x
    if q >= 256:  # rate ≈ 1.0: everything dropped (torch nn.Dropout(1.0))
        return torch.zeros_like(x)
    return _DropoutCore.apply(x, seed, q, split_dim)


# ---------------------------------------------------------------------------
# the bf16 softmax and the lean attention core


def _softmax_bwd_bf16(w, dw):
    """ds = w·(dw − Σ dw·w) of bf16 softmax weights w and their cotangent
    dw, in fp32, rounded to bf16."""
    wf, dwf = w.float(), dw.float()
    return (wf * (dwf - (dwf * wf).sum(-1, keepdim=True))).to(torch.bfloat16)


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
        return _softmax_bwd_bf16(w, dw)


def _weights_bf16(q, k, scale: float):
    """The bf16 attention weights: q·kᵀ rounded once to bf16, times the
    bf16-rounded scale, softmaxed in fp32 and rounded to bf16."""
    s = _matmul_round_once(q, k.transpose(-1, -2)) * _bf16_value(scale)
    return _SoftmaxResidualBf16.apply(s)


def draw_bits(seed, q: torch.Tensor, k: torch.Tensor, qthresh: int):
    """The lean core's weight-dropout bits of a [..., Tq, Tk] site (split over
    'model' along the heads, dim 1), or None where nothing is dropped."""
    if qthresh == 0:
        return None
    return dropout_bits(seed, (*q.shape[:-1], k.shape[-2]), q.device,
                        split_dim=1)


def _plain_weights(q, k, bits, scale, qthresh):
    """The forward chain up to the dropped weights: (w, wd, keep)."""
    w = _weights_bf16(q, k, scale)
    if qthresh == 0:
        return w, w, None
    keep = bits >= qthresh
    return w, _drop(w, keep, qthresh), keep


def lean_attention_plain_fwd(q, k, v, bits, scale: float, qthresh: int):
    """The lean core's forward in PyTorch ops. q [..., Tq, h], k, v [..., Tk,
    h] bf16; bits [..., Tq, Tk] uint8 (None where qthresh is 0) → out
    [..., Tq, h]. The contract the kernels (ops/lean_attention.py) keep."""
    _, wd, _ = _plain_weights(q, k, bits, scale, qthresh)
    return _matmul_round_once(wd, v)


def lean_attention_plain_bwd(dout, q, k, v, bits, scale: float,
                             qthresh: int):
    """The lean core's backward in PyTorch ops: the forward's operands and
    dout [..., Tq, h] → (dq, dk, dv)."""
    w, wd, keep = _plain_weights(q, k, bits, scale, qthresh)
    dv = _matmul_round_once(wd.transpose(-1, -2), dout)
    dw = _matmul_round_once(dout, v.transpose(-1, -2))
    if keep is not None:
        dw = _drop(dw, keep, qthresh)
    ds = _softmax_bwd_bf16(w, dw) * _bf16_value(scale)
    dq = _matmul_round_once(ds, k)
    dk = _matmul_round_once(ds.transpose(-1, -2), q)
    return dq, dk, dv


class _SdpaLeanCore(torch.autograd.Function):
    """bf16 training attention: scores → softmax → weight dropout → ·v, with
    only (q, k, v, seed) kept for the backward, which recomputes the rest:
    the kernels where la.takes_kernel, else the plain pair."""

    @staticmethod
    def forward(ctx, q, k, v, seed, scale, qthresh):
        ctx.save_for_backward(q, k, v)
        ctx.seed, ctx.scale, ctx.qthresh = seed, scale, qthresh
        bits = draw_bits(seed, q, k, qthresh)
        if la.takes_kernel(q, k):
            return la.lean_attention_fwd_cuda(
                la.kernel_view(q), la.kernel_view(k), la.kernel_view(v), bits,
                scale, qthresh)
        return lean_attention_plain_fwd(q, k, v, bits, scale, qthresh)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        bits = draw_bits(ctx.seed, q, k, ctx.qthresh)
        if la.takes_kernel(q, k):
            grads = la.lean_attention_bwd_cuda(
                la.kernel_view(dout), la.kernel_view(q), la.kernel_view(k),
                la.kernel_view(v), bits, ctx.scale, ctx.qthresh)
        else:
            grads = lean_attention_plain_bwd(dout, q, k, v, bits, ctx.scale,
                                             ctx.qthresh)
        return (*grads, None, None, None)


def sdpa(q, k, v, *, dropout_rate: float = 0.0, seed=None, train: bool = False,
         impl: str = "auto"):
    """Scaled dot-product attention. q, k, v: [B, n, T, h].

    As the JAX sdpa: 'auto' takes the flash kernel K3 (ops/flash_attention.py)
    from kv_len MIN_KV_LEN_AUTO, 'pallas' at any length, both only where it
    applies (no active attention dropout, kv_len <= MAX_KV_LEN); the rest
    takes the composed path. One stated difference: a head width K3 does not
    take (not a multiple of 16, or above 128: fa.HEAD_DIMS) takes the
    composed path too, where the JAX kernel takes any width. CPU and card
    take the same branch. bf16 training otherwise takes _SdpaLeanCore: its
    kernels on the card where lean_attention.supports, its plain pair
    elsewhere."""
    scale = q.shape[-1] ** -0.5
    kv_len = k.shape[-2]
    use_flash = impl == "pallas" or (impl == "auto"
                                     and kv_len >= fa.MIN_KV_LEN_AUTO)
    if use_flash and fa.supports(kv_len, dropout_rate if train else 0.0, seed,
                                 head_dim=q.shape[-1]):
        return fa.flash_attention(q, k, v, scale)
    if v.dtype == torch.bfloat16:
        if train:
            drop = dropout_rate > 0.0 and seed is not None
            qthresh = dropout_mask_q(dropout_rate) if drop else 0
            if qthresh < 256:  # rate ≈ 1.0 takes the composed path's zeros
                return _SdpaLeanCore.apply(q, k, v, seed, scale, qthresh)
        weights = dropout(_weights_bf16(q, k, scale), dropout_rate, seed,
                          train, split_dim=1)
        return _matmul_round_once(weights, v)
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    weights = torch.softmax(scores.float(), dim=-1)
    weights = dropout(weights, dropout_rate, seed, train, split_dim=1)
    return torch.matmul(weights.to(v.dtype), v)


def multi_head_attention(p, query, key, value, *, num_heads: int,
                         dropout_rate: float = 0.0, seed=None,
                         train: bool = False, use_rope: bool = True,
                         impl: str = "auto", out_dropout: bool = True):
    """p has the linears q_linear, k_linear, v_linear and out_linear
    (models/layers.py:Linear, called on [..., in]).

    query [B, Tq, H], key/value [B, Tk, H] → [B, Tq, H]. Under tensor
    parallelism q, k and v return this rank's num_heads heads (of width
    h each) and out_linear sums the ranks' heads back to the width H. In
    training, `seed` splits into the attention-weight and the residual
    dropout sites; out_dropout=False leaves the residual site out (its
    seed is split all the same), for a layer that drops the attention's
    output once itself where the Seq2Seq drops it twice.
    """
    B, Tq, _ = query.shape
    q = p.q_linear(query)
    k = p.k_linear(key)
    v = p.v_linear(value)
    width = q.shape[-1]
    h = width // num_heads
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
        out = out.transpose(1, 2).reshape(B, Tq, width)
    out = p.out_linear(out)
    if not out_dropout:
        return out
    return dropout(out, dropout_rate, seed_resid, train)

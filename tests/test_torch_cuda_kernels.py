"""Kernels K1, K4, K3 (forward and backward), K2, the bf16 LayerNorm and
the lean attention core on the card, against their plain versions.

These tests need a CUDA card and nvcc, and skip without them. They import
nothing of JAX, so they run on a machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

chip_smoke.py holds the kernels at the serving shape; these cover the edges
it does not reach: widths that are not a multiple of a warp or of a
16-byte vector, batch sizes, strided and misaligned inputs, several query
tiles, cross-attention lengths, every instantiated head width, the
autograd paths, which kernel symbol each dtype and shape runs, a small
training step on the card and the wrappers' refusals.
"""

import shutil
from pathlib import Path

import pytest
import torch

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.models.seq2seq import (
    MultiHeadAttention,
    init_seq2seq,
)
from neurosync_trainer_lite_tpu_torch.models import layers, seq2seq
from neurosync_trainer_lite_tpu_torch.ops import ffn_bwd
from neurosync_trainer_lite_tpu_torch.ops import flash_attention as fa
from neurosync_trainer_lite_tpu_torch.ops import fused_attention as fua
from neurosync_trainer_lite_tpu_torch.ops import attention as tattn
from neurosync_trainer_lite_tpu_torch.ops import kernels
from neurosync_trainer_lite_tpu_torch.ops import layer_norm_kernel as lnk
from neurosync_trainer_lite_tpu_torch.ops import lean_attention as la
from neurosync_trainer_lite_tpu_torch.ops import rope_kernel as rk
from neurosync_trainer_lite_tpu_torch.ops.attention import _linear
from neurosync_trainer_lite_tpu_torch.ops.rope import rope_tables
from neurosync_trainer_lite_tpu_torch.training.step import (
    init_train_state,
    make_train_step,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if shutil.which("nvcc") is None and not Path(
            "/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("needs nvcc to build the kernels")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, device="cuda", generator=gen).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 20, 48, 1000, 1024])
@pytest.mark.parametrize("transpose", [False, True])
def test_rope_kernel_bitwise_equals_plain(gen, dtype, d, transpose):
    """Random tables: the circular roll formula, not only RoPE's pattern.
    d = 20 in bf16 (40 bytes) and 1000 in bf16 are no whole number of
    16-byte vectors: the scalar variant."""
    x = _randn(gen, 3, 7, d, dtype=dtype)
    tables = tuple(_randn(gen, 7, d) for _ in range(3))
    out = rk.rope_rotate_cuda(x, *tables, transpose=transpose)
    torch.cuda.synchronize()
    ref = rk.rope_rotate_plain(x, *tables, transpose=transpose)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 20, 48, 1000, 1024])
@pytest.mark.parametrize("batch", [1, 17, 128])
def test_rope_kernel_bitwise_across_batch_sizes(gen, dtype, d, batch):
    """Each block reuses its table rows over its share of the batch rows
    (four at a time): every batch size, forward and transpose, bitwise."""
    x = _randn(gen, batch, 33, d, dtype=dtype)
    tables = tuple(_randn(gen, 33, d) for _ in range(3))
    for transpose in (False, True):
        out = rk.rope_rotate_cuda(x, *tables, transpose=transpose)
        torch.cuda.synchronize()
        assert torch.equal(out, rk.rope_rotate_plain(x, *tables,
                                                     transpose=transpose))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_kernel_on_strided_and_offset_inputs(gen, dtype):
    """A non-contiguous x (the wrapper makes it contiguous) and a contiguous
    x whose base is off the 16-byte grid (the scalar variant): bitwise."""
    tables = rope_tables(16, 64, "cuda")
    strided = _randn(gen, 16, 5, 64, dtype=dtype).transpose(0, 1)
    offset = _randn(gen, 5 * 16 * 64 + 1, dtype=dtype)[1:].view(5, 16, 64)
    assert not strided.is_contiguous() and offset.data_ptr() % 16
    for x in (strided, offset):
        for transpose in (False, True):
            out = rk.rope_rotate_cuda(x, *tables, transpose=transpose)
            torch.cuda.synchronize()
            assert torch.equal(out, rk.rope_rotate_plain(x, *tables,
                                                         transpose=transpose))


def test_rope_autograd_runs_the_transpose_kernel(gen):
    tables = rope_tables(16, 64, "cuda")
    x = _randn(gen, 2, 16, 64).requires_grad_(True)
    dy = _randn(gen, 2, 16, 64)
    kernels.reset_launches()
    rk.rope_rotate(x, *tables).backward(dy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rope_rotate"] == 2
    assert torch.equal(x.grad, rk.rope_rotate_plain(dy, *tables,
                                                    transpose=True))


SHAPES = [  # B, Tq, Tk, H, heads
    (2, 300, 128, 64, 4),      # query tiles of 64 and 128, the last partial
    (3, 37, 37, 64, 4),        # head_dim 16, as the reference fixture
    (2, 16, 24, 128, 4),       # head_dim 32, cross-attention lengths
    (1, 128, 128, 1024, 16),   # head_dim 64, the serving row
    (1, 64, 400, 256, 4),      # a long key strip near the smem gate
    (2, 128, 128, 768, 16),    # the widths off the powers of two
    (1, 128, 128, 640, 8),
    (1, 64, 64, 768, 8),
    (1, 64, 64, 896, 8),
    (2, 128, 128, 1024, 8),    # head_dim 128
    (2, 100, 100, 1024, 16),   # Tq off the 16-row tile
    (2, 64, 72, 1024, 16),     # Tk off the 64-key step
]


@pytest.mark.parametrize("B,Tq,Tk,H,n", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_kernel_matches_plain(gen, B, Tq, Tk, H, n, dtype):
    """Within fua.fwd_limit of the plain version; bitwise repeatable."""
    q = _randn(gen, B, Tq, H, dtype=dtype)
    k = _randn(gen, B, Tk, H, dtype=dtype)
    v = _randn(gen, B, Tk, H, dtype=dtype)
    tables = fua.make_tables(Tq, Tk, H // n, n, "cuda")
    scale = (H // n) ** -0.5
    out = fua.fused_rope_attention_cuda(q, k, v, tables, n, scale)
    torch.cuda.synchronize()
    ref = fua.fused_rope_attention_plain(q, k, v, tables, n, scale)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= fua.fwd_limit(ref, dtype)).all()), diff.max().item()
    assert torch.equal(out, fua.fused_rope_attention_cuda(q, k, v, tables, n,
                                                          scale))


BWD_SHAPES = [  # B, Tq, Tk, H, heads: every block loops over rows
    (2, 200, 24, 64, 4),       # more query rows than threads
    (3, 37, 37, 64, 4),        # head_dim 16
    (2, 16, 24, 128, 4),       # head_dim 32, cross-attention lengths
    (2, 128, 128, 1024, 16),   # head_dim 64, the training row
    (2, 100, 100, 1024, 16),   # the training width, rows off the 16-row tiles
    (1, 192, 192, 256, 4),     # 3 query and key steps, 3 row tiles a warp
    (2, 128, 128, 768, 16),    # head_dim 48
    (2, 112, 112, 1024, 8),    # head_dim 128, the longest fp32 T the gate takes
]


def bwd_limit(ref, dtype):
    """The forward's bound plus 1e-4 of the largest gradient: ds = p(dp - D)
    cancels, so a small element carries the fp32 rounding of the terms it
    sums (about T·2^-24 of the largest)."""
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    ref = ref.float()
    return rel * ref.abs() + 1e-4 * ref.abs().max() + 1e-6


@pytest.mark.parametrize("B,Tq,Tk,H,n", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_backward_kernel_matches_plain(gen, B, Tq, Tk, H, n,
                                                       dtype):
    q = _randn(gen, B, Tq, H, dtype=dtype)
    k = _randn(gen, B, Tk, H, dtype=dtype)
    v = _randn(gen, B, Tk, H, dtype=dtype)
    do = _randn(gen, B, Tq, H, dtype=dtype)
    tables = fua.make_tables(Tq, Tk, H // n, n, "cuda")
    scale = (H // n) ** -0.5
    out = fua.fused_rope_attention_bwd_cuda(q, k, v, do, tables, n, scale)
    torch.cuda.synchronize()
    ref = fua.fused_rope_attention_bwd_plain(q, k, v, do, tables, n, scale)
    for name, a, b in zip("qkv", out, ref):
        assert a.dtype == dtype and a.shape == b.shape
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= bwd_limit(b, dtype)).all()), \
            (name, diff.max().item())
    again = fua.fused_rope_attention_bwd_cuda(q, k, v, do, tables, n, scale)
    assert all(torch.equal(a, b) for a, b in zip(out, again))  # no atomics


def test_fused_attention_gate_refuses_the_fp32_backward_at_h128(gen):
    """At h = 128 and T = 128 the fp32 backward needs 263,680 B of shared
    memory: fits_smem declines (the model takes the composed path), the
    fp32 backward raises, and the bf16 one and both forwards run."""
    q = _randn(gen, 1, 128, 1024)
    tables = fua.make_tables(128, 128, 128, 8, "cuda")
    assert not fua.fits_smem(128, 128, 128, 4)
    assert fua.fits_smem(128, 128, 128, 2)
    with pytest.raises(ValueError, match="gate"):
        fua.fused_rope_attention_bwd_cuda(q, q, q, q, tables, 8, 128 ** -0.5)
    for x in (q, q.bfloat16()):
        fua.fused_rope_attention_cuda(x, x, x, tables, 8, 128 ** -0.5)
    qb = q.bfloat16()
    fua.fused_rope_attention_bwd_cuda(qb, qb, qb, qb, tables, 8, 128 ** -0.5)
    torch.cuda.synchronize()


def test_fused_attention_autograd_runs_both_kernels(gen):
    q, k, v = (_randn(gen, 2, 16, 64).requires_grad_(True) for _ in range(3))
    do = _randn(gen, 2, 16, 64)
    tables = fua.make_tables(16, 16, 16, 4, "cuda")
    kernels.reset_launches()
    fua.fused_rope_attention(q, k, v, tables, 4, 0.25).backward(do)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"fused_rope_attention": 1,
                                      "fused_rope_attention_bwd": 1,
                                      "rope_rotate": 2}
    want = fua.fused_rope_attention_bwd_cuda(q.detach(), k.detach(),
                                             v.detach(), do, tables, 4, 0.25)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, w)


def test_linear_bf16_grads_on_the_card_match_the_cpu(gen):
    """_linear's Function on the card (torch.mm with an fp32 output) vs the
    CPU (widened operands): the same rounding points, so one bf16 ulp of
    the largest value (2^-7 of it) apart at most; the fp32 bias gradient
    within 1e-5."""
    x = _randn(gen, 64, 96, dtype=torch.bfloat16).requires_grad_(True)
    w = (_randn(gen, 48, 96) * 0.1).requires_grad_(True)
    b = _randn(gen, 48).requires_grad_(True)
    dy = _randn(gen, 64, 48, dtype=torch.bfloat16)
    _linear(x, w, b).backward(dy)
    xc, wc, bc = (t.detach().cpu().requires_grad_(True) for t in (x, w, b))
    y = _linear(xc, wc, bc)
    y.backward(dy.cpu())
    for got, want in ((x.grad, xc.grad), (w.grad, wc.grad)):
        want = want.float()
        assert (got.cpu().float() - want).abs().max() <= \
            2.0 ** -7 * want.abs().max()
    torch.testing.assert_close(b.grad.cpu(), bc.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_train_step_on_the_card_matches_the_cpu(gen, impl):
    """fp32, dropout 0, three steps of a tiny model on the card and on the
    CPU from the same weights: the kernels in place of the plain versions,
    loss and grad norm within 1e-5; launch counts of one step."""
    cfg = Config(hidden_dim=64, n_layers=2, num_heads=4, input_dim=32,
                 output_dim=7, dropout=0.0, use_amp=False,
                 attention_impl=impl)
    dev = init_train_state(cfg, 5, generator=gen, device="cuda")
    cpu = init_train_state(cfg, 5, device="cpu", state_dict={
        k: v.cpu() for k, v in dev.model.state_dict().items()})
    step = make_train_step(cfg)
    src, trg = _randn(gen, 4, 24, 32), _randn(gen, 4, 24, 7)
    gd, gc = torch.Generator(device="cuda"), torch.Generator()
    for i in range(3):
        kernels.reset_launches()
        _, ld, nd = step(dev, src, trg, gd)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        _, lc, nc = step(cpu, src.cpu(), trg.cpu(), gc)
        assert float(ld) == pytest.approx(float(lc), rel=1e-5), i
        assert float(nd) == pytest.approx(float(nc), rel=1e-5), i
    attn = 3 * 2                       # attentions per forward at 2+2 layers
    want = ({"rope_rotate": 2 * (2 + 2 * attn)} if impl == "auto" else
            {"rope_rotate": 2 * 2 + 2 * attn, "fused_rope_attention": attn,
             "fused_rope_attention_bwd": attn})
    assert launches == want


def test_fused_attention_refusals(gen):
    x = _randn(gen, 1, 8, 64)
    tables = fua.make_tables(8, 8, 16, 4, "cuda")
    with pytest.raises(ValueError, match="shapes"):
        fua.fused_rope_attention_bwd_cuda(x, x, x, x[:, :4], tables, 4, 0.25)
    with pytest.raises(ValueError, match="gate"):
        fua.fused_rope_attention_cuda(x, x, x, fua.make_tables(8, 8, 8, 8,
                                                               "cuda"), 8, 0.3)
    with pytest.raises(TypeError):
        fua.fused_rope_attention_cuda(x.half(), x.half(), x.half(), tables,
                                      4, 0.25)


@pytest.mark.parametrize("use_amp", [False, True])
def test_model_forward_counts_and_impls_agree(gen, use_amp):
    cfg = Config(hidden_dim=64, n_layers=2, num_heads=4, input_dim=32,
                 output_dim=7, dropout=0.0, use_amp=use_amp)
    auto = init_seq2seq(cfg, gen, device="cuda").eval()
    pallas = init_seq2seq(cfg.replace(attention_impl="pallas"), gen,
                          device="cuda").eval()
    pallas.load_state_dict(auto.state_dict())
    src = _randn(gen, 3, 40, 32)
    # bf16: the LayerNorm kernel, 2 an encoder layer, 3 a decoder layer and
    # each stack's final one
    norms = {"layer_norm_fwd": 2 * 2 + 2 * 3 + 2} if use_amp else {}
    with torch.no_grad():
        kernels.reset_launches()
        a = auto(src)
        assert dict(kernels.LAUNCHES) == {"rope_rotate": 2 + 2 * 3 * 2,
                                          **norms}
        kernels.reset_launches()
        p = pallas(src)
        assert dict(kernels.LAUNCHES) == {"rope_rotate": 2,
                                          "fused_rope_attention": 3 * 2,
                                          **norms}
    tol = 3e-2 if use_amp else 2e-5
    torch.testing.assert_close(a, p, atol=tol, rtol=tol)


def test_attention_module_on_cuda_matches_cpu(gen):
    cpu = MultiHeadAttention(64, 4, "pallas", "cpu")
    with torch.no_grad():
        for prm in cpu.parameters():
            prm.copy_(torch.randn(prm.shape) * 0.1)
    dev = MultiHeadAttention(64, 4, "pallas", "cuda")
    dev.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 24, 64)
    with torch.no_grad():
        torch.testing.assert_close(dev(x.cuda(), x.cuda(), x.cuda()).cpu(),
                                   cpu(x, x, x), atol=2e-5, rtol=2e-5)


FLASH_SHAPES = [  # B, N, Tq, Tk, h
    (2, 4, 96, 192, 32),       # ragged query and key tiles, cross lengths
    (1, 2, 300, 37, 16),       # fewer keys than one tile, ragged queries
    (2, 16, 512, 512, 64),     # the 512-frame window's heads
    (1, 2, 130, 70, 128),      # head_dim 128
    (4, 16, 512, 512, 64),     # (s2): the 30 s request at frame_size 512
    (1, 2, 2048, 2048, 64),    # MAX_KV_LEN: 32 tiles through the load ring
    (2, 16, 512, 512, 48),     # the widths off the powers of two, kv 512
    (1, 4, 512, 512, 80),
    (1, 4, 512, 512, 96),
    (1, 2, 300, 200, 112),     # and ragged tiles
]


@pytest.mark.parametrize("B,N,Tq,Tk,h", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_match_plain(gen, B, N, Tq, Tk, h, dtype):
    q = _randn(gen, B, N, Tq, h, dtype=dtype)
    k = _randn(gen, B, N, Tk, h, dtype=dtype)
    v = _randn(gen, B, N, Tk, h, dtype=dtype)
    do = _randn(gen, B, N, Tq, h, dtype=dtype)
    scale = h ** -0.5
    out = fa.flash_attention_cuda(q, k, v, scale)
    grads = fa.flash_attention_bwd_cuda(q, k, v, do, scale)
    torch.cuda.synchronize()
    want = (fa.flash_attention_plain(q, k, v, scale),
            *fa.flash_attention_bwd_plain(q, k, v, do, scale))
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out, *grads), want):
        assert a.dtype == dtype and a.shape == b.shape
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= fa.kernel_limit(b, dtype)).all()), \
            (name, diff.max().item(), b.float().abs().max().item())
    again = fa.flash_attention_bwd_cuda(q, k, v, do, scale)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # no atomics


def test_flash_attention_autograd_runs_the_kernels(gen):
    q, k, v = (_randn(gen, 2, 4, 70, 16).requires_grad_(True)
               for _ in range(3))
    do = _randn(gen, 2, 4, 70, 16)
    kernels.reset_launches()
    fa.flash_attention(q, k, v).backward(do)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"flash_attention": 1,
                                      "flash_attention_bwd_dq": 1,
                                      "flash_attention_bwd_dkdv": 1}
    want = fa.flash_attention_bwd_cuda(q.detach(), k.detach(), v.detach(),
                                       do, 0.25)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_runs_the_tensor_core_symbols_in_bf16(gen, dtype):
    """By the profiler's kernel names: bf16 runs the mma.sync kernels, fp32
    the CUDA-core ones, forward and both backward kernels."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, do = (_randn(gen, 2, 4, 200, 64, dtype=dtype) for _ in range(4))

    def run():
        fa.flash_attention_cuda(q, k, v, 0.125)
        fa.flash_attention_bwd_cuda(q, k, v, do, 0.125)
        torch.cuda.synchronize()

    run()                                  # builds and loads the library
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()   # twice: the tracer can miss the first launch of a window
        run()
    names = [e.key for e in prof.key_averages() if "flash_" in e.key]
    mma = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
           "flash_bwd_dkdv_mma_kernel")
    cores = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")
    ran, idle = (mma, cores) if dtype == torch.bfloat16 else (cores, mma)
    assert all(any(sym in n for n in names) for sym in ran), names
    assert not any(sym in n for n in names for sym in idle), names


def _kernel_names(run, prefix):
    """The profiler's names of the kernels `run` launches that contain
    `prefix`, from two traced calls (the tracer can miss the first launch
    of a window), after one untraced call that builds and loads."""
    from torch.profiler import ProfilerActivity, profile

    run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        run()
    return [e.key for e in prof.key_averages() if prefix in e.key]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_attention_backward_runs_the_tensor_core_symbol_in_bf16(
        gen, dtype):
    """By the profiler's kernel names: the bf16 K4 backward runs the
    mma.sync kernel, fp32 the CUDA-core one."""
    q, k, v, do = (_randn(gen, 2, 128, 1024, dtype=dtype) for _ in range(4))
    tables = fua.make_tables(128, 128, 64, 16, "cuda")

    def run():
        fua.fused_rope_attention_bwd_cuda(q, k, v, do, tables, 16, 0.125)
        torch.cuda.synchronize()

    names = _kernel_names(run, "attn_bwd")
    mma = any("attn_bwd_mma_kernel" in n for n in names)
    cores = any("attn_bwd_kernel" in n for n in names)
    assert (mma, cores) == ((True, False) if dtype == torch.bfloat16
                            else (False, True)), names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_attention_forward_runs_the_tensor_core_symbol_in_bf16(
        gen, dtype):
    """By the profiler's kernel names: the bf16 K4 forward runs the
    mma.sync kernel, fp32 the CUDA-core one."""
    q, k, v = (_randn(gen, 2, 128, 1024, dtype=dtype) for _ in range(3))
    tables = fua.make_tables(128, 128, 64, 16, "cuda")

    def run():
        fua.fused_rope_attention_cuda(q, k, v, tables, 16, 0.125)
        torch.cuda.synchronize()

    names = _kernel_names(run, "attn_fwd")
    mma = any("attn_fwd_mma_kernel" in n for n in names)
    cores = any("attn_fwd_kernel" in n for n in names)
    assert (mma, cores) == ((True, False) if dtype == torch.bfloat16
                            else (False, True)), names


@pytest.mark.parametrize("M,H,F,symbol", [(512, 1024, 4096, "wgmma"),
                                          (96, 64, 192, "wgmma"),
                                          (33, 20, 70, "wmma")])
def test_ffn_bwd_runs_wgmma_where_tma_can_describe_the_shape(gen, M, H, F,
                                                             symbol):
    """By the profiler's kernel names: h and f multiples of 8 (aligned
    tensors) run the wgmma + TMA kernel, the rest the WMMA one."""
    bf16 = torch.bfloat16
    dy = _randn(gen, M, H, dtype=bf16)
    w = _randn(gen, H, F, dtype=bf16)
    am = _randn(gen, M, F, dtype=bf16)

    def run():
        ffn_bwd.ffn_bwd_dh1_cuda(dy, w, am, scale=1.0)
        torch.cuda.synchronize()

    names = _kernel_names(run, "ffn_bwd")
    assert names and all(f"ffn_bwd_{symbol}_kernel" in n for n in names), \
        names


def test_flash_attention_refusals(gen):
    x = _randn(gen, 1, 2, 8, 16)
    with pytest.raises(ValueError, match="K3"):
        fa.flash_attention_cuda(*(_randn(gen, 1, 2, 8, 8),) * 3, 0.3)
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_attention_bwd_cuda(x, x, x, x[:, :1], 0.25)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(x.half(), x.half(), x.half(), 0.25)


@pytest.mark.parametrize("remat", [False, True])
def test_long_window_train_step_on_the_card_matches_the_cpu(gen, remat):
    """fp32, dropout 0, a 520-frame window at 'auto': every attention takes
    K3 (kv_len >= 512). Three steps on the card and on the CPU from the same
    weights: loss and grad norm within 1e-5; launch counts of one step, the
    rematted layers' forward kernels launched again in the backward."""
    cfg = Config(hidden_dim=64, n_layers=2, num_heads=4, input_dim=32,
                 output_dim=7, dropout=0.0, use_amp=False, remat=remat)
    dev = init_train_state(cfg, 5, generator=gen, device="cuda")
    cpu = init_train_state(cfg, 5, device="cpu", state_dict={
        k: v.cpu() for k, v in dev.model.state_dict().items()})
    step = make_train_step(cfg)
    src, trg = _randn(gen, 2, 520, 32), _randn(gen, 2, 520, 7)
    gd, gc = torch.Generator(device="cuda"), torch.Generator()
    for i in range(3):
        kernels.reset_launches()
        _, ld, nd = step(dev, src, trg, gd)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        _, lc, nc = step(cpu, src.cpu(), trg.cpu(), gc)
        assert float(ld) == pytest.approx(float(lc), rel=1e-5), i
        assert float(nd) == pytest.approx(float(nc), rel=1e-5), i
    attn = 3 * 2                       # attentions per forward at 2+2 layers
    again = 2 if remat else 1          # forwards of each layer in a step
    assert launches == {"rope_rotate": 2 * 2 + (1 + again) * 2 * attn,
                        "flash_attention": again * attn,
                        "flash_attention_bwd_dq": attn,
                        "flash_attention_bwd_dkdv": attn}


FFN_SHAPES = [  # M, H, F
    (96, 64, 192),          # the JAX test's shape: one partial tile each way
    (300, 136, 520),        # ragged row, depth and column tiles
    (257, 1024, 4096),      # the training widths, M one past two row tiles
    (33, 20, 70),           # H, F not multiples of 8: the scalar loads
]


@pytest.mark.parametrize("M,H,F", FFN_SHAPES)
@pytest.mark.parametrize("scale", [1.0, 256 / 179])
def test_ffn_bwd_kernel_matches_plain(gen, M, H, F, scale):
    bf16 = torch.bfloat16
    dy = _randn(gen, M, H, dtype=bf16)
    w = (_randn(gen, H, F) * 0.05).to(bf16)
    am = torch.relu(_randn(gen, M, F) - 0.3).to(bf16)
    out = ffn_bwd.ffn_bwd_dh1_cuda(dy, w, am, scale=scale)
    torch.cuda.synchronize()
    ref = ffn_bwd.ffn_bwd_dh1_plain(dy, w, am, scale=scale)
    for name, a, b, limit in zip(("dh1", "db2", "db1"), out, ref,
                                 ffn_bwd.kernel_limits(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= limit).all()), (name, diff.max().item())
    again = ffn_bwd.ffn_bwd_dh1_cuda(dy, w, am, scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(out, again))  # no atomics


def test_ffn_bwd_refusals(gen):
    x = _randn(gen, 8, 16, dtype=torch.bfloat16)
    w = _randn(gen, 16, 32, dtype=torch.bfloat16)
    am = _randn(gen, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="K2"):
        ffn_bwd.ffn_bwd_dh1_cuda(x.float(), w.float(), am.float(), scale=1.0)
    with pytest.raises(ValueError, match="shapes"):
        ffn_bwd.ffn_bwd_dh1_cuda(x, w, am[:, :16], scale=1.0)


def test_ffn_fused_step_on_the_card_runs_k2(gen, monkeypatch):
    """A tiny bf16 step at dropout 0.3 routed through ffn_fused: K2 once per
    FFN; its loss bitwise the default step's (the same masks and forward),
    its grad norm within 2e-2."""
    cfg = Config(hidden_dim=64, n_layers=2, num_heads=4, input_dim=32,
                 output_dim=7, dropout=0.3, use_amp=True)
    weights = init_seq2seq(cfg, gen, device="cuda").state_dict()
    src, trg = _randn(gen, 4, 24, 32), _randn(gen, 4, 24, 7)
    runs = {}
    for name, fn in (("default", seq2seq._ffn), ("fused", layers.ffn_fused)):
        monkeypatch.setattr(seq2seq, "_ffn", fn)
        state = init_train_state(cfg, 5, device="cuda", state_dict=weights)
        kernels.reset_launches()
        _, loss, norm = make_train_step(cfg)(state, src, trg,
                                             torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        runs[name] = (float(loss), float(norm),
                      kernels.LAUNCHES["ffn_bwd_dh1"])
    assert runs["default"][2] == 0 and runs["fused"][2] == 2 + 2
    assert runs["fused"][0] == runs["default"][0]
    assert runs["fused"][1] == pytest.approx(runs["default"][1], rel=2e-2)


#: the shapes a rank of tp = 2 gives the kernels at full width: 8 of the
#: 16 heads (h = 64) on [B, T, 512] (B: a request's chunks, a data
#: group's 8 rows at (2, 2) and batch 16, batch 32, batch 128), and 2048
#: of the 4096 FFN columns at those batches' M = B · 128
TP2_ATTN_ROWS, TP2_FFN_M = (8, 17, 32, 128), (16384, 4096, 1024)


@pytest.mark.parametrize("B", TP2_ATTN_ROWS)
def test_kernels_at_a_tp2_ranks_attention_shapes(gen, B):
    """K1 (the per-head rotation of q and k: bitwise), the K4 forward
    (within fua.fwd_limit) and, at the training rows, the K4 backward
    (bwd_limit) on a tp = 2 rank's [B, 128, 512] with 8 heads, bf16."""
    bf16 = torch.bfloat16
    q, k, v, do = (_randn(gen, B, 128, 512, dtype=bf16) for _ in range(4))
    tables = rope_tables(128, 64, "cuda", tile=8)
    assert torch.equal(rk.rope_rotate_cuda(q, *tables),
                       rk.rope_rotate_plain(q, *tables))
    ftables = fua.make_tables(128, 128, 64, 8, "cuda")
    out = fua.fused_rope_attention_cuda(q, k, v, ftables, 8, 64 ** -0.5)
    ref = fua.fused_rope_attention_plain(q, k, v, ftables, 8, 64 ** -0.5)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= fua.fwd_limit(ref, bf16)).all()), diff.max().item()
    if B != 128:
        return
    out = fua.fused_rope_attention_bwd_cuda(q, k, v, do, ftables, 8,
                                            64 ** -0.5)
    ref = fua.fused_rope_attention_bwd_plain(q, k, v, do, ftables, 8,
                                             64 ** -0.5)
    for name, a, b in zip("qkv", out, ref):
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= bwd_limit(b, bf16)).all()), \
            (name, diff.max().item())


def test_rope_fp32_at_a_tp2_ranks_decode_shape(gen):
    """K1 in fp32 on the fp32 decode's [17, 128, 512] with 8-head tables:
    bitwise the plain version."""
    x = _randn(gen, 17, 128, 512)
    tables = rope_tables(128, 64, "cuda", tile=8)
    assert torch.equal(rk.rope_rotate_cuda(x, *tables),
                       rk.rope_rotate_plain(x, *tables))


@pytest.mark.parametrize("m", TP2_FFN_M)
def test_ffn_bwd_at_a_tp2_ranks_shape_runs_wgmma(gen, m):
    """K2 at a tp = 2 rank's [M, 1024, 2048] (dy · W2 of its [1024, 2048]
    block): within kernel_limits of the plain version, on
    ffn_bwd_wgmma_kernel."""
    h, f = 1024, 2048
    bf16 = torch.bfloat16
    dy = _randn(gen, m, h, dtype=bf16)
    w = (_randn(gen, h, f) * 0.05).to(bf16)
    am = torch.relu(_randn(gen, m, f) - 0.3).to(bf16)
    outs = []

    def run():
        outs.append(ffn_bwd.ffn_bwd_dh1_cuda(dy, w, am, scale=256 / 179))
        torch.cuda.synchronize()

    names = _kernel_names(run, "ffn_bwd")
    assert names and all("ffn_bwd_wgmma_kernel" in n for n in names), names
    out = outs[-1]
    ref = ffn_bwd.ffn_bwd_dh1_plain(dy, w, am, scale=256 / 179)
    for name, a, b, limit in zip(("dh1", "db2", "db1"), out, ref,
                                 ffn_bwd.kernel_limits(ref)):
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= limit).all()), (name, diff.max().item())


def test_nccl_one_rank_step_equals_no_group_bitwise(gen, tmp_path):
    """A DP step through an NCCL group of one rank and its all-reduce of the
    flat gradient equals the step with no group bit for bit, at dropout
    0.3 with two micro-batches: losses, grad norms, every parameter."""
    from neurosync_trainer_lite_tpu_torch.parallel import (
        distributed, make_mesh)

    cfg = Config(hidden_dim=128, n_layers=2, num_heads=4, batch_size=8,
                 micro_batch_size=32, dropout=0.3, grad_accum_steps=2)
    weights = init_seq2seq(cfg, gen, device="cuda").state_dict()
    src = _randn(gen, 8, 32, cfg.input_dim)
    trg = torch.rand(8, 32, cfg.output_dim, device="cuda", generator=gen)

    def run(mesh):
        state = init_train_state(cfg, 10, device="cuda", state_dict=weights,
                                 mesh=mesh)
        step = make_train_step(cfg, mesh=mesh)
        steps = torch.Generator().manual_seed(4)
        out = [tuple(float(x) for x in step(state, src, trg, steps)[1:])
               for _ in range(3)]
        return out, [p.detach().clone() for p in state.model.parameters()]

    plain, plain_params = run(None)
    distributed.initialize_distributed(
        init_method=f"file://{tmp_path / 'store'}", num_processes=1,
        process_id=0, timeout_s=60)
    try:
        assert distributed.world_size() == 1
        grouped, params = run(make_mesh(cfg))
    finally:
        distributed.destroy()
    assert grouped == plain
    assert all(torch.equal(a, b) for a, b in zip(params, plain_params))


def _ln_inputs(gen, rows, width):
    bf16 = torch.bfloat16
    x = (_randn(gen, rows, width) * 2.0 + 0.5).to(bf16)
    w = torch.rand(width, device="cuda", generator=gen) + 0.5
    b = _randn(gen, width)
    dout = _randn(gen, rows, width, dtype=bf16)
    return x, w, b, dout


def _ln_scales(x, w, b, dout, mean, r):
    """The fp32 size of the terms each output sums: |(x - mean) r w| + |b|
    for out, r (|dy| + |m1| + |y m2|) for dx. A last-bit change of mean or
    r (the row sums run in another order than PyTorch's) moves an output
    by about that size's fp32 ulp, which is more than the result's own
    bf16 ulp where the terms cancel."""
    y = (x.float() - mean) * r
    dy = dout.float() * w
    m1 = dy.mean(dim=-1, keepdim=True)
    m2 = (dy * y).mean(dim=-1, keepdim=True)
    return (y * w).abs() + b.abs(), r * (dy.abs() + m1.abs() + (y * m2).abs())


def _assert_bf16_close(got, want, scale, what):
    """got within one bf16 ulp of `scale` (never below want's own ulp)
    from want everywhere, and bitwise equal to it at 99% of elements."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    ulp = torch.exp2(torch.floor(torch.log2(
        torch.maximum(scale, want.float().abs()).clamp_min(2.0 ** -100))) - 7)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= ulp).all()), (what, (diff / ulp).max().item())
    same = (got == want).float().mean().item()
    assert same >= 0.99, (what, same)


def _check_ln(x, w, b, dout):
    """Both kernels against the plain version on the same tensors; the
    backward run twice, bitwise equal (no atomics)."""
    out, mean, r = lnk.layer_norm_fwd_cuda(x, w, b)
    ref, rmean, rr = lnk.layer_norm_plain_fwd(x, w, b)
    torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(r, rr, rtol=1e-5, atol=0)
    fscale, bscale = _ln_scales(x, w, b, dout, rmean, rr)
    _assert_bf16_close(out, ref, fscale, "out")
    grads = lnk.layer_norm_bwd_cuda(dout, x, mean, r, w)
    want = lnk.layer_norm_plain_bwd(dout, x, mean, r, w)
    _assert_bf16_close(grads[0], want[0], bscale, "dx")
    for name, a, e in zip(("dweight", "dbias"), grads[1:], want[1:]):
        assert a.dtype == torch.float32 and a.shape == e.shape
        assert (a - e).abs().max().item() <= 1e-5 * e.norm().item(), name
    again = lnk.layer_norm_bwd_cuda(dout, x, mean, r, w)
    assert all(torch.equal(a, e) for a, e in zip(grads, again))


@pytest.mark.parametrize("width", sorted({16, 20, 48, 1000, 1024,
                                          lnk.MAX_WIDTH}))
@pytest.mark.parametrize("rows", [1, 7, 16384])
def test_layer_norm_kernels_match_plain(gen, rows, width):
    """Widths under a warp's 32 lanes, not a multiple of 8 (20: the scalar
    variant), 1000 (125 vectors: lanes past the row's end), the model's
    1,024 and the widest taken; one row, a grid of one block, and the
    training step's 128 x 128 rows."""
    _check_ln(*_ln_inputs(gen, rows, width))


@pytest.mark.parametrize("width", [1024, 20])
def test_layer_norm_kernels_on_strided_and_misaligned_inputs(gen, width):
    """A strided view (the wrapper's contiguous copy) and views 2 bytes
    past a 16-byte boundary (the scalar variant), x and dout alike."""
    x, w, b, dout = _ln_inputs(gen, 33, width)
    wide = torch.zeros(33, 2 * width, device="cuda", dtype=torch.bfloat16)
    wide[:, ::2] = x
    strided = wide[:, ::2]
    assert not strided.is_contiguous()
    _check_ln(strided, w, b, dout)
    flat = torch.zeros(2, 33 * width + 1, device="cuda", dtype=torch.bfloat16)
    xm, dm = flat[0, 1:].view(33, width), flat[1, 1:].view(33, width)
    xm.copy_(x)
    dm.copy_(dout)
    assert xm.data_ptr() % 16 and dm.data_ptr() % 16
    _check_ln(xm, w, b, dm)


def test_layer_norm_runs_the_nsync_ln_symbols(gen):
    """By the profiler's kernel names, which the benchmark's
    ln_roofline_pct.train reads: the forward, the backward and its
    finishing pass."""
    x, w, b, dout = _ln_inputs(gen, 256, 1024)

    def run():
        out, mean, r = lnk.layer_norm_fwd_cuda(x, w, b)
        lnk.layer_norm_bwd_cuda(dout, x, mean, r, w)
        torch.cuda.synchronize()

    names = _kernel_names(run, "nsync_ln_")
    found = {k for k in ("nsync_ln_fwd<", "nsync_ln_bwd<",
                         "nsync_ln_bwd_params") if any(k in n for n in names)}
    assert found == {"nsync_ln_fwd<", "nsync_ln_bwd<",
                     "nsync_ln_bwd_params"}, names


def test_layer_norm_refusals(gen):
    x, w, b, dout = _ln_inputs(gen, 8, 64)
    mean, r = torch.zeros(8, 1, device="cuda"), torch.ones(8, 1, device="cuda")
    with pytest.raises(TypeError, match="bf16"):
        lnk.layer_norm_fwd_cuda(x.float(), w, b)
    with pytest.raises(ValueError, match="width"):
        wide = torch.zeros(2, lnk.MAX_WIDTH + 8, device="cuda",
                           dtype=torch.bfloat16)
        lnk.layer_norm_fwd_cuda(wide, w, b)
    with pytest.raises(ValueError, match="weight"):
        lnk.layer_norm_fwd_cuda(x, w[:32], b)
    with pytest.raises(ValueError, match="bias"):
        lnk.layer_norm_fwd_cuda(x, w, b.bfloat16())
    with pytest.raises(ValueError, match="differ"):
        lnk.layer_norm_bwd_cuda(dout[:4], x, mean, r, w)
    with pytest.raises(ValueError, match="mean"):
        lnk.layer_norm_bwd_cuda(dout, x, mean[:4], r, w)
    with pytest.raises(ValueError, match="CUDA"):
        lnk.layer_norm_fwd_cuda(x.cpu(), w, b)


def test_layer_norm_wider_than_max_width_is_refused_on_the_card(gen):
    """The model's bf16 LayerNorm on a row wider than the kernels take:
    refused on the card, with no kernel launched and no plain fallback."""
    x, w, b, _ = _ln_inputs(gen, 16, lnk.MAX_WIDTH + 8)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="width"):
        seq2seq.layer_norm(x.clone().requires_grad_(True), w, b)
    assert not kernels.LAUNCHES


def test_bf16_train_step_runs_the_layer_norm_kernels(gen, monkeypatch):
    """A tiny bf16 step at dropout 0 on the card: each LayerNorm launches
    the forward and the backward kernel once (2 an encoder layer, 3 a
    decoder layer, and each stack's final one); its loss and grad norm
    near the same step with the plain LayerNorm on the card."""
    cfg = Config(hidden_dim=64, n_layers=2, num_heads=4, input_dim=32,
                 output_dim=7, dropout=0.0, use_amp=True)
    weights = init_seq2seq(cfg, gen, device="cuda").state_dict()
    src, trg = _randn(gen, 4, 24, 32), _randn(gen, 4, 24, 7)
    runs = {}
    for kernel in (True, False):
        monkeypatch.setattr(lnk, "takes_kernel", lambda x, k=kernel: k)
        state = init_train_state(cfg, 5, device="cuda", state_dict=weights)
        kernels.reset_launches()
        _, loss, norm = make_train_step(cfg)(state, src, trg,
                                             torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        runs[kernel] = (float(loss), float(norm), dict(kernels.LAUNCHES))
    norms = 2 * 2 + 2 * 3 + 2
    assert runs[True][2]["layer_norm_fwd"] == norms
    assert runs[True][2]["layer_norm_bwd"] == norms
    assert not {"layer_norm_fwd", "layer_norm_bwd"} & set(runs[False][2])
    assert runs[True][0] == pytest.approx(runs[False][0], rel=1e-2)
    assert runs[True][1] == pytest.approx(runs[False][1], rel=2e-2)


# -- the lean attention core (csrc/lean_attention.cu) ----------------------


def _lattn_inputs(gen, B, n, tq, tk, h, qthresh, blocks=None, seed=21):
    """q, k, v and dout as the head split's strided views of [B, T, n·h]
    (scores of unit size, as the model's are), and the bits that
    dropout_bits draws for them, under dropout_rows(*blocks) if given."""
    bf16 = torch.bfloat16

    def heads(t):
        return (_randn(gen, B, t, n * h, dtype=bf16)
                .reshape(B, t, n, h).transpose(1, 2))

    q, k, v, dout = heads(tq), heads(tk), heads(tk), heads(tq)
    ctx = tattn.dropout_rows(*blocks) if blocks else tattn.dropout_rows(1, 0)
    with ctx:
        bits = tattn.draw_bits(seed, q, k, qthresh)
    return q, k, v, dout, bits


def _lattn_terms(q, k, v, dout, bits, scale, qthresh):
    """Each output's terms' size, in fp32 from the plain pair's own bf16
    intermediates: |wd|·|v| for out, |wd|ᵀ·|dout| for dv, and for dq and dk
    the same over c·|w|·(|dw| + |Σ dw·w|), the size of ds before its
    cancellation."""
    w, wd, keep = tattn._plain_weights(q, k, bits, scale, qthresh)
    dw = tattn._matmul_round_once(dout, v.transpose(-1, -2))
    if keep is not None:
        dw = tattn._drop(dw, keep, qthresh)
    wf, dwf = w.float(), dw.float()
    dot = (dwf * wf).sum(-1, keepdim=True)
    ds = scale * wf * (dwf.abs() + dot.abs())
    a = wd.float().abs()
    return (a @ v.float().abs(), ds @ k.float().abs(),
            ds.transpose(-1, -2) @ q.float().abs(),
            a.transpose(-1, -2) @ dout.float().abs())


def _assert_lattn_close(got, want, terms, what):
    """got within two bf16 roundings of its terms' size from want (a w, dw
    or ds a sum-order flip away from plain's moves a term by one rounding;
    the output's own rounding is the other), and bitwise equal at all but
    1% of elements: the kernels sum in another order than PyTorch's softmax
    and cuBLAS, which flips a bf16 rounding now and then, never more."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    size = torch.maximum(terms, want.float().abs()).clamp_min(2.0 ** -100)
    ulp = torch.exp2(torch.floor(torch.log2(size)) - 7)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= 2 * ulp).all()), (what, (diff / ulp).max().item())
    differ = int((got != want).sum())
    assert differ <= max(2, 0.01 * got.numel()), (what, differ, got.numel())


def _check_lattn(q, k, v, dout, bits, qthresh):
    """Both kernels against the plain pair on the same tensors; each run
    twice, bitwise equal (no atomics)."""
    scale = q.shape[-1] ** -0.5
    out = la.lean_attention_fwd_cuda(q, k, v, bits, scale, qthresh)
    grads = la.lean_attention_bwd_cuda(dout, q, k, v, bits, scale, qthresh)
    torch.cuda.synchronize()
    ref = tattn.lean_attention_plain_fwd(q, k, v, bits, scale, qthresh)
    want = tattn.lean_attention_plain_bwd(dout, q, k, v, bits, scale, qthresh)
    t_out, t_dq, t_dk, t_dv = _lattn_terms(q, k, v, dout, bits, scale,
                                           qthresh)
    _assert_lattn_close(out, ref, t_out, "out")
    for name, a, b, t in zip(("dq", "dk", "dv"), grads, want,
                             (t_dq, t_dk, t_dv)):
        _assert_lattn_close(a, b, t, name)
    assert torch.equal(out, la.lean_attention_fwd_cuda(q, k, v, bits, scale,
                                                       qthresh))
    again = la.lean_attention_bwd_cuda(dout, q, k, v, bits, scale, qthresh)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("qthresh", [0, 26, 77])
def test_lean_attention_kernels_at_the_training_shape(gen, qthresh):
    """[128, 16, 128, 64], every training site's shape in the three
    cells."""
    _check_lattn(*_lattn_inputs(gen, 128, 16, 128, 128, 64, qthresh),
                 qthresh)


@pytest.mark.parametrize("tq,tk", [(1, 1), (7, 7), (100, 100), (128, 128),
                                   (7, 128), (128, 1), (100, 33)])
@pytest.mark.parametrize("qthresh", [0, 26, 77])
def test_lean_attention_kernels_at_lengths(gen, tq, tk, qthresh):
    """One query or key, lengths off the 16-row tile and the 16-byte bits
    row (7, 100, 33: the byte-wise bits load), Tq != Tk."""
    _check_lattn(*_lattn_inputs(gen, 3, 4, tq, tk, 64, qthresh), qthresh)


@pytest.mark.parametrize("h", fa.HEAD_DIMS)
def test_lean_attention_kernels_at_every_head_width(gen, h):
    _check_lattn(*_lattn_inputs(gen, 2, 3, 128, 96, h, 77), 77)


@pytest.mark.parametrize("blocks", [(4, 1), (2, 1, 2, 1)])
def test_lean_attention_kernels_on_a_ranks_bits(gen, blocks):
    """A DP rank's rows of the global draw (a contiguous block) and a TP
    rank's heads (strided): the kernels read the bits by their strides."""
    inputs = _lattn_inputs(gen, 8, 4, 128, 128, 64, 77, blocks=blocks)
    assert inputs[4].is_contiguous() == (len(blocks) == 2)
    _check_lattn(*inputs, 77)


def test_lean_attention_runs_the_nsync_lattn_symbols(gen):
    """By the profiler's kernel names, which the benchmark's
    lattn_roofline_pct.train reads."""
    q, k, v, dout, bits = _lattn_inputs(gen, 4, 4, 128, 128, 64, 77)

    def run():
        la.lean_attention_fwd_cuda(q, k, v, bits, 0.125, 77)
        la.lean_attention_bwd_cuda(dout, q, k, v, bits, 0.125, 77)
        torch.cuda.synchronize()

    names = _kernel_names(run, "nsync_lattn_")
    assert any("nsync_lattn_fwd<64>" in n for n in names), names
    assert any("nsync_lattn_bwd<64>" in n for n in names), names


def test_lean_attention_refusals(gen):
    q, k, v, dout, bits = _lattn_inputs(gen, 2, 4, 16, 16, 64, 77)
    fwd, bwd = la.lean_attention_fwd_cuda, la.lean_attention_bwd_cuda
    with pytest.raises(TypeError, match="bf16"):
        fwd(q.float(), k.float(), v.float(), bits, 0.125, 77)
    long_q, long_k, long_v, _, long_bits = _lattn_inputs(gen, 1, 2, 129, 129,
                                                         64, 77)
    with pytest.raises(ValueError, match="Tq 129"):
        fwd(long_q, long_k, long_v, long_bits, 0.125, 77)
    narrow = [t[..., :24] for t in (q, k, v)]
    with pytest.raises(ValueError, match="h 24"):
        fwd(*(t.contiguous() for t in narrow), bits, 0.125, 77)
    flat = torch.zeros(q.numel() + 1, device="cuda", dtype=torch.bfloat16)
    misaligned = flat[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        fwd(misaligned, k, v, bits, 0.125, 77)
    wide = torch.zeros(*q.shape[:-1], 128, device="cuda",
                       dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="stride"):
        bwd(wide, q, k, v, bits, 0.125, 77)
    with pytest.raises(ValueError, match="bits"):
        fwd(q, k, v, None, 0.125, 77)
    with pytest.raises(ValueError, match="bits"):
        fwd(q, k, v, bits[:, :2], 0.125, 77)


def test_bf16_train_step_runs_the_lean_attention_kernels(gen, monkeypatch):
    """A tiny bf16 step at dropout 0.3 on the card: each of its 6 attention
    sites (2 encoder and 2 decoder self-attentions, 2 cross-attentions)
    launches the forward and the backward kernel once; its loss and grad
    norm near the same step with the composed core on the card."""
    cfg = Config(hidden_dim=64, n_layers=2, num_heads=4, input_dim=32,
                 output_dim=7, dropout=0.3, use_amp=True)
    weights = init_seq2seq(cfg, gen, device="cuda").state_dict()
    src, trg = _randn(gen, 4, 24, 32), _randn(gen, 4, 24, 7)
    runs = {}
    real = la.takes_kernel
    for kernel in (True, False):
        monkeypatch.setattr(la, "takes_kernel",
                            lambda q, k, on=kernel: on and real(q, k))
        state = init_train_state(cfg, 5, device="cuda", state_dict=weights)
        kernels.reset_launches()
        _, loss, norm = make_train_step(cfg)(state, src, trg,
                                             torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        runs[kernel] = (float(loss), float(norm), dict(kernels.LAUNCHES))
    assert runs[True][2]["lean_attention_fwd"] == 6
    assert runs[True][2]["lean_attention_bwd"] == 6
    assert not {"lean_attention_fwd", "lean_attention_bwd"} & set(runs[False][2])
    assert runs[True][0] == pytest.approx(runs[False][0], rel=1e-3)
    assert runs[True][1] == pytest.approx(runs[False][1], rel=1e-2)

"""Kernels K1, K4, K3 (forward and backward) and K2 on the card, against
their plain versions.

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
from neurosync_trainer_lite_tpu_torch.models import seq2seq
from neurosync_trainer_lite_tpu_torch.ops import ffn_bwd
from neurosync_trainer_lite_tpu_torch.ops import flash_attention as fa
from neurosync_trainer_lite_tpu_torch.ops import fused_attention as fua
from neurosync_trainer_lite_tpu_torch.ops import kernels
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
    with torch.no_grad():
        kernels.reset_launches()
        a = auto(src)
        assert dict(kernels.LAUNCHES) == {"rope_rotate": 2 + 2 * 3 * 2}
        kernels.reset_launches()
        p = pallas(src)
        assert dict(kernels.LAUNCHES) == {"rope_rotate": 2,
                                          "fused_rope_attention": 3 * 2}
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
    for name, fn in (("default", seq2seq._ffn), ("fused", ffn_bwd.ffn_fused)):
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

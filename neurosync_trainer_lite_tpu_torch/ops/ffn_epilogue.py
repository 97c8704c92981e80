"""The FFN core's hidden-width epilogues as CUDA kernels, one pass each
way, and their plain versions.

The bf16 training FFN (models/layers.py:_FfnCore) computes its two products
with fp32 outputs (attention._mm_f32) and everything between them over the
[rows, F] hidden activation: the bias, the rounding to bf16, the ReLU or
exact GELU, the dropout and, in the backward, the mask again and GELU's
derivative. The kernels are csrc/ffn_epilogue.cu (its head note says what
bounds them on the H100 and how their design answers that). The plain
versions below are the contract in PyTorch ops, bf16 storage with fp32
math; q is the uint8 drop threshold over the bits of
attention.dropout_bits (keep iff bits >= q, none at q 0) and s the
bf16-rounded 256 / (256 - q):

    forward   h1 = bf16(p32 + b1), a = act(h1) (GELU: bf16 of the fp32
              x·0.5·(1 + erf(x·√½))), then keep ? bf16(a·s) : 0
    backward  da = bf16(da32); ReLU: dh1 = r > 0 ? bf16(da·s) : 0 with r
              the dropped activation; GELU: da dropped as above, then
              dh1 = bf16(da · gelu_grad(h1)) in fp32, and the forward's
              dropped GELU of h1 again, the operand of dw2; db1 = Σ_rows
              dh1 in fp32

It is what a CPU tensor gets, and what the kernels are held against on the
card: the elementwise steps round where the composition rounds, so only
db1, summed in another order, and erf and exp where the card's libraries
differ, may differ. A tensor on the card always takes the kernels, whose
entry points raise on what they do not take.

Under tensor parallelism a rank's bits are a column block of the global
draw, rows F·tp apart: the kernels take the bits' row stride.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from neurosync_trainer_lite_tpu_torch.ops import kernels
from neurosync_trainer_lite_tpu_torch.ops.attention import _bf16_value, _drop

#: the FFN activations by name: ReLU (the Seq2Seq) and the exact, erf GELU
#: (wav2vec 2.0); the kernels' template parameter, in this order
ACTIVATIONS = {"relu": torch.relu, "gelu": F.gelu}
_ACT_CODE = {name: i for i, name in enumerate(ACTIVATIONS)}


def gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d GELU(h) / dh of the exact GELU, in h's type: Φ(h) + h·φ(h)."""
    return (0.5 * (1.0 + torch.erf(h * math.sqrt(0.5)))
            + h * torch.exp(-0.5 * h * h) / math.sqrt(2.0 * math.pi))


def _keep(bits, q: int):
    return None if bits is None else bits >= q


# -- the plain versions: the composed ops, the contract ---------------------


def ffn_epi_fwd_plain(p32, b1, bits, q: int, act: str, dtype=torch.bfloat16):
    """p32 [N, F] fp32, b1 [F] fp32, bits [N, F] uint8 or None → (a, h1) in
    dtype; h1 None for ReLU, whose backward keeps a."""
    h1 = (p32 + b1.float()).to(dtype)
    a = ACTIVATIONS[act](h1)
    keep = _keep(bits, q)
    if keep is not None:
        a = _drop(a, keep, q)
    return a, (h1 if act == "gelu" else None)


def ffn_epi_bwd_plain(da32, r, bits, q: int, act: str):
    """da32 [N, F] fp32, r [N, F] the residual (ReLU: the dropped a; GELU:
    h1), bits as the forward's (ReLU reads none) → (dh1 in r's type, db1
    [F] fp32, the GELU's dw2 operand drop(gelu(h1)) or None for ReLU)."""
    da = da32.to(r.dtype)
    if act == "relu":
        dh1 = torch.where(r > 0, da * _bf16_value(256.0 / (256 - q)), 0)
        return dh1, dh1.float().sum(0), None
    a = F.gelu(r)
    keep = _keep(bits, q)
    if keep is not None:
        a, da = _drop(a, keep, q), _drop(da, keep, q)
    del keep
    dh1 = (da.float() * gelu_grad(r.float())).to(r.dtype)
    return dh1, dh1.float().sum(0), a


# -- the kernels --------------------------------------------------------------


def takes_kernel(t) -> bool:
    """Whether the kernels run an epilogue over t: wherever t is on the
    card (the core is bf16 by its own gate); the CPU takes the plain
    versions."""
    return t.is_cuda


def _check(t, dtype, name: str, like=None):
    """Raise unless t is [N, F] of dtype as the kernels load it: contiguous
    on the card, F a multiple of 8, on a 16-byte boundary, of like's
    shape."""
    if not (t.dtype == dtype and t.is_cuda and t.dim() == 2
            and t.is_contiguous() and t.shape[-1] % 8 == 0
            and t.data_ptr() % 16 == 0
            and (like is None or t.shape == like.shape)):
        raise ValueError(
            f"ffn_epilogue: {name} must be a contiguous {dtype} [N, F] CUDA "
            f"tensor on a 16-byte boundary, F a multiple of 8"
            + ("" if like is None else f", of shape {tuple(like.shape)}")
            + f"; got {t.dtype} {tuple(t.shape)} on {t.device}")


def _bits_args(bits, q: int, like):
    """(pointer, row stride, q, bf16 scale) of the bits, which the kernels
    read 8 at a time: uint8 of like's shape on its card, unit column
    stride, rows and start on 8-byte boundaries; a null pointer where
    nothing is dropped."""
    if bits is not None and not (
            bits.dtype == torch.uint8 and bits.shape == like.shape
            and bits.device == like.device and bits.stride(-1) == 1
            and bits.stride(0) % 8 == 0 and bits.data_ptr() % 8 == 0):
        raise ValueError("ffn_epilogue: bits must be uint8 of the hidden "
                         "shape, unit column stride, 8-byte aligned rows")
    if bits is None or q <= 0:
        return None, 0, 0, 1.0
    if q >= 256:
        raise ValueError(f"ffn_epilogue: threshold {q} drops everything")
    return bits.data_ptr(), bits.stride(0), q, _bf16_value(256.0 / (256 - q))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def ffn_epi_fwd_cuda(p32, b1, bits, q: int, act: str):
    """Launch nsync_ffn_fwd; returns what ffn_epi_fwd_plain returns in
    bf16. Raises on anything it does not take."""
    _check(p32, torch.float32, "p32")
    rows, width = p32.shape
    if b1.numel() != width or b1.device != p32.device:
        raise ValueError(f"ffn_epilogue: b1 must hold {width} values on "
                         f"{p32.device}")
    b1 = kernels.aligned16(b1.float().reshape(width))
    ptr, stride, q, scale = _bits_args(bits, q, p32)
    a = torch.empty(rows, width, dtype=torch.bfloat16, device=p32.device)
    h1 = torch.empty_like(a) if act == "gelu" else None
    if rows:
        status = kernels.library("ffn_epilogue").ffn_epi_fwd(
            p32.data_ptr(), b1.data_ptr(), ptr, stride, q, scale,
            _ACT_CODE[act], a.data_ptr(), None if h1 is None else
            h1.data_ptr(), rows, width, _stream(p32))
        kernels.check_launch(status, "ffn_epi_fwd")
    return a, h1


def ffn_epi_bwd_cuda(da32, r, bits, q: int, act: str):
    """Launch nsync_ffn_bwd and its db1 finishing pass nsync_ffn_db1;
    returns what ffn_epi_bwd_plain returns in bf16."""
    _check(da32, torch.float32, "da32")
    _check(r, torch.bfloat16, "r", like=da32)
    rows, width = r.shape
    if act == "relu":   # the mask is in r; the scale stays
        ptr, stride, scale = None, 0, _bf16_value(256.0 / (256 - q))
    else:
        ptr, stride, q, scale = _bits_args(bits, q, r)
    dh1 = torch.empty_like(r)
    a = torch.empty_like(r) if act == "gelu" else None
    if rows == 0:
        return dh1, torch.zeros(width, device=r.device), a
    lib = kernels.library("ffn_epilogue")
    blocks = lib.ffn_epi_bwd_blocks(rows, width)
    part = torch.empty(blocks, width, device=r.device)
    db1 = torch.empty(width, device=r.device)
    status = lib.ffn_epi_bwd(
        da32.data_ptr(), r.data_ptr(), ptr, stride, q, scale, _ACT_CODE[act],
        dh1.data_ptr(), None if a is None else a.data_ptr(), part.data_ptr(),
        db1.data_ptr(), rows, width, blocks, _stream(r))
    kernels.check_launch(status, "ffn_epi_bwd")
    return dh1, db1, a


# -- the routes: the kernels on the card, else plain -------------------------


def ffn_epi_fwd(p32, b1, bits, q: int, act: str, dtype=torch.bfloat16):
    """The forward epilogue: (a, h1), h1 None for ReLU."""
    if takes_kernel(p32):
        return ffn_epi_fwd_cuda(p32, b1, bits, q, act)
    return ffn_epi_fwd_plain(p32, b1, bits, q, act, dtype)


def ffn_epi_bwd(da32, r, bits, q: int, act: str):
    """The backward epilogue: (dh1, db1, the GELU's dw2 operand or None)."""
    if takes_kernel(r):
        return ffn_epi_bwd_cuda(da32, r, bits, q, act)
    return ffn_epi_bwd_plain(da32, r, bits, q, act)

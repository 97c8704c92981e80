"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit) and the least time of a piece of work.

A copy of chip_smoke.py's arithmetic (its HBM_BYTES_PER_S, FP32_FLOP_PER_S,
BF16_FLOP_PER_S and bound()), kept here so that the yardstick cannot move
with the program.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # HBM3
FP32_FLOP_PER_S = 67e12        # fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # bf16 on the tensor cores, dense


def bound_s(bytes_moved: float, flops: float = 0.0,
            bf16_flops: float = 0.0) -> tuple[float, str]:
    """(seconds, what bounds it): `flops` on fp32 operands at the CUDA
    cores' peak and `bf16_flops` at the tensor cores', which run alongside
    each other and alongside the memory, so the largest of the three
    times is the least the work can take."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    by_ops = max(flops / FP32_FLOP_PER_S, bf16_flops / BF16_FLOP_PER_S)
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")

"""lattn_roofline_pct.train: the lean attention kernels
(csrc/lean_attention.cu, `nsync_lattn_*`) against their roofline in the
profiled steps. Every training attention site of the three cells runs them
at one shape, [B, n, T, h] with B the cell's windows a card, T its window's
frames and n·h its hidden width (validation forwards take the composed
path and launch none).

- Least bytes, in bf16: q, k, v read and out written once each for a
  forward launch; q, k, v and dout read and dq, dk and dv written for a
  backward launch. The dropout bits the kernels read are left out, so the
  yardstick holds for a kernel that draws its own bits, and the reading
  cannot overstate.
- Products at the tensor cores' bf16 peak: q·kᵀ and wd·v forward
  (4·B·n·T²·h), and q·kᵀ, dout·vᵀ, wdᵀ·dout, ds·k and dsᵀ·q backward
  (8·B·n·T²·h, the recompute of the scores not counted).

The larger of the two least times (common/peaks.py:bound_s), summed over
the launches, divided by the summed device time of every `nsync_lattn_`
kernel; nothing where none ran."""

from benchmark.common.peaks import bound_s


def shape(ctx) -> tuple[int, int, int]:
    """(windows a card, frames a window, hidden width)."""
    windows = ctx.params.get("batch_size_per_chip", ctx.config["batch_size"])
    return (int(windows), int(ctx.config["micro_batch_size"]),
            int(ctx.config["hidden_dim"]))


def read(ctx, out):
    prof = out.profile
    if prof is None:
        return None
    n_fwd, _ = prof.kernel_stats(r"nsync_lattn_fwd")
    n_bwd, _ = prof.kernel_stats(r"nsync_lattn_bwd")
    _, us = prof.kernel_stats(r"nsync_lattn_")
    if n_fwd + n_bwd == 0 or us <= 0:
        return None
    windows, frames, width = shape(ctx)
    elements = windows * frames * width
    nbytes = 2 * elements * (4 * n_fwd + 7 * n_bwd)
    flops = elements * frames * (4 * n_fwd + 8 * n_bwd)
    least, _ = bound_s(nbytes, bf16_flops=flops)
    return 100.0 * least * 1e6 / us

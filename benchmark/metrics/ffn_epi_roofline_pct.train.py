"""ffn_epi_roofline_pct.train: the FFN core's hidden-width epilogue kernels
(csrc/ffn_epilogue.cu, `nsync_ffn_*`) against their roofline in the
profiled steps. Every training FFN site of the three cells runs them over
[R, F]: R the cell's windows a card times its window's frames, F the FFN
width, four times the hidden width (the port's Config.ffn_dim; validation
forwards take the composed path and launch none).

- Least bytes an element: 6 for a forward launch (the fp32 product read,
  the bf16 activation written), 8 for a backward launch (the fp32
  cotangent and the bf16 residual read, the bf16 dh1 written). The dropout
  bits, the GELU's writes of its residual in the forward and of dw2's
  operand in the backward, the bias and the db1 scratch are left out, so
  the reading cannot overstate.

That least time over the HBM peak, divided by the summed device time of
every `nsync_ffn_` kernel (the backward's db1 finishing pass included);
nothing where none ran."""

from benchmark.common.peaks import bound_s


def shape(ctx) -> tuple[int, int]:
    """(rows a card, FFN width)."""
    windows = ctx.params.get("batch_size_per_chip", ctx.config["batch_size"])
    return (int(windows) * int(ctx.config["micro_batch_size"]),
            4 * int(ctx.config["hidden_dim"]))


def read(ctx, out):
    prof = out.profile
    if prof is None:
        return None
    n_fwd, _ = prof.kernel_stats(r"nsync_ffn_fwd")
    n_bwd, _ = prof.kernel_stats(r"nsync_ffn_bwd")
    _, us = prof.kernel_stats(r"nsync_ffn_")
    if n_fwd + n_bwd == 0 or us <= 0:
        return None
    rows, width = shape(ctx)
    least, _ = bound_s((6 * n_fwd + 8 * n_bwd) * rows * width)
    return 100.0 * least * 1e6 / us

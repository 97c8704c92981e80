"""ln_roofline_pct.train: the bf16 LayerNorm kernels (csrc/layer_norm.cu,
`nsync_ln_*`) against their roofline in the profiled steps. The least
bytes are each launch's rows read and written once in bf16: 4 bytes an
element for a forward (x read, out written), 6 for a backward (x and dout
read, dx written), over R rows of the config's hidden width a card, R the
cell's windows a card times the window's frames (validation batches are
full too). The statistics, the parameters and the backward's scratch are
left out, so the reading cannot overstate. That least time over the HBM
peak, divided by the summed device time of every `nsync_ln_` kernel (the
backward's finishing pass included); nothing where none ran."""

from benchmark.common.peaks import bound_s


def rows_per_card(ctx) -> int:
    windows = ctx.params.get("batch_size_per_chip", ctx.config["batch_size"])
    return int(windows) * int(ctx.config["micro_batch_size"])


def read(ctx, out):
    prof = out.profile
    if prof is None:
        return None
    n_fwd, _ = prof.kernel_stats(r"nsync_ln_fwd")
    n_bwd, _ = prof.kernel_stats(r"nsync_ln_bwd(?!_params)")
    _, us = prof.kernel_stats(r"nsync_ln_")
    if n_fwd + n_bwd == 0 or us <= 0:
        return None
    nbytes = (4 * n_fwd + 6 * n_bwd) * rows_per_card(ctx) * int(
        ctx.config["hidden_dim"])
    least, _ = bound_s(nbytes)
    return 100.0 * least * 1e6 / us

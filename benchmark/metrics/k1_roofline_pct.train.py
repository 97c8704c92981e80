"""k1_roofline_pct.train: kernel K1 (`rope_rows`, csrc/rope.cu) against
its roofline: the least time of its bytes at the cell's shape (each input
read once, each output written once, common/flops.py:rope_bytes) over the
HBM peak, divided by its mean device time in the profiled steps. Every K1
launch of a training step at this shape moves the same bytes; nothing
where K1 did not run."""

from benchmark.common.peaks import bound_s


def read(ctx, out):
    prof, nbytes = out.profile, out.extras.get("k1_bytes")
    if prof is None or not nbytes:
        return None
    launches, us = prof.kernel_stats(r"rope_rows")
    if launches == 0 or us <= 0:
        return None
    least, _ = bound_s(nbytes)
    return 100.0 * least * 1e6 / (us / launches)

"""allreduce_exposed_pct.dp: the share of rank 0's profiled data-parallel
steps in which NCCL kernels (the flat gradient all-reduce of
parallel/distributed.py, and the loop's small flag and loss reductions)
run with no other device operation beside them."""


def read(ctx, out):
    prof = out.profile
    if prof is None or prof.window_us <= 0:
        return None
    launches, _ = prof.kernel_stats(r"nccl|Nccl")
    if launches == 0:
        return None
    return 100.0 * prof.exposed_us(r"nccl|Nccl") / prof.window_us

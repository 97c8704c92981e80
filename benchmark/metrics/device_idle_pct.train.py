"""device_idle_pct.train: 100 − the union of the kernel and memory-copy
intervals over the profiled stretch of training steps, as a share of it."""


def read(ctx, out):
    return None if out.profile is None else out.profile.idle_pct()

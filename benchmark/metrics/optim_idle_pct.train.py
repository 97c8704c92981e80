"""optim_idle_pct.train: the card's idle time over the profiled training
steps that falls inside the optimizer's spans (`nsync.optim.*`: zero_grad,
the clip, Adam), as a share of the profiled stretch (common/spans.py).
Nothing where the program records no span."""

from benchmark.common.spans import idle_pct


def read(ctx, out):
    return None if out.profile is None else idle_pct(out.profile, "optim")

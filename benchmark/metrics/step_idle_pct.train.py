"""step_idle_pct.train: the card's idle time over the profiled training
steps that falls inside the step's host dispatch (`nsync.step`: forward,
backward, the data-parallel all-reduce) and inside no optimizer span, as
a share of the profiled stretch (common/spans.py). Nothing where the
program records no span."""

from benchmark.common.spans import idle_pct


def read(ctx, out):
    return None if out.profile is None else idle_pct(out.profile, "step")

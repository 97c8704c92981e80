"""loop_idle_pct.train: the card's idle time over the profiled training
steps that falls inside the training loop's own spans (`nsync.loop.*`:
the epoch's bookkeeping, the wait on the prefetch queue, the upload, the
validation, the epoch's sync) and inside no step or optimizer span, as a
share of the profiled stretch (common/spans.py). Nothing where the
program records no span."""

from benchmark.common.spans import idle_pct


def read(ctx, out):
    return None if out.profile is None else idle_pct(out.profile, "loop")

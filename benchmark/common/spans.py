"""The card's idle time over a profiled stretch, assigned to the program's
spans.

The port records spans named `nsync.<group>.<what>` while a profiler runs
(`utils/profiling.py:span`): host ranges in the same trace, on the same
clock, as the device operations. Each idle microsecond of the window (the
stretches that no device operation covers: `Profile.gaps`, whose sum is
what `device_idle_pct` counts) goes to the innermost span of a group that
covers it, the shortest where several do, or to 'unattributed' where none
does. The groups:

- 'loop': `nsync.loop.*`, the training loop (training/loop.py): the epoch
  around everything, the batch wait, the upload, the validation, the
  epoch's sync;
- 'step': `nsync.step` and `nsync.step.*`, the step's host dispatch
  (training/step.py): forward, backward, the data-parallel all-reduce;
- 'optim': `nsync.optim.*`: zero_grad, the clip and Adam.

Other `nsync.` names claim no idle time.
"""

from __future__ import annotations

GROUPS = ("loop", "step", "optim")
UNATTRIBUTED = "unattributed"


def group_of(name: str) -> str | None:
    for group in GROUPS:
        prefix = f"nsync.{group}"
        if name == prefix or name.startswith(prefix + "."):
            return group
    return None


def idle_us(profile) -> dict[str, float] | None:
    """Idle µs of the profile's window by group, and 'unattributed'; the
    values sum to the window's idle time. None where the profile holds no
    device operation or no span of a group."""
    spans = [(a, b, group) for a, b, name in profile.host
             if (group := group_of(name)) is not None]
    if not spans or profile.idle_pct() is None:
        return None
    lo, hi = profile.window
    points = sorted({lo, hi} | {min(max(t, lo), hi)
                                for a, b, _ in spans for t in (a, b)})
    # the innermost group span over each stretch between two boundaries
    owners = []
    for x, y in zip(points, points[1:]):
        mid = (x + y) / 2
        cover = [(b - a, group) for a, b, group in spans if a <= mid < b]
        owners.append(min(cover)[1] if cover else UNATTRIBUTED)
    out = dict.fromkeys(GROUPS + (UNATTRIBUTED,), 0.0)
    j = 0
    for ga, gb in sorted(profile.gaps()):
        while j < len(owners) and points[j + 1] <= ga:
            j += 1
        k = j
        while k < len(owners) and points[k] < gb:
            out[owners[k]] += min(gb, points[k + 1]) - max(ga, points[k])
            k += 1
    return out


def idle_pct(profile, group: str) -> float | None:
    """The group's idle µs as a share (%) of the profiled window."""
    shares = idle_us(profile)
    if shares is None or profile.window_us <= 0:
        return None
    return 100.0 * shares[group] / profile.window_us

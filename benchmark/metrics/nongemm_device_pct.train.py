"""nongemm_device_pct.train: the share of the profiled training steps'
compute kernel time (collectives left out) in kernels that are not matrix
products, classified by name (common/profile.py:KERNEL_CLASSES). The
longest-running names that no pattern classifies are printed on standard
error."""

import sys


def read(ctx, out):
    prof = out.profile
    if prof is None:
        return None
    total = sum(prof.class_us().values()) or 1.0
    for cls, us in prof.class_us().most_common():
        print(f"kernel class {cls}: {100 * us / total:.2f}%", file=sys.stderr)
    for name, us in prof.unclassified():
        print(f"unclassified kernel {us / 1e3:.3f} ms: {name[:120]}",
              file=sys.stderr)
    classes = prof.class_us()
    compute = sum(classes.values()) - classes["collective"]
    if compute <= 0:
        return None
    return 100.0 * (compute - classes["gemm"]) / compute

"""posconv_roofline_pct.train: the positional conv embedding
(models/wav2vec2.py) against its roofline in the profiled steps. Its model
FLOPs are 2 · B · T · H · (H / groups) · kernel a forward over B windows
a card (common/flops_w2v.py), and as many again for each of dgrad and
wgrad in a backward. The work counted is that of exactly the launches
timed: each `nsync.w2v.pos_conv` span (a training or a validation
forward: the weight norm, the layout copies, the conv, GELU) counts one
forward, each `nsync.w2v.pos_conv_bwd` span (its autograd backward: dx
and dweight, the bias gradient) two more, and the time is every kernel
launched inside either (common/span_kernels.py). That work at the bf16
dense peak, over the time; it cannot pass 100%. Nothing where the
program records no such span."""

from benchmark.common.peaks import BF16_FLOP_PER_S


def read(ctx, out):
    spans, fwd = out.extras.get("span_kernels"), out.extras.get(
        "pos_conv_fwd_flops")
    if not spans or not fwd:
        return None
    f = spans.get("nsync.w2v.pos_conv", {})
    b = spans.get("nsync.w2v.pos_conv_bwd", {})
    us = f.get("us", 0.0) + b.get("us", 0.0)
    if us <= 0 or not f.get("launches"):
        return None
    work = fwd * (f.get("instances", 0) + 2 * b.get("instances", 0))
    return 100.0 * work / BF16_FLOP_PER_S / (us * 1e-6)

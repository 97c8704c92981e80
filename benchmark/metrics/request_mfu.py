"""request_mfu: the forward FLOPs of the chunks that the reference's
chunking defines for each served request's length (no bucket padding),
over the summed request seconds × the bf16 tensor-core peak."""

from benchmark.common.peaks import BF16_FLOP_PER_S


def read(ctx, out):
    flops, seconds = out.extras.get("served_flops"), out.extras.get(
        "request_s")
    if not flops or not seconds:
        return None
    return 100.0 * flops / (seconds * ctx.chips * BF16_FLOP_PER_S)

"""train_mfu: the model FLOPs of the window's train and eval steps
(common/flops.py, from shapes, no recompute) over the window's seconds ×
chips × the bf16 tensor-core peak. Reads the timed window, not the trace."""

from benchmark.common.peaks import BF16_FLOP_PER_S


def read(ctx, out):
    flops = out.extras.get("model_flops")
    if not flops or out.window_s <= 0:
        return None
    return 100.0 * flops / (out.window_s * ctx.chips * BF16_FLOP_PER_S)

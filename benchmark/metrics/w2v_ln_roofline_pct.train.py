"""w2v_ln_roofline_pct.train: the bf16 LayerNorm kernels (csrc/layer_norm.cu,
`nsync_ln_*`) on the wav2vec2 path against their roofline in the profiled
steps, each launch's least bytes from its own rows and width.
ln_roofline_pct.train counts every launch at rows × hidden_dim, which this
path's LayerNorms are not: the frozen frontend's channel LayerNorms run at
conv_dim[-1] over each conv's frames of the batch (B · 6,825 down to
B · 106 rows at the published widths), the feature projection's at
conv_dim[-1] over the batch's frames, the rest at hidden_dim over them.

- A launch's width comes from its kernel's instantiation,
  nsync_ln_fwd<V, NV> or nsync_ln_bwd<V, NV>: NV = ceil(width / 256), the
  16-byte vectors a lane holds. The configuration's two widths must give
  two NV, else nothing is read.
- Rows: a launch at hidden_dim runs over the batch's frames (B · T a card;
  validation batches are full). Of the forwards at conv_dim[-1], each
  `nsync.w2v.frontend` span (its occurrences from common/span_kernels.py)
  holds len(conv_dim), one over each conv's frames of the batch; the
  other forwards and every backward at conv_dim[-1] are the projection's,
  over B · T rows.

The least bytes are 4 an element for a forward (x read, out written in
bf16) and 6 for a backward (x and dout read, dx written), as
ln_roofline_pct.train counts them; the statistics, the parameters and the
backward's scratch are left out, so the reading cannot overstate. That
least time over the HBM peak, divided by the summed device time of every
`nsync_ln_` kernel (the backward's finishing pass included); nothing where
none ran or the program records no frontend span."""

from benchmark.common.peaks import bound_s
from benchmark.reference.wav2vec2 import dims, encoder_frames


def vectors(width: int) -> int:
    return -(-width // 256)


def read(ctx, out):
    prof, spans = out.profile, out.extras.get("span_kernels")
    if prof is None or not spans:
        return None
    d = dims(ctx.config)
    narrow, wide = d["conv_dim"][-1], d["hidden"]
    if vectors(narrow) == vectors(wide):
        return None
    batch = int(ctx.params.get("batch_size_per_chip",
                               ctx.config["batch_size"]))
    rows = batch * d["frames"]

    def launches(kind: str, width: int) -> int:
        return prof.kernel_stats(
            rf"nsync_ln_{kind}<\d+, ?{vectors(width)}>")[0]

    frontends = spans.get("nsync.w2v.frontend", {}).get("instances", 0)
    projection_fwd = launches("fwd", narrow) - frontends * len(d["conv_dim"])
    _, us = prof.kernel_stats(r"nsync_ln_")
    if frontends <= 0 or projection_fwd < 0 or us <= 0:
        return None
    fwd_elements = (frontends * batch * sum(encoder_frames(d)) * narrow
                    + projection_fwd * rows * narrow
                    + launches("fwd", wide) * rows * wide)
    bwd_elements = rows * (launches("bwd", narrow) * narrow
                           + launches("bwd", wide) * wide)
    least, _ = bound_s(4 * fwd_elements + 6 * bwd_elements)
    return 100.0 * least * 1e6 / us

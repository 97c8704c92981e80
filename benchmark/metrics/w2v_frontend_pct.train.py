"""w2v_frontend_pct.train: the device time of the kernels launched inside
the program's span `nsync.w2v.frontend` (models/wav2vec2.py: the
waveform normalisation, the frozen conv stack with its channel
LayerNorms and GELUs, the interpolation), as a share of the profiled
compute-kernel time (collectives left out). Kernels go to spans by the
trace's correlation ids (common/span_kernels.py). Nothing where the
program records no such span."""


def read(ctx, out):
    spans, prof = out.extras.get("span_kernels"), out.profile
    if not spans or prof is None:
        return None
    mine = spans.get("nsync.w2v.frontend", {}).get("us", 0.0)
    classes = prof.class_us()
    compute = sum(classes.values()) - classes["collective"]
    if mine <= 0 or compute <= 0:
        return None
    return 100.0 * mine / compute

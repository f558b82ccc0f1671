"""The whole control step's share of the card's float32 peak, in percent:
the operations a control step of the fused path needs (frame_skip
substeps, each counted as kernel 1's and kernel 2 fused's arithmetic for
the configuration at the cell's batch) over the traced slice's span per
control step, both ends read from the profile, against 67 TFLOP/s.  The
profiler slows the host, so this reads below an untraced step's share."""
from benchmark.work import k1_substep, k2_fused
from benchmark.work.peaks import PEAK_F32_FLOPS


def read(ctx):
    p = ctx.profile
    if p is None or p.window_s <= 0:
        return None
    flops = (k1_substep.work(ctx.config, ctx.batch)[1]
             + k2_fused.work(ctx.config, ctx.batch)[1])
    flops *= int(ctx.config["frame_skip"])
    return 100.0 * flops * p.steps / (p.window_s * PEAK_F32_FLOPS)

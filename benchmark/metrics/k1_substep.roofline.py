"""The share of its roofline that k1_substep reaches in the traced slice: the
least time of one launch's work (benchmark/work/k1_substep.py, from the
configuration's sizes and the cell's batch, against the H100's published
peaks) over the mean device time per launch, in percent."""
from benchmark.work import k1_substep as kernel
from benchmark.work.peaks import least_ms


def read(ctx):
    if ctx.profile is None:
        return None
    got = ctx.profile.kernel_ms(kernel.KERNEL)
    if got is None:
        return None
    return 100.0 * least_ms(*kernel.work(ctx.config, ctx.batch))[0] / got[1]

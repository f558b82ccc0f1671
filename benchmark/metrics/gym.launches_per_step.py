"""Device operations per env.step call of the gym surface, the reset that
follows a done included."""
from benchmark.harness.trace import BENCH_RANGES


def read(ctx):
    if ctx.profile is None:
        return None
    return ctx.profile.launches(exclude=BENCH_RANGES)

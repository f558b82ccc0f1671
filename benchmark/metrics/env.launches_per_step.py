"""Device operations per control step launched outside the engine's ranges
and the benchmark's own: the env layer (parallel/vec_env, envs/base, the
task hooks, the auto-reset)."""
from benchmark.harness.trace import BENCH_RANGES, ENGINE_RANGES


def read(ctx):
    if ctx.profile is None:
        return None
    return ctx.profile.launches(exclude=ENGINE_RANGES + BENCH_RANGES)

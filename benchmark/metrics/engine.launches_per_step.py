"""Device operations per control step launched inside the engine's
record_function ranges (engine/world.py): substep_fused, or dynamics,
collision, constraints, integrate."""
from benchmark.harness.trace import ENGINE_RANGES


def read(ctx):
    if ctx.profile is None:
        return None
    return ctx.profile.launches(ranges=ENGINE_RANGES)

"""Device operations per control step launched with the span env.reset
innermost: VecEnv.step's auto-reset (the reset state of every env and
the per-env select on done)."""


def read(ctx):
    p = ctx.profile
    if p is None or "env.reset" not in p.ranges:
        return None
    return p.launches(ranges=("env.reset",))

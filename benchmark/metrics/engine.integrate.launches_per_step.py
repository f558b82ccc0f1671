"""Device operations per control step launched with the span integrate
innermost: the position update, nested in the fused phase or the
phase-wise stage of that name."""


def read(ctx):
    p = ctx.profile
    if p is None or "integrate" not in p.ranges:
        return None
    return p.launches(ranges=("integrate",))

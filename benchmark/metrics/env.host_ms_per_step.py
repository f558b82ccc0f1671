"""Host ms per control step inside the span env.step less the time that
the engine's ranges inside it cover: the env layer's self time (the
auto-reset, the action map, obs, reward, done, the episode cap)."""
from benchmark.harness.trace import ENGINE_RANGES


def read(ctx):
    p = ctx.profile
    if p is None or "env.step" not in p.ranges:
        return None
    engine = sorted(s for n in ENGINE_RANGES for s in p.ranges.get(n, ()))
    own = 0.0
    for a, b in p.ranges["env.step"]:
        own += b - a
        end = a           # engine time inside [a, b] counted up to `end`
        for x, y in engine:
            x, y = max(x, end), min(y, b)
            if y > x:
                own -= y - x
                end = y
    return own * 1e-3 / p.steps

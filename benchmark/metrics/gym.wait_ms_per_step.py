"""Host ms per env.step call inside the span gym.host_copy: the one copy
of obs, reward, done and the overflow count to the host, which waits for
the card to finish the step."""


def read(ctx):
    p = ctx.profile
    if p is None or "gym.host_copy" not in p.ranges:
        return None
    return sum(b - a for a, b in p.ranges["gym.host_copy"]) * 1e-3 / p.steps

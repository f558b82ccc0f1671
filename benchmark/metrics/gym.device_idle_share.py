"""The share of the traced slice's wall span in which no kernel, copy or
set ran on the card, in percent (one profile gives both)."""


def read(ctx):
    p = ctx.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)

"""The 99th percentile, over every env and substep of the after-window
pass, of kernel 1's PGS residual before the escalation (the hook's
res_pre)."""
import torch


def read(ctx):
    if ctx.residual is None:
        return None
    x = ctx.residual["res_pre"].double()
    return float(torch.nanquantile(x, 0.99))

"""The 99th percentile, over every env and substep of the after-window
pass, of the post-escalation residual that escalate_batch(with_diag=True)
records (validation/residual.make_envelope_substep)."""
import torch


def read(ctx):
    if ctx.residual is None:
        return None
    x = ctx.residual["envelope"].double()
    return float(torch.nanquantile(x, 0.99))

"""The complementarity-residual metric that ranks envs for exact
escalation (the escalation stage itself lives in
engine/hopper_substep.escalate_batch)."""
from __future__ import annotations

import torch

from dartenv_tpu_torch.lcp.pgs import findex_tensors


def comp_residual(A, b, x, lo, hi, findex, mu, active):
    """Normalized max complementarity violation at x's own friction-bound
    fixed point over active rows.  A: (..., m, m), vectors (..., m);
    returns (...,) scalars normalized by max(1, |x|_inf) per problem."""
    fidx, has_f = findex_tensors(findex, x.device)
    has_f = has_f.to(x.dtype)
    bd = mu * torch.abs(x[..., fidx]) * has_f + 1e20 * (1 - has_f)
    lo_e = torch.maximum(lo, -bd)
    hi_e = torch.minimum(hi, bd)
    w = torch.sum(A * x[..., None, :], dim=-1) + b
    scale = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True),
                        min=1.0)
    eps = 1e-6 * scale + 1e-9
    at_lo = x <= lo_e + eps
    at_hi = x >= hi_e - eps
    zero = torch.zeros_like(w)
    res = torch.where(at_lo & at_hi, zero,
                      torch.where(at_lo, -w,
                                  torch.where(at_hi, w, torch.abs(w))))
    res = torch.maximum(res, torch.maximum(lo_e - x, x - hi_e))
    res = torch.where(active > 0.5, res, zero)
    return torch.amax(res / scale, dim=-1)

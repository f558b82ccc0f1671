"""Boxed LCP by projected Gauss-Seidel, batch-first.

Problem:  find lam in [lo', hi'] with  w = A lam + b  satisfying the boxed
complementarity conditions, where rows with findex >= 0 have
friction-coupled bounds lo' = -mu * lam[findex], hi' = +mu * lam[findex]
(the ODE `findex` convention).  The sweep visits rows in the static order
0..m-1, so the result is deterministic.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_FINDEX_CACHE: Dict[Tuple[bytes, str], Tuple[torch.Tensor, torch.Tensor]] = {}


def findex_tensors(findex, device):
    """(fidx int64 (m,), has_f bool (m,)) of a static findex array on
    `device`: max(findex, 0) and findex >= 0.  Cached, so hot-path callers
    do not copy the same few integers to the device every substep."""
    findex = np.asarray(findex, dtype=np.int64)
    key = (findex.tobytes(), str(device))
    if key not in _FINDEX_CACHE:
        _FINDEX_CACHE[key] = (
            torch.as_tensor(np.maximum(findex, 0), device=device),
            torch.as_tensor(findex >= 0, device=device))
    return _FINDEX_CACHE[key]


def pgs_solve(A, b, lo, hi, findex, mu, active, iters: int = 30,
              lam0=None, omega: float = 1.0):
    """A: (B, m, m); b, lo, hi, mu, active: (B, m); findex: length-m numpy
    int array (-1 = plain bounds).  Inactive rows are pinned to lam = 0.
    Returns lam (B, m)."""
    m = A.shape[-1]
    if m == 0:
        return torch.zeros_like(b)
    findex = np.asarray(findex)
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    inv_diag = torch.where(diag > 1e-12,
                           1.0 / torch.clamp(diag, min=1e-12),
                           torch.zeros_like(diag))
    # SOR: omega > 1 over-relaxes each projected update
    inv_diag = inv_diag * omega
    lam = torch.zeros_like(b) if lam0 is None else lam0.clone()
    for _ in range(iters):
        for i in range(m):
            w_i = torch.sum(A[:, i, :] * lam, dim=-1) + b[:, i]
            new = lam[:, i] - w_i * inv_diag[:, i]
            if findex[i] >= 0:
                bound = mu[:, i] * lam[:, int(findex[i])]
                lo_i = torch.maximum(lo[:, i], -bound)
                hi_i = torch.minimum(hi[:, i], bound)
            else:
                lo_i, hi_i = lo[:, i], hi[:, i]
            # clip as min(max(new, lo), hi)
            lam[:, i] = torch.minimum(torch.maximum(new, lo_i),
                                      hi_i) * active[:, i]
    return lam

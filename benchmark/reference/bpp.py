"""The exact boxed-LCP solve by block principal pivoting, plain PyTorch:
a frozen copy of the program's plain version (lcp/hopper_bpp.py), and
the tier policy of the escalation."""


from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.linalg import seq_mv
from benchmark.reference.pgs import findex_tensors

_FREE, _AT_LO, _AT_HI = 0, 1, 2


TIER_POLISH = (3, 6)  # PGS polish sweeps after tier 1 (warm), tier 2 (cold)


def ref_tiers(ref_passes, ref64_passes):
    """(compensated, mixed-precision) passes: the mixed-precision tier wins
    where both are asked for."""
    ref64 = max(0, int(ref64_passes))
    return (0 if ref64 > 0 else int(ref_passes)), ref64


def tier_budgets(iters: int, refine: int, iters2: int, ref_passes: int = 0,
                 ref64_passes: int = 0):
    """(iters1, refine1, polish1, iters2, refine2, polish2, ref_passes,
    ref64_passes) of the escalation's tiers (refine < 0: the default count;
    iters2 = 0: no tier 2, and its refine and polish are 0; ref_passes:
    passes of the compensated refinement tier after them,
    SolverConfig.escalate_ref; ref64_passes: of the mixed-precision tier,
    SolverConfig.escalate_ref64, which wins where both are set)."""
    tier2 = ((int(iters2), _refine_count(iters2, None), TIER_POLISH[1])
             if iters2 > 0 else (0, 0, 0))
    return (int(iters), _refine_count(iters, None if refine < 0 else refine),
            TIER_POLISH[0]) + tier2 + ref_tiers(ref_passes, ref64_passes)


def tier_solvers(findex, budgets):
    """(exact1, exact2) of `budgets` (exact2 None without tier 2): the
    exact solvers of the plain compositions, lcp/dantzig.make_exact_solver.
    Each carries its (iters, refine, polish) as `.budget`, from which
    `solver_budgets` reads the tuple back (the refinement passes are the
    caller's: SolverConfig.escalate_ref)."""
    from benchmark.reference.dantzig import make_exact_solver

    def make(iters, refine, polish):
        solve = make_exact_solver(findex, iters=iters, polish_iters=polish,
                                  refine_iters=refine)
        solve.budget = (iters, refine, polish)
        return solve

    exact2 = make(*budgets[3:6]) if budgets[3] > 0 else None
    return make(*budgets[:3]), exact2


def _refine_count(iters, refine_iters):
    return max(iters // 3, 6) if refine_iters is None else int(refine_iters)


def _gauss_solve(Am, r):
    """Solve Am x = r per problem by unpivoted Gaussian elimination
    (rows below the pivot only) + back substitution.  Am: (B, m, m),
    r: (B, m).  Float64: the library's batched solve (the same solution
    to rounding)."""
    if Am.dtype == torch.float64:
        return torch.linalg.solve_ex(Am, r).result
    m = Am.shape[-1]
    Am = Am.clone()
    r = r.clone()
    for k in range(m - 1):
        f = Am[:, k + 1:, k] / Am[:, k, k, None]            # (B, m-k-1)
        Am[:, k + 1:, k + 1:] -= f[:, :, None] * Am[:, k, None, k + 1:]
        r[:, k + 1:] -= f * r[:, k, None]
    x = torch.empty_like(r)
    for i in range(m - 1, -1, -1):
        xi = r[:, i] / Am[:, i, i]
        x[:, i] = xi
        if i:
            r[:, :i] -= Am[:, :i, i] * xi[:, None]
    return x


def lane_sum(p):
    """p (..., m) summed over its last axis in the order of the kernel's
    polish rows (csrc/pgs_row.h row_dot): lane l's partial over
    j = l, l + 32, ... in order, then the 32 partials added in the tree of
    the xor butterfly (16, 8, 4, 2, 1).  Float64: a plain sum (rounding
    alone differs)."""
    if p.dtype == torch.float64:
        return p.sum(dim=-1)
    m = p.shape[-1]
    R = max(1, -(-m // 32))
    pad = torch.zeros(p.shape[:-1] + (R * 32 - m,), dtype=p.dtype,
                      device=p.device)
    rows = torch.cat([p, pad], dim=-1).reshape(p.shape[:-1] + (R, 32))
    part = torch.zeros_like(rows[..., 0, :])
    for r in range(R):
        part = part + rows[..., r, :]
    for o in (16, 8, 4, 2, 1):
        part = part[..., :o] + part[..., o:2 * o]
    return part[..., 0]


def bpp_solve_reference(A, b, lo, hi, findex, mu, active, iters: int = 24,
                        polish_iters: int = 10, lam0=None,
                        refine_iters=None):
    """Plain PyTorch version of the kernel.  A: (B, m, m); b, lo, hi, mu,
    active, lam0: (B, m); findex: static numpy (m,).  Returns lam (B, m).
    Its sums run in the kernel's order on any device: the matvecs over
    columns in order (math/linalg.seq_mv), a polish row as the kernel's
    lane partials and butterfly (`lane_sum`)."""
    B, m = b.shape
    dtype, device = A.dtype, A.device
    if m == 0:
        return torch.zeros((B, 0), dtype=dtype, device=device)
    findex = np.asarray(findex)
    fidx, has_f = findex_tensors(findex, device)
    eye = torch.eye(m, dtype=dtype, device=device)
    zero = torch.zeros_like(b)
    if lam0 is None:
        lam0 = zero

    def bounds(x):
        fb = mu * torch.abs(x[:, fidx])
        lo_i = torch.where(has_f, torch.maximum(lo, -fb),
                           torch.clamp(lo, min=-1e20))
        hi_i = torch.where(has_f, torch.minimum(hi, fb),
                           torch.clamp(hi, max=1e20))
        return lo_i, hi_i

    def full(v):
        return torch.full_like(state, v)

    def pivot(xb, state):
        lo_i, hi_i = bounds(xb)
        free = (state == _FREE) & (active > 0.5)
        fmask = free.to(dtype)
        x_fixed = torch.where(state == _AT_LO, lo_i,
                              torch.where(state == _AT_HI, hi_i, zero))
        x_fixed = x_fixed * active * (1.0 - fmask)
        Axf = seq_mv(A, x_fixed)
        rhs = -(b + Axf) * fmask
        Am = (A * fmask[:, :, None] * fmask[:, None, :]
              + eye * (1.0 - fmask)[:, None, :])
        x_new = _gauss_solve(Am, rhs) * fmask + x_fixed
        w = seq_mv(A, x_new) + b
        state = torch.where(free & (x_new < lo_i - 1e-12), full(_AT_LO),
                            state)
        state = torch.where(free & (x_new > hi_i + 1e-12), full(_AT_HI),
                            state)
        state = torch.where((state == _AT_LO) & (w < -1e-10), full(_FREE),
                            state)
        state = torch.where((state == _AT_HI) & (w > 1e-10), full(_FREE),
                            state)
        return torch.minimum(torch.maximum(x_new, lo_i), hi_i), state

    # ---- initial partition from the warm start -------------------------
    lo_w, hi_w = bounds(lam0)
    x = torch.minimum(torch.maximum(lam0, lo_w), hi_w)
    state = torch.zeros_like(b, dtype=torch.int32)
    state = torch.where(x <= lo_w + 1e-12, full(_AT_LO), state)
    state = torch.where(x >= hi_w - 1e-12, full(_AT_HI), state)
    w0 = seq_mv(A, x) + b
    state = torch.where((state == _AT_LO) & (w0 < 0.0), full(_FREE), state)
    state = torch.where((state == _AT_HI) & (w0 > 0.0), full(_FREE), state)

    xb = x
    for _ in range(iters):
        x, state = pivot(xb, state)
        xb = 0.5 * (xb + x)
    for _ in range(_refine_count(iters, refine_iters)):
        x, state = pivot(x, state)

    # ---- PGS polish (friction bounds from |lam[findex]|) ---------------
    if polish_iters <= 0:
        return x * active
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    inv_diag = torch.where(diag > 1e-12, 1.0 / torch.clamp(diag, min=1e-12),
                           torch.zeros_like(diag))
    lam = x.clone()
    for _ in range(polish_iters):
        for i in range(m):
            w_i = lane_sum(A[:, i, :] * lam) + b[:, i]
            new = lam[:, i] - w_i * inv_diag[:, i]
            if findex[i] >= 0:
                bound = mu[:, i] * torch.abs(lam[:, int(findex[i])])
                lo_i = torch.maximum(lo[:, i], -bound)
                hi_i = torch.minimum(hi[:, i], bound)
            else:
                lo_i, hi_i = lo[:, i], hi[:, i]
            lam[:, i] = torch.minimum(torch.maximum(new, lo_i),
                                      hi_i) * active[:, i]
    return lam

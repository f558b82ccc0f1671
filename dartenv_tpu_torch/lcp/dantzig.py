"""Pivoting boxed-LCP solver: block principal pivoting (Dantzig-class),
batch-first.

  repeat (fixed budget):
    1. x on the clamped sets takes its bound; the free set F solves
       A_FF x_F = -(b_F + A_F,clamped x_clamped)   (masked dense solve)
    2. w = A x + b; move rows between sets:
       F rows outside [lo, hi] -> clamped; clamped rows with in-pointing
       w -> F
    3. friction bounds refresh from the current normal impulses

`dantzig_solve` is the plain formulation (masked SPD solve through
math/linalg.solve_psd).  `make_exact_solver` is what the escalation stage
calls: a float32 CUDA batch goes to the hand-written block-pivoting kernel
(lcp/hopper_bpp.py), anything else to that kernel's plain version.
The double-float and mixed-precision refinement tiers (`refine_compensated`,
`refine_mixed`) are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from dartenv_tpu_torch.lcp.pgs import findex_tensors, pgs_solve
from dartenv_tpu_torch.math.linalg import solve_psd

# set labels
_FREE = 0
_AT_LO = 1
_AT_HI = 2


def dantzig_solve(A, b, lo, hi, findex, mu, active, iters: int = 24,
                  polish_iters: int = 10, lam0=None, refine_iters=None):
    """Solve a batch of boxed LCPs by block principal pivoting.

    A: (B, m, m) SPD(+cfm); b, lo, hi, mu, active: (B, m); findex: static
    numpy (m,) with -1 for plain rows.  `lam0` (B, m) warm-starts the pivot
    sets.  findex bounds are refreshed from a DAMPED impulse source (the
    undamped map oscillates on sliding contacts), followed by a few
    undamped refinement pivots and a PGS polish.  Returns lam (B, m).
    """
    m = A.shape[-1]
    dtype, device = A.dtype, A.device
    if m == 0:
        return torch.zeros_like(b)
    fidx, has_f = findex_tensors(findex, device)
    has_f = has_f.to(dtype)
    eye = torch.eye(m, dtype=dtype, device=device)
    big = 1e20
    zero = torch.zeros_like(b)

    def bounds(x):
        # |x[fidx]|: a transiently negative normal impulse must not invert
        # the friction box
        fb = mu * torch.abs(x[:, fidx]) * has_f + big * (1.0 - has_f)
        lo_i = torch.maximum(lo, -fb)
        hi_i = torch.minimum(hi, fb)
        return lo_i * active, hi_i * active      # inactive rows: [0, 0]

    def body(x, xb, state):
        lo_i, hi_i = bounds(xb)
        free = (state == _FREE) & (active > 0.5)
        fmask = free.to(dtype)
        x_fixed = torch.where(state == _AT_LO, lo_i,
                              torch.where(state == _AT_HI, hi_i, zero))
        x_fixed = x_fixed * active * (1.0 - fmask)
        Axf = torch.sum(A * x_fixed[:, None, :], dim=-1)
        rhs = -(b + Axf) * fmask
        Am = (A * fmask[:, :, None] * fmask[:, None, :]
              + eye * (1.0 - fmask)[:, None, :])
        x_free = solve_psd(Am, rhs, eps=1e-12) * fmask
        x_new = x_free + x_fixed
        w = torch.sum(A * x_new[:, None, :], dim=-1) + b
        state = torch.where(free & (x_new < lo_i - 1e-10),
                            torch.full_like(state, _AT_LO), state)
        state = torch.where(free & (x_new > hi_i + 1e-10),
                            torch.full_like(state, _AT_HI), state)
        state = torch.where((state == _AT_LO) & (w < -1e-10),
                            torch.full_like(state, _FREE), state)
        state = torch.where((state == _AT_HI) & (w > 1e-10),
                            torch.full_like(state, _FREE), state)
        x_new = torch.minimum(torch.maximum(x_new, lo_i), hi_i)
        return x_new, state

    if lam0 is None:
        # cold start: every row clamped at lo, violated normals free
        x = torch.zeros_like(b)
        state = torch.where((lo == 0.0) & (b < 0.0), _FREE, _AT_LO).to(
            torch.int32)
    else:
        lo_w, hi_w = bounds(lam0)
        x = torch.minimum(torch.maximum(lam0, lo_w), hi_w)
        at_lo = x <= lo_w + 1e-12
        at_hi = x >= hi_w - 1e-12
        state = torch.where(
            at_hi, _AT_HI, torch.where(at_lo, _AT_LO, _FREE)).to(torch.int32)
        w0 = torch.sum(A * x[:, None, :], dim=-1) + b
        state = torch.where((state == _AT_LO) & (w0 < 0.0),
                            torch.full_like(state, _FREE), state)
        state = torch.where((state == _AT_HI) & (w0 > 0.0),
                            torch.full_like(state, _FREE), state)
    xb = x
    for _ in range(iters):
        x, state = body(x, xb, state)
        xb = 0.5 * (xb + x)
    n_refine = max(iters // 3, 6) if refine_iters is None else refine_iters
    for _ in range(n_refine):
        x, state = body(x, x, state)
    if polish_iters > 0:
        x = pgs_solve(A, b, lo, hi, findex, mu, active, iters=polish_iters,
                      lam0=x)
    return x


def make_exact_solver(findex, iters: int = 24, polish_iters: int = 10,
                      refine_iters=None):
    """Exact boxed-LCP solver of a batch: solve(A, b, lo, hi, mu, active,
    lam0) -> lam.  A float32 CUDA batch runs the block-pivoting kernel; a
    CPU or float64 batch runs the kernel's plain version."""
    from dartenv_tpu_torch.engine.hopper_substep import use_kernel
    from dartenv_tpu_torch.lcp.hopper_bpp import (
        bpp_solve, bpp_solve_reference,
    )

    findex = np.asarray(findex)

    def solve(A, b, lo, hi, mu, active, lam0):
        fn = bpp_solve if use_kernel(A) else bpp_solve_reference
        return fn(A, b, lo, hi, findex, mu, active, iters=iters,
                  polish_iters=polish_iters, lam0=lam0,
                  refine_iters=refine_iters)

    return solve

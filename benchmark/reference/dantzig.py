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
calls, and what the solver="dantzig" mode runs over the whole batch
(engine/constraints.run_lcp_solver): a float32 CUDA batch goes to the
hand-written block-pivoting kernel (lcp/hopper_bpp.py, its core mode),
anything else to that kernel's plain version.
`refine_compensated` is the escalation's double-float refinement tier and
`refine_mixed` its mixed-precision (float64 residual) tier: the plain
versions of the escalation kernel's two refinement builds
(csrc/escalate_body.h es_refine, es_refine64).
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.pgs import findex_tensors, pgs_solve
from benchmark.reference.linalg import seq_mv, solve_psd

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
    lam0) -> lam, the block-pivoting solve as plain tensor code."""
    from benchmark.reference import bpp

    findex = np.asarray(findex)

    def solve(A, b, lo, hi, mu, active, lam0):
        return bpp.bpp_solve_reference(A, b, lo, hi, findex, mu, active,
                                       iters=iters,
                                       polish_iters=polish_iters, lam0=lam0,
                                       refine_iters=refine_iters)

    return solve


# ---------------------------------------------------------------------------
# double-float (compensated f32) residual refinement
# ---------------------------------------------------------------------------

_SPLIT_F32 = 4097.0        # 2^12 + 1: Dekker split, 24-bit mantissa
_SPLIT_F64 = 134217729.0   # 2^27 + 1: Dekker split, 53-bit mantissa


def _two_sum(a, b):
    """Knuth two-sum: s + e == a + b exactly (s = fl(a + b))."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _two_prod(a, b):
    """Dekker two-prod: p + e == a * b exactly (p = fl(a * b)), from
    mantissa splitting; the identity needs every operation rounded on its
    own (no fused multiply-add), which separate tensor ops are."""
    split = _SPLIT_F64 if a.dtype == torch.float64 else _SPLIT_F32
    p = a * b
    ca = split * a
    ah = ca - (ca - a)
    al = a - ah
    cb = split * b
    bh = cb - (cb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _comp_matvec_add(A, x, b):
    """fl2(b + A @ x) with compensated row sums: each product enters as an
    exact (p, e) pair and the running sum carries a Neumaier correction, so
    the result is the real-arithmetic value of the inputs rounded about
    once.  A: (..., m, m); x, b: (..., m).  Columns in order."""
    m = A.shape[-1]
    s = torch.broadcast_to(b, A.shape[:-1]).to(A.dtype)
    c = torch.zeros_like(s)
    # every product's exact pair at once (elementwise: the same numbers)
    p, pe = _two_prod(A, x[..., None, :].expand(A.shape))
    for j in range(m):
        s, se = _two_sum(s, p[..., :, j])
        c = c + (se + pe[..., :, j])
    return s + c


def comp_residual_ff(A, b, x, lo, hi, findex, mu, active):
    """lcp/hybrid.comp_residual with w = A x + b from `_comp_matvec_add`:
    the residual is a cancellation, and the plain float32 sum floors at
    ~eps32 ||A|| ||x||, so it misjudges refined points below ~1e-6."""
    fidx, has_f = findex_tensors(findex, x.device)
    has_f = has_f.to(x.dtype)
    bd = mu * torch.abs(x[..., fidx]) * has_f + 1e20 * (1 - has_f)
    lo_e = torch.maximum(lo, -bd)
    hi_e = torch.minimum(hi, bd)
    w = _comp_matvec_add(A, x, b)
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


def refine_compensated(A, b, lo, hi, findex, mu, active, x,
                       passes: int = 2):
    """Refinement of a boxed-LCP point at its own friction-bound fixed
    sets with a double-float residual, in the working precision: per pass,
    the free set of x, the compensated residual of the free-set system, a
    correction solve on the masked operator (math/linalg.solve_psd), a
    clip to the bounds; a pass's point is kept only where its compensated
    residual (`comp_residual_ff`) is lower than the best so far (a wrong
    partition diverges; it never worsens the point).  A: (K, m, m),
    vectors (K, m).  The correction solve sums in the escalation
    kernel's order (math/linalg.solve_psd with seq), as the plain version
    of its refinement tier.  Returns the best point (K, m)."""
    fidx, has_f = findex_tensors(findex, x.device)
    dtype = A.dtype
    has_f = has_f.to(dtype)
    eye = torch.eye(A.shape[-1], dtype=dtype, device=A.device)
    actb = active > 0.5
    zero = torch.zeros_like(x)

    def resid(xx):
        return comp_residual_ff(A, b, xx, lo, hi, findex, mu, active)

    best_x = x
    best_r = resid(x)
    for _ in range(passes):
        bd = mu * torch.abs(x[..., fidx]) * has_f + 1e20 * (1.0 - has_f)
        lo_e = torch.maximum(lo, -bd) * active
        hi_e = torch.minimum(hi, bd) * active
        scale = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True),
                            min=1.0)
        eps = 1e-6 * scale
        at_lo = x <= lo_e + eps
        at_hi = x >= hi_e - eps
        fm = (actb & ~at_lo & ~at_hi).to(dtype)
        x_fix = torch.where(at_hi, hi_e, torch.where(at_lo, lo_e, zero)) \
            * active * (1 - fm)
        xa = x * fm + x_fix
        r = -_comp_matvec_add(A, xa, b) * fm
        Am = (A * fm[..., :, None] * fm[..., None, :]
              + eye * (1.0 - fm)[..., None, :])
        d = solve_psd(Am, r, eps=1e-12, seq=True) * fm
        x = torch.minimum(torch.maximum(xa + d, lo_e), hi_e)
        r_new = resid(x)
        better = r_new < best_r
        best_x = torch.where(better[..., None], x, best_x)
        best_r = torch.minimum(r_new, best_r)
    return best_x


def refine_mixed(A, b, lo, hi, findex, mu, active, x, passes: int = 2):
    """Mixed-precision iterative refinement of a boxed-LCP point at its own
    friction-bound fixed sets: float64 RESIDUAL, working-precision
    correction SOLVE.  Per pass: the free set of the float64 iterate at its
    own friction bounds, the residual -(b + A x) of the free-set system in
    float64, the correction solved on the SAME masked operator in A's
    dtype (math/linalg.solve_psd), a clip to the bounds in float64; the
    iterate rounded to A's dtype is kept only where its float64 residual
    (lcp/hybrid.comp_residual) is lower than the best so far — the caller
    only ever sees the rounded point.  A: (K, m, m), vectors (K, m).  Every
    sum runs in the escalation kernel's order (math/linalg.seq_mv: the
    columns in order from 0, then + b); this is the plain version of its
    ES_REF64 build.  Returns the best point (K, m) in A's dtype."""
    from benchmark.reference.hybrid import comp_residual

    f64 = torch.float64
    dtype = A.dtype
    fidx, has_f = findex_tensors(findex, x.device)
    has_f = has_f.to(f64)
    A64, b64, lo64, hi64, mu64, act64 = (
        t.to(f64) for t in (A, b, lo, hi, mu, active))
    actb = act64 > 0.5
    x64 = x.to(f64)
    eye = torch.eye(A.shape[-1], dtype=dtype, device=A.device)
    zero = torch.zeros_like(x64)

    def resid(xx):
        return comp_residual(A64, b64, xx, lo64, hi64, findex, mu64, act64,
                             seq=True)

    best_x = x64
    best_r = resid(x64)
    for _ in range(passes):
        bd = mu64 * torch.abs(x64[..., fidx]) * has_f + 1e20 * (1.0 - has_f)
        lo_e = torch.maximum(lo64, -bd) * act64
        hi_e = torch.minimum(hi64, bd) * act64
        scale = torch.clamp(torch.amax(torch.abs(x64), dim=-1, keepdim=True),
                            min=1.0)
        eps = 1e-6 * scale
        at_lo = x64 <= lo_e + eps
        at_hi = x64 >= hi_e - eps
        fm = (actb & ~at_lo & ~at_hi).to(f64)
        x_fix = torch.where(at_hi, hi_e, torch.where(at_lo, lo_e, zero)) \
            * act64 * (1 - fm)
        xa = x64 * fm + x_fix
        r = -(b64 + seq_mv(A64, xa)) * fm
        fmw = fm.to(dtype)
        Am = (A * fmw[..., :, None] * fmw[..., None, :]
              + eye * (1.0 - fmw)[..., None, :])
        d = solve_psd(Am, r.to(dtype), eps=1e-12, seq=True) * fmw
        x64 = torch.minimum(torch.maximum(xa + d.to(f64), lo_e), hi_e)
        cand = x64.to(dtype).to(f64)
        r_new = resid(cand)
        better = r_new < best_r
        best_x = torch.where(better[..., None], cand, best_x)
        best_r = torch.minimum(r_new, best_r)
    return best_x.to(dtype)

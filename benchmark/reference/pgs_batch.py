"""PGS with its normalized residual, plain PyTorch: a frozen copy of the
program's plain version (lcp/hopper_pgs.py)."""


from __future__ import annotations

from benchmark.reference.hybrid import comp_residual
from benchmark.reference.pgs import pgs_solve


def pgs_solve_reference(A, b, lo, hi, findex, mu, active, iters: int = 30,
                        omega: float = 1.0, lam0=None,
                        return_residual: bool = False):
    """Plain PyTorch version of the kernel: lcp/pgs.pgs_solve, plus
    lcp/hybrid.comp_residual of its result when `return_residual`.
    A: (B, m, m); b, lo, hi, mu, active, lam0: (B, m); findex: static
    numpy (m,).  Returns lam (B, m), or (lam, res (B,))."""
    lam = pgs_solve(A, b, lo, hi, findex, mu, active, iters=iters,
                    lam0=lam0, omega=omega)
    if not return_residual:
        return lam
    return lam, comp_residual(A, b, lam, lo, hi, findex, mu, active)


def pgs_solve_batch(A, b, lo, hi, findex, mu, active, iters: int = 30,
                    omega: float = 1.0, lam0=None,
                    return_residual: bool = False):
    """The solvers' entry: always the plain version."""
    return pgs_solve_reference(A, b, lo, hi, findex, mu, active, iters=iters,
                               omega=omega, lam0=lam0,
                               return_residual=return_residual)

"""Small dense linear algebra, unrolled for static tiny sizes.

Same policies as the JAX package's math/linalg.py so the two stay
numerically comparable: Cholesky unrolled over the static size for
n <= _UNROLL_MAX with the `sqrt(max(s, 1e-30))` guard, explicit
Schur-complement inverse above it, products as mul+reduce.
"""
from __future__ import annotations

import torch

_UNROLL_MAX = 12


def _eye(n, ref):
    return torch.eye(n, dtype=ref.dtype, device=ref.device)


def chol(A, eps: float = 0.0):
    """Cholesky factor L (lower) of SPD A (..., n, n); `eps` is added to
    the diagonal.  Small n: unrolled elementwise ops over the batch; large
    n: torch.linalg.cholesky with the same relative f32 jitter as the JAX
    package's blocked branch."""
    n = A.shape[-1]
    if n > _UNROLL_MAX:
        rel = 1e-6 if A.dtype == torch.float32 else 0.0
        scale = torch.mean(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1)
        return torch.linalg.cholesky(
            A + (eps + rel * scale)[..., None, None] * _eye(n, A))
    rows = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            if j == i:
                s = s + eps
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            if i == j:
                rows[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                rows[i][j] = s / rows[j][j]
    zero = torch.zeros_like(A[..., 0, 0])
    full = [
        torch.stack([rows[i][j] if j <= i else zero for j in range(n)],
                    dim=-1)
        for i in range(n)
    ]
    return torch.stack(full, dim=-2)


def chol_solve(L, b):
    """Solve (L L^T) x = b; L: (..., n, n) lower, b: (..., n) or
    (..., n, m).  Unrolled substitution for n <= _UNROLL_MAX."""
    n = L.shape[-1]
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    if n > _UNROLL_MAX:
        y = torch.linalg.solve_triangular(L, b, upper=False)
        x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
        return x[..., 0] if vec else x
    y = [None] * n
    for i in range(n):
        s = b[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * y[k]
        y[i] = s / L[..., i, i, None]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i, None] * x[k]
        x[i] = s / L[..., i, i, None]
    out = torch.stack(x, dim=-2)
    return out[..., 0] if vec else out


def _tri_inv_unrolled(L):
    """Inverse of lower-triangular L (..., n, n), n <= _UNROLL_MAX."""
    n = L.shape[-1]
    X = [[None] * n for _ in range(n)]
    for j in range(n):
        for i in range(j, n):
            if i == j:
                X[i][j] = 1.0 / L[..., i, i]
            else:
                s = L[..., i, j] * X[j][j]
                for k in range(j + 1, i):
                    s = s + L[..., i, k] * X[k][j]
                X[i][j] = -s / L[..., i, i]
    zero = torch.zeros_like(L[..., 0, 0])
    rows = [
        torch.stack([X[i][j] if j <= i else zero for j in range(n)], dim=-1)
        for i in range(n)
    ]
    return torch.stack(rows, dim=-2)


def _pmm(a, b):
    """Batched matmul as mul+reduce (full-precision sums in the working
    dtype, whatever the matmul settings)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _inv_psd_rec(A):
    n = A.shape[-1]
    if n <= _UNROLL_MAX:
        Li = _tri_inv_unrolled(chol(A))
        return _pmm(Li.transpose(-1, -2), Li)
    k = (n + 1) // 2
    A11 = A[..., :k, :k]
    A12 = A[..., :k, k:]
    A22 = A[..., k:, k:]
    i11 = _inv_psd_rec(A11)
    U = _pmm(i11, A12)
    S = A22 - _pmm(A12.transpose(-1, -2), U)
    i22 = _inv_psd_rec(S)
    B12 = -_pmm(U, i22)
    B11 = i11 - _pmm(B12, U.transpose(-1, -2))
    top = torch.cat([B11, B12], dim=-1)
    bot = torch.cat([B12.transpose(-1, -2), i22], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inv_psd(A, eps: float = 0.0):
    """Explicit inverse of SPD A (..., n, n): unrolled Cholesky + unrolled
    triangular inverse for n <= _UNROLL_MAX, recursive 2x2 Schur-complement
    block inversion above.  In f32 a relative diagonal jitter guards
    PSD-ness."""
    n = A.shape[-1]
    if eps or A.dtype == torch.float32:
        rel = 1e-6 if A.dtype == torch.float32 else 0.0
        scale = torch.mean(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1)
        A = A + (eps + rel * scale)[..., None, None] * _eye(n, A)
    return _inv_psd_rec(A)


def solve_psd(A, b, eps: float = 0.0):
    """Solve A x = b for SPD A: unrolled Cholesky + substitution for small
    n, explicit `inv_psd` + product above _UNROLL_MAX."""
    n = A.shape[-1]
    if n > _UNROLL_MAX:
        Ainv = inv_psd(A, eps=eps)
        vec = b.ndim == A.ndim - 1
        if vec:
            return torch.sum(Ainv * b[..., None, :], dim=-1)
        return _pmm(Ainv, b)
    return chol_solve(chol(A, eps=eps), b)

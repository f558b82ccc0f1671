"""Batched exact boxed-LCP solve by block principal pivoting: the CUDA
kernel's wrapper and its plain PyTorch version.

`bpp_solve` launches csrc/bpp.cu (one warp per env, A in shared memory) on
a float32 CUDA batch; on a CPU tensor it runs `bpp_solve_reference`, the
same algorithm as plain batched tensor code (any dtype, any device).  On a
CUDA tensor the wrapper launches the kernel or raises — it never falls
back.  `LAUNCHES` counts kernel launches and nothing else.

Iteration structure (shared with lcp/dantzig.dantzig_solve): warm
partition from lam0, `iters` damped pivots, `refine_iters` undamped pivots
(default max(iters // 3, 6)), `polish_iters` PGS sweeps.  Each pivot's
masked SPD solve is unpivoted Gaussian elimination — the operator is SPD +
cfm on the free block and exactly 1 on masked diagonal entries.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from dartenv_tpu_torch import cuda_build
from dartenv_tpu_torch.lcp.pgs import findex_tensors

_FREE, _AT_LO, _AT_HI = 0, 1, 2

LAUNCHES = 0          # kernel launches (bpp_solve on a CUDA batch)
_LIB = None
_FINDEX_CACHE = {}


def start_build():
    """Start compiling the kernel (returns a cuda_build.Build)."""
    return cuda_build.start_build("dartenv_bpp", "bpp.cu")


def load(build=None):
    """Compile (if needed) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.finish_build(build or start_build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.bpp_solve_launch.argtypes = [vp] * 9 + [ci] * 5 + [vp]
        lib.bpp_solve_launch.restype = ci
        _LIB = lib
    return _LIB


def _refine_count(iters, refine_iters):
    return max(iters // 3, 6) if refine_iters is None else int(refine_iters)


def _gauss_solve(Am, r):
    """Solve Am x = r per problem by unpivoted Gaussian elimination
    (rows below the pivot only) + back substitution.  Am: (B, m, m),
    r: (B, m)."""
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


def bpp_solve_reference(A, b, lo, hi, findex, mu, active, iters: int = 24,
                        polish_iters: int = 10, lam0=None,
                        refine_iters=None):
    """Plain PyTorch version of the kernel.  A: (B, m, m); b, lo, hi, mu,
    active, lam0: (B, m); findex: static numpy (m,).  Returns lam (B, m)."""
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
        Axf = torch.sum(A * x_fixed[:, None, :], dim=-1)
        rhs = -(b + Axf) * fmask
        Am = (A * fmask[:, :, None] * fmask[:, None, :]
              + eye * (1.0 - fmask)[:, None, :])
        x_new = _gauss_solve(Am, rhs) * fmask + x_fixed
        w = torch.sum(A * x_new[:, None, :], dim=-1) + b
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
    w0 = torch.sum(A * x[:, None, :], dim=-1) + b
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
            w_i = torch.sum(A[:, i, :] * lam, dim=-1) + b[:, i]
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


def _findex_tensor(findex: np.ndarray, device) -> torch.Tensor:
    key = (findex.tobytes(), str(device))
    if key not in _FINDEX_CACHE:
        _FINDEX_CACHE[key] = torch.as_tensor(
            findex.astype(np.int32), device=device)
    return _FINDEX_CACHE[key]


def bpp_solve(A, b, lo, hi, findex, mu, active, iters: int = 24,
              polish_iters: int = 10, lam0=None, refine_iters=None):
    """Batched exact boxed-LCP solve; same contract as
    bpp_solve_reference.  CUDA float32 -> the kernel; CPU -> the plain
    version; anything else on a CUDA device raises."""
    global LAUNCHES
    if not A.is_cuda:
        return bpp_solve_reference(A, b, lo, hi, findex, mu, active,
                                   iters=iters, polish_iters=polish_iters,
                                   lam0=lam0, refine_iters=refine_iters)
    B, m = b.shape
    if A.dtype != torch.float32:
        raise TypeError(f"the BPP kernel takes float32, got {A.dtype}")
    if A.shape != (B, m, m):
        raise ValueError(f"A has shape {tuple(A.shape)}, expected "
                         f"{(B, m, m)}")
    if m == 0 or B == 0:
        return torch.zeros((B, m), dtype=A.dtype, device=A.device)
    if lam0 is None:
        lam0 = torch.zeros_like(b)
    vecs = [b, lo, hi, mu, active, lam0]
    for v in vecs:
        if v.shape != (B, m) or v.dtype != A.dtype or v.device != A.device:
            raise ValueError("BPP kernel operands must be (B, m) float32 "
                             "tensors on A's device")
    lib = load()
    A = A.contiguous()
    vecs = [v.contiguous() for v in vecs]
    fidx = _findex_tensor(np.asarray(findex), A.device)
    lam = torch.empty_like(vecs[0])
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.bpp_solve_launch(
            A.data_ptr(), *[v.data_ptr() for v in vecs], fidx.data_ptr(),
            lam.data_ptr(), B, m, int(iters),
            _refine_count(iters, refine_iters), int(polish_iters), stream)
    cuda_build.check_launch(code, "bpp_solve")
    LAUNCHES += 1
    return lam

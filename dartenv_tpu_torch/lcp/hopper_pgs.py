"""Batched projected Gauss-Seidel with the fused residual: the CUDA
kernel's wrapper and its plain PyTorch version.

`pgs_solve_cuda` launches csrc/pgs.cu (one warp per env, the sweeps of
csrc/pgs_row.h: each lane's rows of lam in registers, A in shared
memory) on a float32 CUDA batch; on a CPU tensor it runs
`pgs_solve_reference`; any other CUDA tensor raises.  `pgs_solve_host`
runs the kernel's per-env arithmetic built with the host compiler
(csrc/pgs_host.cpp), for tests without a GPU.  `pgs_solve_batch` is
the dispatch the solvers of lcp/pgs.py and lcp/hybrid.py call: the kernel
for a float32 CUDA batch, the plain version (counted in `PLAIN_CALLS`) for
anything else.  `PGS_LAUNCHES` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from dartenv_tpu_torch import cuda_build
from dartenv_tpu_torch.lcp.hybrid import comp_residual
from dartenv_tpu_torch.lcp.pgs import findex_i32, pgs_solve

PGS_LAUNCHES = 0      # kernel launches (pgs_solve_cuda on a CUDA batch)
PLAIN_CALLS = 0       # plain-version runs through pgs_solve_batch
MAX_ROWS = 256        # rows the kernel serves (32 lanes x 8 slots)
_LIB = None
_HOST_LIB = None


def start_build():
    """Start compiling the kernel (returns a cuda_build.Build)."""
    return cuda_build.start_build("dartenv_pgs", "pgs.cu",
                                  deps=("pgs_row.h",))


def _check(A, b, vecs):
    """(B, m) of a batch the kernel takes; raises on anything else."""
    B, m = b.shape
    if A.dtype != torch.float32:
        raise TypeError(f"the PGS kernel takes float32, got {A.dtype}")
    if A.shape != (B, m, m):
        raise ValueError(f"A has shape {tuple(A.shape)}, expected "
                         f"{(B, m, m)}")
    if m > MAX_ROWS:
        raise ValueError(f"the PGS kernel serves m <= {MAX_ROWS}, got {m}")
    for v in vecs:
        if v.shape != (B, m) or v.dtype != A.dtype or v.device != A.device:
            raise ValueError("PGS kernel operands must be (B, m) float32 "
                             "tensors on A's device")
    return B, m


def bind(lib):
    """Set the ctypes signature of a loaded build's launch function."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pgs_solve_launch.argtypes = ([vp] * 10 + [ci] * 3
                                     + [ctypes.c_float, vp])
    lib.pgs_solve_launch.restype = ci
    return lib


def load(build=None):
    """Compile (if needed) and load the kernel library."""
    global _LIB
    if _LIB is None:
        _LIB = bind(cuda_build.finish_build(build or start_build()))
    return _LIB


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


def pgs_solve_cuda(A, b, lo, hi, findex, mu, active, iters: int = 30,
                   omega: float = 1.0, lam0=None,
                   return_residual: bool = False):
    """Batched PGS; same contract as pgs_solve_reference.  CUDA float32 ->
    the kernel; CPU -> the plain version; anything else raises."""
    global PGS_LAUNCHES
    if not A.is_cuda:
        return pgs_solve_reference(A, b, lo, hi, findex, mu, active,
                                   iters=iters, omega=omega, lam0=lam0,
                                   return_residual=return_residual)
    if lam0 is None:
        lam0 = torch.zeros_like(b)
    vecs = [b, lo, hi, mu, active, lam0]
    B, m = _check(A, b, vecs)
    if m == 0 or B == 0:
        lam = torch.zeros_like(b)
        return (lam, b.new_zeros((B,))) if return_residual else lam
    lam = torch.empty_like(b)
    res = (torch.empty((B,), dtype=A.dtype, device=A.device)
           if return_residual else None)
    lib = load()
    A = A.contiguous()
    vecs = [v.contiguous() for v in vecs]
    fidx = findex_i32(findex, A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pgs_solve_launch(
            A.data_ptr(), *[v.data_ptr() for v in vecs], fidx.data_ptr(),
            lam.data_ptr(), None if res is None else res.data_ptr(),
            B, m, int(iters), float(omega), stream)
    cuda_build.check_launch(code, "pgs_solve")
    PGS_LAUNCHES += 1
    return (lam, res) if return_residual else lam


def pgs_solve_host(A, b, lo, hi, findex, mu, active, iters: int = 30,
                   omega: float = 1.0, lam0=None,
                   return_residual: bool = False):
    """The PGS kernel's per-env arithmetic (the sweeps and the fused
    residual of csrc/pgs_row.h) built with the host C++ compiler and run
    on float32 CPU tensors, one env at a time.  For tests on machines
    without a GPU: nothing on the main path calls it, and it is not a
    stand-in for the kernel."""
    global _HOST_LIB
    if _HOST_LIB is None:
        lib = cuda_build.build_host("dartenv_pgs_host", "pgs_host.cpp",
                                    deps=("pgs_row.h",))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pgs_host.argtypes = [vp] * 10 + [ci] * 3 + [ctypes.c_float]
        lib.pgs_host.restype = ci
        _HOST_LIB = lib
    if A.is_cuda:
        raise ValueError("pgs_solve_host takes CPU tensors")
    if lam0 is None:
        lam0 = torch.zeros_like(b)
    vecs = [v.contiguous() for v in (b, lo, hi, mu, active, lam0)]
    B, m = _check(A, b, vecs)
    lam = torch.zeros_like(b)
    res = torch.zeros((B,), dtype=A.dtype)
    fidx = findex_i32(findex, A.device)
    A = A.contiguous()
    _HOST_LIB.pgs_host(A.data_ptr(),
                       *[v.data_ptr() for v in vecs], fidx.data_ptr(),
                       lam.data_ptr(),
                       res.data_ptr() if return_residual else None,
                       B, m, int(iters), float(omega))
    return (lam, res) if return_residual else lam


def pgs_solve_batch(A, b, lo, hi, findex, mu, active, iters: int = 30,
                    omega: float = 1.0, lam0=None,
                    return_residual: bool = False):
    """The solvers' dispatch: a float32 CUDA batch runs the kernel; a CPU
    or float64 batch runs the plain version."""
    global PLAIN_CALLS
    kw = dict(iters=iters, omega=omega, lam0=lam0,
              return_residual=return_residual)
    if cuda_build.use_kernel(A):
        return pgs_solve_cuda(A, b, lo, hi, findex, mu, active, **kw)
    PLAIN_CALLS += 1
    return pgs_solve_reference(A, b, lo, hi, findex, mu, active, **kw)

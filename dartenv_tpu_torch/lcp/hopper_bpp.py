"""Batched exact boxed-LCP solve by block principal pivoting, and the
escalation stage around it: the CUDA kernel's wrappers and the solve's
plain PyTorch version.

csrc/bpp.cu runs one warp per env and is built once per row count m <= 64
(a generated header, `header`): up to 32 rows with row i of the problem in
lane i, above that with the lanes over the rows of a working matrix in
shared memory (csrc/bpp_body.h); a CUDA batch with m > 64 raises
NotImplementedError naming m.  Its three modes, each a wrapper here:

  * `bpp_solve` (core mode): (B, m, m) A and the vectors -> lam.  On a CPU
    tensor it runs `bpp_solve_reference`, the same algorithm as plain
    batched tensor code (any dtype, any device).
  * `bpp_fused`: the substep path's escalation stage
    (engine/hopper_substep.escalate_batch) in one launch: it reads its
    envs' rows of the substep kernel's packed `esc`, rebuilds the
    operator, solves warm (and cold), runs the digest's refinement tier
    when it asks for one, keeps the best by residual and patches copies of
    dq_plus and lam_full.  Its build carries the substep
    digest (engine/hopper_substep.escalation_header).
  * `bpp_hybrid`: the phase-wise hybrid solver's escalation
    (lcp/hybrid.make_hybrid_solver) in one launch: rows idx of the batch's
    LCPs, the same tiers and keep-best, a refinement tier when its build
    asks for one (one build per (m, tier, passes): `header`), lam rows
    patched in a copy.

`bpp_fused` and `bpp_hybrid` take float32 CUDA tensors only (their plain
versions are the torch compositions in hopper_substep and hybrid, which
their callers run for any other batch).  On a CUDA tensor every wrapper
launches the kernel or raises — none falls back.  `CORE_LAUNCHES`,
`FUSED_LAUNCHES` and `HYBRID_LAUNCHES` count each mode's launches and
nothing else.

The escalation's tier policy has one source, `tier_budgets`: the fused and
hybrid modes take its tuple as their launch arguments (its last two
entries, the passes of the compensated and of the mixed-precision
refinement tier, at most one of them non-zero, are also in the fused and
hybrid builds' headers and must agree with them), and `tier_solvers`
builds the plain compositions' exact solvers from the same tuple.

The two refinement tiers: ES_REFC, the compensated (double-float) tier
(lcp/dantzig.refine_compensated), and ES_REF64, the mixed-precision tier
(lcp/dantzig.refine_mixed: float64 residuals on the card's float64 units,
float32 correction solves).  The mixed-precision tier wins where both are
asked for, as in the reference; unlike the reference, whose tier is inert
without a float64 switch, it always runs when asked.

Iteration structure (shared with lcp/dantzig.dantzig_solve): warm
partition from lam0, `iters` damped pivots, `refine_iters` undamped pivots
(default max(iters // 3, 6)), `polish_iters` PGS sweeps.  Each pivot's
masked SPD solve is unpivoted Gaussian elimination — the operator is SPD +
cfm on the free block and exactly 1 on masked diagonal entries.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from dartenv_tpu_torch import cuda_build
from dartenv_tpu_torch.lcp.pgs import findex_i32, findex_tensors
from dartenv_tpu_torch.math.linalg import seq_mv

_FREE, _AT_LO, _AT_HI = 0, 1, 2

CORE_LAUNCHES = 0     # launches of the core mode (bpp_solve)
FUSED_LAUNCHES = 0    # launches of the fused mode (bpp_fused)
HYBRID_LAUNCHES = 0   # launches of the hybrid mode (bpp_hybrid)
PLAIN_CALLS = 0       # plain-version runs through lcp/dantzig.make_exact_solver
MAX_ROWS = 64         # one warp per env: one or two rows per lane
TIER_POLISH = (3, 6)  # PGS polish sweeps after tier 1 (warm), tier 2 (cold)
_DEPS = ("bpp_body.h", "escalate_body.h", "linalg_body.h", "pgs_row.h")
_LIBS: Dict[str, ctypes.CDLL] = {}
# fused header -> (n, m_c, m, width, compensated passes, float64 passes)
_FUSED_DIMS: Dict[str, tuple] = {}


def check_rows(m: int):
    """Refuse a problem the kernel cannot hold (before any CUDA call)."""
    if m > MAX_ROWS:
        raise NotImplementedError(
            f"the BPP kernel holds at most two LCP rows per lane of a warp "
            f"and takes m <= {MAX_ROWS} rows; this problem has m = {m}")


def header(m: int, ref_passes: int = 0, ref64_passes: int = 0) -> str:
    """The generated header of the core and hybrid modes' build for m rows;
    ref64_passes > 0: the hybrid mode runs that many passes of the
    mixed-precision refinement tier (ES_REF64) after its exact tiers, else
    ref_passes > 0: that many of the compensated tier (ES_REFC)."""
    text = f"#define ES_M {int(m)}\n"
    if ref64_passes > 0:
        text += f"#define ES_REF64 {int(ref64_passes)}\n"
    elif ref_passes > 0:
        text += f"#define ES_REFC {int(ref_passes)}\n"
    return text


def start_build(m: int = 24, header_text=None):
    """Start compiling the kernel for m rows (or for a fused header from
    engine/hopper_substep.escalation_header); returns a cuda_build.Build."""
    check_rows(m)
    return cuda_build.start_build(
        "dartenv_bpp", "bpp.cu", header_text=header_text or header(m),
        header_name="bpp_model.h", deps=_DEPS)


def load(m: int = 24, build=None, header_text=None):
    """Compile (if needed) and load the kernel library for m rows (or for
    a fused header)."""
    text = header_text or header(m)
    if text not in _LIBS:
        lib = cuda_build.finish_build(build or start_build(m, text))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bpp_core_launch.argtypes = [vp] * 9 + [ci] * 4 + [vp]
        lib.bpp_hybrid_launch.argtypes = ([vp] * 13 + [ci, cf] + [ci] * 6
                                          + [vp])
        fns = [lib.bpp_core_launch, lib.bpp_hybrid_launch,
               lib.bpp_ref_passes, lib.bpp_ref64_passes]
        if "ES_N" in text:
            lib.bpp_fused_launch.argtypes = ([vp] * 10 + [ci, cf] + [ci] * 6
                                             + [vp])
            lib.bpp_fused_smem_bytes.restype = ci
            fns.append(lib.bpp_fused_launch)
        for fn in fns:
            fn.restype = ci
        if lib.bpp_rows() != m:
            raise RuntimeError(f"BPP kernel built for {lib.bpp_rows()} "
                               f"rows, asked for {m}")
        if "ES_N" in text:
            lib.bpp_fused_dims.argtypes = [vp]
            dims = (ctypes.c_int * 6)()
            lib.bpp_fused_dims(dims)
            _FUSED_DIMS[text] = tuple(dims)
        _LIBS[text] = lib
    return _LIBS[text]


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
    from dartenv_tpu_torch.lcp.dantzig import make_exact_solver

    def make(iters, refine, polish):
        solve = make_exact_solver(findex, iters=iters, polish_iters=polish,
                                  refine_iters=refine)
        solve.budget = (iters, refine, polish)
        return solve

    exact2 = make(*budgets[3:6]) if budgets[3] > 0 else None
    return make(*budgets[:3]), exact2


def solver_budgets(exact1, exact2=None, ref_passes: int = 0,
                   ref64_passes: int = 0):
    """The `tier_budgets` tuple of solvers made by `tier_solvers` and the
    refinement passes of the two tiers; a solver made otherwise has no
    budget the kernel could run and is refused."""
    for s in (exact1, exact2):
        if s is not None and not hasattr(s, "budget"):
            raise TypeError(
                "the escalation kernel runs the tiers of solvers made by "
                f"hopper_bpp.tier_solvers; {s!r} carries no budget")
    return tuple(exact1.budget) + (
        (0, 0, 0) if exact2 is None else tuple(exact2.budget)) + ref_tiers(
        ref_passes, ref64_passes)


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


def lane_sum(p):
    """p (..., m) summed over its last axis in the order of the kernel's
    polish rows (csrc/pgs_row.h row_dot): lane l's partial over
    j = l, l + 32, ... in order, then the 32 partials added in the tree of
    the xor butterfly (16, 8, 4, 2, 1)."""
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


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check_cuda(what, tensors, shapes, dtype=torch.float32):
    dev = tensors[0][1].device
    for (name, x), shape in zip(tensors, shapes):
        if (not x.is_cuda or x.dtype != dtype or tuple(x.shape) != shape
                or x.device != dev):
            raise ValueError(
                f"{what}: {name} must be a {dtype} CUDA tensor of shape "
                f"{shape} on {dev}, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")


def bpp_solve(A, b, lo, hi, findex, mu, active, iters: int = 24,
              polish_iters: int = 10, lam0=None, refine_iters=None):
    """Batched exact boxed-LCP solve; same contract as
    bpp_solve_reference.  CUDA float32 -> the kernel (core mode); CPU ->
    the plain version; anything else on a CUDA device raises."""
    global CORE_LAUNCHES
    if not A.is_cuda:
        return bpp_solve_reference(A, b, lo, hi, findex, mu, active,
                                   iters=iters, polish_iters=polish_iters,
                                   lam0=lam0, refine_iters=refine_iters)
    B, m = b.shape
    check_rows(m)
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
    lib = load(m)
    A = A.contiguous()
    vecs = [v.contiguous() for v in vecs]
    fidx = findex_i32(findex, A.device)
    lam = torch.empty_like(vecs[0])
    with torch.cuda.device(A.device):
        code = lib.bpp_core_launch(
            A.data_ptr(), *[v.data_ptr() for v in vecs], fidx.data_ptr(),
            lam.data_ptr(), B, int(iters),
            _refine_count(iters, refine_iters), int(polish_iters), _stream())
    cuda_build.check_launch(code, "bpp_solve")
    CORE_LAUNCHES += 1
    return lam


def bpp_hybrid(A, b, lo, hi, mu, active, lam, idx, worst, findex,
               tol: float, budgets):
    """The hybrid solver's escalation in one launch (float32 CUDA only).

    A: (B, m, m); b, lo, hi, mu, active, lam (the PGS impulses): (B, m);
    idx (K,) int64 and worst (K,): the top K of the PGS residuals;
    budgets: `tier_budgets(...)`.  Tier 1 re-solves rows idx warm from
    lam[idx], tier 2 cold, keep-best against worst and tol, then
    budgets[6] passes of the compensated refinement tier, or budgets[7] of
    the mixed-precision one, on the kept point (a build of `header(m,
    budgets[6], budgets[7])`), kept by the same rule.  Returns
    (lam with rows idx patched, a copy; take (K,) bool; residual of the
    kept point (K,))."""
    global HYBRID_LAUNCHES
    B, m = b.shape
    K = idx.shape[0]
    check_rows(m)
    _check_cuda("bpp_hybrid",
                [("A", A), ("b", b), ("lo", lo), ("hi", hi), ("mu", mu),
                 ("active", active), ("lam", lam), ("worst", worst)],
                [(B, m, m)] + [(B, m)] * 6 + [(K,)])
    _check_cuda("bpp_hybrid", [("idx", idx)], [(K,)], dtype=torch.int64)
    out = lam.clone()
    take = torch.zeros((K,), dtype=torch.int32, device=lam.device)
    res = torch.empty((K,), dtype=lam.dtype, device=lam.device)
    if K == 0 or m == 0:
        return out, take.bool(), worst.clone()
    lib = load(m, header_text=header(m, *budgets[6:8]))
    built = (lib.bpp_ref_passes(), lib.bpp_ref64_passes())
    if built != tuple(budgets[6:8]):
        raise ValueError(f"bpp_hybrid: refinement passes {budgets[6:8]} "
                         f"asked, the build runs {built}")
    ins = [x.contiguous() for x in (A, b, lo, hi, mu, active, lam, idx,
                                    worst)]
    fidx = findex_i32(findex, A.device)
    with torch.cuda.device(A.device):
        code = lib.bpp_hybrid_launch(
            *[x.data_ptr() for x in ins], fidx.data_ptr(), out.data_ptr(),
            take.data_ptr(), res.data_ptr(), K, float(tol), *budgets[:6],
            _stream())
    cuda_build.check_launch(code, "bpp_hybrid")
    HYBRID_LAUNCHES += 1
    return out, take.bool(), res


def bpp_fused(header_text: str, dims, esc, dq_plus, lam_full, idx, worst,
              findex, tol: float, budgets):
    """The substep path's escalation stage in one launch (float32 CUDA
    only).

    header_text: engine/hopper_substep.escalation_header of the digest;
    dims: (n, m_c, m, esc width, compensated and float64 refinement
    passes); esc (B, width),
    dq_plus (B, n), lam_full
    (B, m): the substep's outputs; idx (K,) int64 and worst (K,): the top K
    of its residuals.  Returns (dq_plus and lam_full with the taken rows
    patched, copies; take (K,) bool; residual of the kept point (K,))."""
    global FUSED_LAUNCHES
    n, m_c, m, width = dims[:4]
    B, K = esc.shape[0], idx.shape[0]
    check_rows(m_c)
    if tuple(budgets[6:8]) != tuple(dims[4:6]):
        raise ValueError(f"bpp_fused: refinement passes {budgets[6:8]} "
                         f"asked, the digest's build runs {dims[4:6]}")
    _check_cuda("bpp_fused",
                [("esc", esc), ("dq_plus", dq_plus), ("lam_full", lam_full),
                 ("worst", worst)],
                [(B, width), (B, n), (B, m), (K,)])
    _check_cuda("bpp_fused", [("idx", idx)], [(K,)], dtype=torch.int64)
    dqp, lamf = dq_plus.clone(), lam_full.clone()
    take = torch.zeros((K,), dtype=torch.int32, device=esc.device)
    res = torch.empty((K,), dtype=esc.dtype, device=esc.device)
    if K == 0 or m_c == 0:
        return dqp, lamf, take.bool(), worst.clone()
    lib = load(m_c, header_text=header_text)
    if _FUSED_DIMS[header_text] != tuple(dims):
        raise ValueError(f"bpp_fused: dims {tuple(dims)} do not match the "
                         f"build's {_FUSED_DIMS[header_text]}")
    ins = [x.contiguous() for x in (esc, dq_plus, lam_full, idx, worst)]
    fidx = findex_i32(findex, esc.device)
    with torch.cuda.device(esc.device):
        code = lib.bpp_fused_launch(
            *[x.data_ptr() for x in ins], fidx.data_ptr(), dqp.data_ptr(),
            lamf.data_ptr(), take.data_ptr(), res.data_ptr(), K, float(tol),
            *budgets[:6], _stream())
    cuda_build.check_launch(code, "bpp_fused")
    FUSED_LAUNCHES += 1
    return dqp, lamf, take.bool(), res


def fused_host(header_text: str, dims, findex, esc_rows, dq_rows, lamf_rows,
               worst, lam1, lam2, tol: float):
    """The fused mode's per-env arithmetic outside the solves
    (csrc/escalate_body.h: operator rebuild, residuals, keep-best, the
    compensated refinement tier when the digest asks for it, delta
    patches) built with the host C++ compiler and run on float32 CPU rows
    of the K escalated envs, with the tiers' impulses lam1, lam2 (None: no
    tier 2) handed in.  For tests on machines without a GPU.  Returns a
    dict: A (K, m_c, m_c), MinvJt (K, n, m_c), res (K, 3: tier 1, tier 2,
    the kept point), take (K,) bool, dq_plus, lam_full (the rows,
    patched)."""
    n, m_c, m = dims[:3]
    lib = cuda_build.build_host(
        "dartenv_escalate_host", "escalate_host.cpp",
        header_text=header_text, header_name="bpp_model.h", deps=_DEPS)
    vp = ctypes.c_void_p
    lib.escalate_host.argtypes = [vp] * 7 + [ctypes.c_float] + [vp] * 6 + [
        ctypes.c_int]
    f32 = lambda x: x.to(torch.float32).contiguous()
    ins = [f32(x) for x in (esc_rows, dq_rows, lamf_rows, worst, lam1)]
    l2 = None if lam2 is None else f32(lam2)
    K = ins[0].shape[0]
    fidx = torch.as_tensor(np.asarray(findex, dtype=np.int32))
    out = dict(A=torch.zeros((K, m_c, m_c)), MiJ=torch.zeros((K, m_c, n)),
               res=torch.zeros((K, 3)),
               take=torch.zeros((K,), dtype=torch.int32),
               dq_plus=torch.zeros((K, n)), lam_full=torch.zeros((K, m)))
    lib.escalate_host(*[x.data_ptr() for x in ins],
                      None if l2 is None else l2.data_ptr(),
                      fidx.data_ptr(), float(tol),
                      *[out[k].data_ptr() for k in ("A", "MiJ", "res", "take",
                                                    "dq_plus", "lam_full")],
                      K)
    out["MinvJt"] = out.pop("MiJ").transpose(1, 2)
    out["take"] = out["take"].bool()
    return out


def core_host(A, b, lo, hi, findex, mu, active, iters: int = 24,
              polish_iters: int = 10, lam0=None, refine_iters=None):
    """The core mode's solve above 32 rows (csrc/bpp_body.h, the lanes over
    rows) built with the host C++ compiler and run as one lane on float32
    CPU tensors; same contract as bpp_solve_reference.  For tests on
    machines without a GPU."""
    B, m = b.shape
    lib = cuda_build.build_host(
        "dartenv_bpp_host", "bpp_host.cpp", header_text=header(m),
        header_name="bpp_model.h", deps=_DEPS)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bpp_core_host.argtypes = [vp] * 9 + [ci] * 4
    f32 = lambda x: x.to(torch.float32).contiguous()
    if lam0 is None:
        lam0 = torch.zeros_like(b)
    ins = [f32(x) for x in (A, b, lo, hi, mu, active, lam0)]
    fidx = torch.as_tensor(np.asarray(findex, dtype=np.int32))
    lam = torch.zeros((B, m), dtype=torch.float32)
    lib.bpp_core_host(*[x.data_ptr() for x in ins], fidx.data_ptr(),
                      lam.data_ptr(), B, int(iters),
                      _refine_count(iters, refine_iters), int(polish_iters))
    return lam


def refine_host(A, b, lo, hi, findex, mu, active, x, passes: int):
    """The compensated refinement tier's arithmetic (csrc/escalate_body.h
    es_refine, es_residual_ff) built with the host C++ compiler and run as
    one lane on float32 CPU tensors: (the refined points (K, m), the
    compensated residual of the input points (K,), of the refined ones
    (K,)).  For tests on machines without a GPU."""
    B, m = b.shape
    lib = cuda_build.build_host(
        "dartenv_bpp_host", "bpp_host.cpp", header_text=header(m),
        header_name="bpp_model.h", deps=_DEPS)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.refine_host.argtypes = [vp] * 8 + [ci] + [vp] * 2 + [ci]
    f32 = lambda t: t.to(torch.float32).contiguous()
    ins = [f32(t) for t in (A, b, lo, hi, mu, active, x)]
    fidx = torch.as_tensor(np.asarray(findex, dtype=np.int32))
    out = torch.zeros((B, m), dtype=torch.float32)
    res = torch.zeros((B, 2), dtype=torch.float32)
    lib.refine_host(*[t.data_ptr() for t in ins], fidx.data_ptr(),
                    int(passes), out.data_ptr(), res.data_ptr(), B)
    return out, res[:, 0], res[:, 1]


def refine64_host(A, b, lo, hi, findex, mu, active, x, passes: int):
    """The mixed-precision refinement tier's arithmetic (csrc/escalate_body.h
    es_refine64, es_residual64) built with the host C++ compiler and run as
    one lane on float32 CPU tensors: (the refined points (K, m) float32, the
    float64 residual of the input points (K,), of the refined ones (K,)).
    For tests on machines without a GPU."""
    B, m = b.shape
    lib = cuda_build.build_host(
        "dartenv_bpp_host", "bpp_host.cpp", header_text=header(m),
        header_name="bpp_model.h", deps=_DEPS)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.refine64_host.argtypes = [vp] * 8 + [ci] + [vp] * 2 + [ci]
    f32 = lambda t: t.to(torch.float32).contiguous()
    ins = [f32(t) for t in (A, b, lo, hi, mu, active, x)]
    fidx = torch.as_tensor(np.asarray(findex, dtype=np.int32))
    out = torch.zeros((B, m), dtype=torch.float32)
    res = torch.zeros((B, 2), dtype=torch.float64)
    lib.refine64_host(*[t.data_ptr() for t in ins], fidx.data_ptr(),
                      int(passes), out.data_ptr(), res.data_ptr(), B)
    return out, res[:, 0], res[:, 1]


def hybrid_host(A, b, lo, hi, findex, mu, active, lam, worst, tol: float,
                budgets):
    """The hybrid mode's per-env work above 32 rows (csrc/bpp_body.h
    bp_tiers, then the refinement tier of budgets[6:8], csrc/escalate_body.h
    es_refine_tier) built with the host C++ compiler and run as one lane
    on float32 CPU tensors of K gathered problems, with their PGS
    impulses lam and residuals worst.  Returns (the kept points (K, m),
    take (K,) bool, the kept point's residual (K,)), as keep_best of
    lcp/hybrid returns them.  For tests on machines without a GPU."""
    K, m = b.shape
    lib = cuda_build.build_host(
        "dartenv_bpp_host", "bpp_host.cpp",
        header_text=header(m, *budgets[6:8]), header_name="bpp_model.h",
        deps=_DEPS)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hybrid_host.argtypes = ([vp] * 9 + [ctypes.c_float] + [ci] * 6
                                + [vp] * 3 + [ci])
    f32 = lambda t: t.to(torch.float32).contiguous()
    ins = [f32(t) for t in (A, b, lo, hi, mu, active, lam, worst)]
    fidx = torch.as_tensor(np.asarray(findex, dtype=np.int32))
    out = torch.zeros((K, m), dtype=torch.float32)
    take = torch.zeros((K,), dtype=torch.int32)
    res = torch.zeros((K,), dtype=torch.float32)
    lib.hybrid_host(*[t.data_ptr() for t in ins], fidx.data_ptr(),
                    float(tol), *[int(v) for v in budgets[:6]],
                    out.data_ptr(), take.data_ptr(), res.data_ptr(), K)
    return out, take.bool(), res

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit): HBM bandwidth and the float32 rate outside the
tensor cores; and the least time of a launch's work against them."""
import math

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def least_ms(bytes_, flops):
    """(ms, "bytes" | "operations"): the larger of the bytes over the peak
    bandwidth and the operations over the peak rate."""
    tb = bytes_ / PEAK_BYTES_PER_S * 1e3
    tf = flops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def escalation_size(batch, frac, kmax):
    """K = min(B, kmax, ceil(frac * B)): the envs the escalation
    re-solves in one substep."""
    return min(batch, int(kmax), max(1, math.ceil(frac * batch)))


def solve_flops(m, iters, refine, polish):
    """Operations of one block-pivoting solve of m rows: each pivot's
    elimination and back substitution, the masked operator, two matvecs;
    the polish sweeps; the final residual's matvec."""
    pivot = (2 * m ** 3) // 3 + 2 * m * m + 6 * m * m
    return (iters + refine) * pivot + polish * 2 * m * m + 2 * m * m


def escalate_flops(m, budgets, rebuild_n=0):
    """Operations of one env's escalation at the tier budgets (iters1,
    refine1, polish1, iters2, refine2, polish2, compensated passes,
    float64 passes): the tiers' solves and residuals, the refinement
    passes (float64 operations counted twice), and in the fused mode the
    operator rebuild from M (n x n) and Jc (m x n)."""
    it1, rf1, po1, it2, rf2, po2, passes, passes64 = budgets
    n = rebuild_n
    flops = solve_flops(m, it1, rf1, po1) + 2 * m * m
    if it2 > 0:
        flops += solve_flops(m, it2, rf2, po2) + 2 * m * m
    flops += passes * (m ** 3 + 44 * m * m) + 22 * m * m + 2 * m * m
    flops += passes64 * (m ** 3 + 10 * m * m) + (4 * m * m if passes64
                                                  else 0)
    if n:
        flops += n ** 3 // 3 + 2 * m * n * n + 2 * m * m * n
    return flops

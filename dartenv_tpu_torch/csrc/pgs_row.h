// Lane helpers and the projected Gauss-Seidel row update shared by the PGS
// kernel (pgs.cu), the fused substep kernel (substep_body.h), the
// escalation stage (escalate_body.h) and their host builds.
//
// Device code runs one warp per env: `LANE_FOR(i, lo, hi)` spreads the
// items of a loop over the 32 lanes (the caller has `lane` in scope) and
// `LANE_SYNC()` is __syncwarp().  A host build runs the same code as ONE
// lane that takes every item in order, so the per-item arithmetic is the
// same; the reductions across lanes have host forms that give the device's
// result to the bit (a max is exact in any order; the butterfly sum of
// `row_dot` is replayed in its tree order).
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define LN_FN __device__ __forceinline__
#define LANE_FOR(i, lo, hi) for (int i = (lo) + lane; i < (hi); i += 32)
#define LANE_SYNC() __syncwarp()
#else
#define LN_FN static inline
#define LANE_FOR(i, lo, hi) for (int i = (lo); i < (hi); ++i)
#define LANE_SYNC() ((void)0)
#endif

// Max of every lane's partial max (exact in any order; on the host the one
// lane already holds it).  Every lane receives the result.
LN_FN float lanes_max(float v) {
#ifdef __CUDACC__
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
#endif
    return v;
}

// sum_j a[j] x[j] over j < m: lane l sums j = l, l + 32, ... in order, then
// a __shfl_xor_sync butterfly adds the 32 partials (16, 8, 4, 2, 1), which
// leaves the same sum in every lane.  The host form adds the same partials
// in the same tree.
LN_FN float row_dot(const float* a, const float* x, int m, int lane) {
#ifdef __CUDACC__
    float part = 0.0f;
    for (int j = lane; j < m; j += 32) part += a[j] * x[j];
    for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
    return part;
#else
    (void)lane;
    float p[32];
    for (int l = 0; l < 32; ++l) {
        p[l] = 0.0f;
        for (int j = l; j < m; j += 32) p[l] += a[j] * x[j];
    }
    for (int o = 16; o > 0; o >>= 1)
        for (int l = 0; l < o; ++l) p[l] += p[l + o];
    return p[0];
#endif
}

// SOR inverse diagonal of lcp/pgs.pgs_solve: (1 / max(d, 1e-12)) * omega
// where d > 1e-12, else 0.
LN_FN float pgs_inv_diag(float d, float omega) {
    return (d > 1e-12f) ? (1.0f / fmaxf(d, 1e-12f)) * omega : 0.0f;
}

// Row i of one Gauss-Seidel sweep (lcp/pgs.pgs_solve):
//   w_i = A_i . lam + b_i;  new = lam_i - w_i inv_d_i;
//   bounds [lo_i, hi_i], narrowed to [-mu_i lam_f, mu_i lam_f] when
//   f >= 0 (no abs: the plain version's bound);  lam_i = clip(new) act_i.
// Every lane computes the same value; lane 0 writes it after all lanes
// have read lam.
LN_FN void pgs_row(const float* Ai, float* lam, int m, int i, float b,
                   float invd, float lo, float hi, float mu, float act,
                   int f, int lane) {
    const float w = row_dot(Ai, lam, m, lane) + b;
    const float nw = lam[i] - w * invd;
    float l = lo, h = hi;
    if (f >= 0) {
        const float bound = mu * lam[f];
        l = fmaxf(l, -bound);
        h = fminf(h, bound);
    }
    const float v = fminf(fmaxf(nw, l), h) * act;
    LANE_SYNC();             // every lane has read lam before ...
    if (lane == 0) lam[i] = v;
    LANE_SYNC();             // ... the new lam_i is visible to all
}

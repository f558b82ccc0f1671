// Lane helpers and the projected Gauss-Seidel sweeps shared by the PGS
// kernel (pgs.cu), the fused substep kernel (substep_body.h), the
// escalation stage (escalate_body.h) and their host builds (pgs_host.cpp,
// substep_host.cpp, escalate_host.cpp).
//
// Device code runs one warp per env: `LANE_FOR(i, lo, hi)` spreads the
// items of a loop over the 32 lanes (the caller has `lane` in scope) and
// `LANE_SYNC()` is __syncwarp().  A host build runs the same code as ONE
// lane that takes every item in order, so the per-item arithmetic is the
// same; the reductions across lanes have host forms that give the device's
// result to the bit (a max is exact in any order; a row sum's butterfly
// is replayed in its tree order by `row_dot`; a shuffle reads the one
// lane's own register).
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

#ifndef __CUDACC__
// The card's row sum sum_j a[j] x[j] over j < m (pg_row_dot) replayed by
// one lane: lane l's partial over j = l, l + 32, ... in order, then the
// 32 partials added in the tree of the xor butterfly (16, 8, 4, 2, 1).
static inline float row_dot(const float* a, const float* x, int m) {
    float p[32];
    for (int l = 0; l < 32; ++l) {
        p[l] = 0.0f;
        for (int j = l; j < m; j += 32) p[l] += a[j] * x[j];
    }
    for (int o = 16; o > 0; o >>= 1)
        for (int l = 0; l < o; ++l) p[l] += p[l + o];
    return p[0];
}
#endif

// SOR inverse diagonal of lcp/pgs.pgs_solve: (1 / max(d, 1e-12)) * omega
// where d > 1e-12, else 0.
LN_FN float pgs_inv_diag(float d, float omega) {
    return (d > 1e-12f) ? (1.0f / fmaxf(d, 1e-12f)) * omega : 0.0f;
}

// ---- the sweeps with the impulses in registers ----------------------------
// Rows go round the lanes: lane l holds rows j = l, l + PG_LANES, ... in
// the R slots of a PgLane: lam_j and the row's b, bounds, mu, act and SOR
// inverse diagonal.  Row i's w_i = A_i . lam + b_i is summed afresh in
// row_dot's order (lane l's partial over its own lam_j, j = l, l + 32,
// ..., then the xor butterfly 16, 8, 4, 2, 1), the order of the plain
// version's row sums on the card, so the impulses and residuals follow it
// to the bit there; only the owner of row i (lane i % 32) keeps its clip,
// in its register, where the next row's partials read it; lam_f of a
// friction row comes from its owner by one shuffle.  No __syncwarp and no
// shared-memory round trip on the chain.  A is read by rows (row-major).
// (A column form that keeps w = A lam + b per lane and updates it by A's
// columns has no reduction on the chain, but its impulses drift from the
// plain version's by rounding: the fused substep kernel's escalation then
// failed its check against its plain version on the card, and the PGS
// kernel's residuals left the JAX package's bound on some envs; PERF.md.)
// The host build runs one lane that holds every row (PG_LANES = 1), in
// the same order, with row_dot's host form.
#ifdef __CUDACC__
#define PG_LANES 32
#else
#define PG_LANES 1
#endif

template <int R>
struct PgLane {
    float lam[R];
    float b[R], lo[R], hi[R], mu[R], act[R], invd[R];
};

// v of lane `src` (every lane passes its own v).
LN_FN float pg_bcast(float v, int src) {
#ifdef __CUDACC__
    return __shfl_sync(0xffffffffu, v, src);
#else
    (void)src;
    return v;
#endif
}

// a[k] for a k that is the same in every lane (a select over the slots,
// so the register array is never indexed at run time on the card).
template <int R>
LN_FN float pg_slot(const float (&a)[R], int k) {
#ifdef __CUDACC__
    float v = a[0];
#pragma unroll
    for (int r = 1; r < R; ++r)
        if (r == k) v = a[r];
    return v;
#else
    return a[k];
#endif
}

// lam_f of row f, for an f that may differ between lanes (f >= 0).
template <int R>
LN_FN float pg_gather(const float (&lam)[R], int f) {
#ifdef __CUDACC__
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float t = __shfl_sync(0xffffffffu, lam[r], f % 32);
        if (r == f / 32) v = t;
    }
    return v;
#else
    return lam[f];
#endif
}

// The owner's update of row i (slot rb) from w_i (lcp/pgs.pgs_solve):
//   new = lam_i - w_i inv_d_i;  bounds [lo_i, hi_i], narrowed to
//   [-mu_i lam_f, mu_i lam_f] when f = findex[i] >= 0 (no abs: the plain
//   version's bound);  lam_i = clip(new) act_i.  Returns the new lam_i
//   (meaningful in the owner lane only).
template <int R>
LN_FN float pg_update(const PgLane<R>& s, int rb, float w, int f) {
    float l = s.lo[rb], h = s.hi[rb];
    if (f >= 0) {
        const float lf = pg_bcast(pg_slot(s.lam, f / PG_LANES),
                                  f % PG_LANES);
        const float bound = s.mu[rb] * lf;
        l = fmaxf(l, -bound);
        h = fminf(h, bound);
    }
    const float nw = s.lam[rb] - w * s.invd[rb];
    return fminf(fmaxf(nw, l), h) * s.act[rb];
}

// A_i . lam in row_dot's order; every lane receives it.
template <int R>
LN_FN float pg_row_dot(const PgLane<R>& s, const float* Ai, int m,
                       int lane) {
#ifdef __CUDACC__
    float p = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r)
        if (lane + 32 * r < m) p += Ai[lane + 32 * r] * s.lam[r];
    for (int o = 16; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
    return p;
#else
    (void)lane;
    return row_dot(Ai, s.lam, m);
#endif
}

// One sweep of the ROW form over rows 0..m-1 in order; A row-major with
// row stride lda.
template <int R>
LN_FN void pg_row_sweep(PgLane<R>& s, const float* A, int lda, int m,
                        const int* findex, int lane) {
#pragma unroll
    for (int rb = 0; rb < R; ++rb) {
#pragma unroll 1
        for (int ii = 0; ii < PG_LANES; ++ii) {
            const int i = rb * PG_LANES + ii;
            if (i >= m) break;
            const float w = pg_row_dot(s, A + i * lda, m, lane) + s.b[rb];
            const float v = pg_update(s, rb, w, findex[i]);
            if (lane == ii) s.lam[rb] = v;
        }
    }
}

// The normalized complementarity residual of lcp/hybrid.comp_residual at
// the lanes' lam (friction bound from |lam_f|, eps = 1e-6 scale + 1e-9,
// active rows only), lanes over rows, each row's w in row_dot's order
// (the lane replays the butterfly on its own partials); every lane
// returns it.
template <int R>
LN_FN float pg_row_residual(const PgLane<R>& s, const float* A, int lda,
                            int m, const int* findex, int lane) {
    float amax = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r)
        if (lane + r * PG_LANES < m) amax = fmaxf(amax, fabsf(s.lam[r]));
    const float scale = fmaxf(1.0f, lanes_max(amax));
    const float eps = 1e-6f * scale + 1e-9f;
    float res = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int j = lane + r * PG_LANES;
        const int f = j < m ? findex[j] : -1;
        const float lf = pg_gather(s.lam, f < 0 ? 0 : f);
        const float* Aj = A + (j < m ? j : 0) * lda;
#ifdef __CUDACC__
        float p[32];
#pragma unroll
        for (int l = 0; l < 32; ++l) p[l] = 0.0f;
#pragma unroll
        for (int kb = 0; kb < R; ++kb)
#pragma unroll
            for (int l = 0; l < 32; ++l) {
                const float lk = __shfl_sync(0xffffffffu, s.lam[kb], l);
                if (l + 32 * kb < m) p[l] += Aj[l + 32 * kb] * lk;
            }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int l = 0; l < o; ++l) p[l] += p[l + o];
        const float w = p[0] + s.b[r];
#else
        const float w = row_dot(Aj, s.lam, m) + s.b[r];
#endif
        if (j >= m) continue;
        float l, h;
        if (f >= 0) {
            const float bound = s.mu[r] * fabsf(lf);
            l = fmaxf(s.lo[r], -bound);
            h = fminf(s.hi[r], bound);
        } else {
            l = fmaxf(s.lo[r], -1e20f);
            h = fminf(s.hi[r], 1e20f);
        }
        const float x = s.lam[r];
        const bool at_lo = x <= l + eps;
        const bool at_hi = x >= h - eps;
        float rr = (at_lo && at_hi) ? 0.0f
                   : (at_lo ? -w : (at_hi ? w : fabsf(w)));
        rr = fmaxf(rr, fmaxf(l - x, x - h));
        if (s.act[r] > 0.5f) res = fmaxf(res, rr);
    }
    return lanes_max(res) / scale;
}

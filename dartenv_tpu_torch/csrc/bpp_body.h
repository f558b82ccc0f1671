// The boxed-LCP block-principal-pivoting solve of one env with the lanes
// over ROWS and the working matrix in shared memory: the escalation
// kernel's body for ES_M > 32 rows (bpp.cu; up to 32 rows it keeps one row
// per lane in registers), and the host build's (bpp_host.cpp,
// escalate_host.cpp), which runs it as one lane.
//
// The arithmetic of every entry, and its order, is the register body's and
// the plain version's (lcp/hopper_bpp.bpp_solve_reference): warm
// partition from x0 -> `iters` damped pivots (bound source xb = (xb + x)/2)
// -> `refine` undamped pivots -> `polish` PGS sweeps.  A pivot builds the
// masked operator Am = A f f^T + diag(1 - f) and the rhs
// -(b + A x_fixed) f, eliminates below each pivot in turn (unpivoted
// Gaussian elimination, lanes over the rows below it), substitutes back
// (lanes over the rows above each x_i), and moves rows between the sets;
// matvecs sum over columns in order; a polish row sums in row_dot's order
// (pgs_row.h: lane partials, then the xor butterfly).
//
// Why shared memory above 32 rows: the register body holds an m-wide row
// per lane, and at two rows per lane that is 2 m registers of matrix
// alone (82 at m = 41, 128 at m = 64) beside the vectors; the working
// matrix here is ES_M x ES_LD floats of the block's shared memory (one
// warp per block), read by rows with an odd stride.
#pragma once

#include "escalate_body.h"

#define BP_FREE 0
#define BP_LO 1
#define BP_HI 2

// scratch floats of bp_solve: Am (ES_M x ES_LD), then r, l, h, xf, fm,
// xb, xn, st (int) of ES_M each
constexpr int bp_solve_scratch() { return ES_M * ES_LD + 8 * ES_M; }

// A_i . v over columns in order, plus bi
ES_FN float bp_matvec(const float* Ai, const float* v, float bi) {
    float acc = 0.0f;
    for (int j = 0; j < ES_M; ++j) acc += Ai[j] * v[j];
    return acc + bi;
}

// The bounds of row i with friction source src (findex row f: mu |src_f|;
// plain rows capped at +-1e20).
ES_FN void bp_bounds(const float* vec, const int* fidx, const float* src,
                     int i, float& l, float& h) {
    const float *lo = vec + ES_M, *hi = vec + 2 * ES_M, *mu = vec + 3 * ES_M;
    const int f = fidx[i];
    l = lo[i];
    h = hi[i];
    if (f >= 0) {
        const float fb = mu[i] * fabsf(src[f]);
        l = fmaxf(l, -fb);
        h = fminf(h, fb);
    } else {
        l = fmaxf(l, -1e20f);
        h = fminf(h, 1e20f);
    }
}

// A_i . x in row_dot's order (every lane returns it)
ES_FN float bp_row_dot(const float* Ai, const float* x, int lane) {
#ifdef __CUDACC__
    float p = 0.0f;
    for (int j = lane; j < ES_M; j += 32) p += Ai[j] * x[j];
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    return p;
#else
    (void)lane;
    return row_dot(Ai, x, ES_M);
#endif
}

// The solve of one env: A (ES_M x ES_LD), vec (b lo hi mu act, ES_M each)
// and fidx in shared memory, x0 the warm start (ES_M floats, may alias x);
// writes the solution to x.  Ends with the warp synchronized.
ES_FN void bp_solve(const float* A, const float* vec, const int* fidx,
                    const float* x0, float* x, float* scr, int iters,
                    int refine, int polish, int lane) {
    const float* b = vec;
    const float* act = vec + 4 * ES_M;
    float* Am = scr;
    float* r = Am + ES_M * ES_LD;
    float* l = r + ES_M;
    float* h = l + ES_M;
    float* xf = h + ES_M;
    float* fm = xf + ES_M;
    float* xb = fm + ES_M;
    float* xn = xb + ES_M;
    int* st = (int*)(xn + ES_M);

    // ---- initial partition from the warm start -------------------------
    LANE_FOR(i, 0, ES_M) xb[i] = x0[i];
    LANE_SYNC();
    LANE_FOR(i, 0, ES_M) {
        float li, hi_;
        bp_bounds(vec, fidx, xb, i, li, hi_);
        const float xi = fminf(fmaxf(xb[i], li), hi_);
        xn[i] = xi;
        st[i] = (xi >= hi_ - 1e-12f) ? BP_HI
                : ((xi <= li + 1e-12f) ? BP_LO : BP_FREE);
    }
    LANE_SYNC();
    LANE_FOR(i, 0, ES_M) {
        const float w = bp_matvec(A + i * ES_LD, xn, b[i]);
        if (st[i] == BP_LO && w < 0.0f) st[i] = BP_FREE;
        if (st[i] == BP_HI && w > 0.0f) st[i] = BP_FREE;
    }
    LANE_SYNC();
    LANE_FOR(i, 0, ES_M) {
        x[i] = xn[i];
        xb[i] = xn[i];
    }
    LANE_SYNC();

    // ---- damped pivots, then undamped refinement -----------------------
    for (int it = 0; it < iters + refine; ++it) {
        const bool damped = it < iters;
        if (!damped) {
            LANE_FOR(i, 0, ES_M) xb[i] = x[i];
            LANE_SYNC();
        }
        LANE_FOR(i, 0, ES_M) {
            float li, hi_;
            bp_bounds(vec, fidx, xb, i, li, hi_);
            l[i] = li;
            h[i] = hi_;
            const float f = (st[i] == BP_FREE && act[i] > 0.5f) ? 1.0f : 0.0f;
            float v = (st[i] == BP_LO) ? li : ((st[i] == BP_HI) ? hi_ : 0.0f);
            xf[i] = v * act[i] * (1.0f - f);
            fm[i] = f;
        }
        LANE_SYNC();
        LANE_FOR(i, 0, ES_M) {
            const float* Ai = A + i * ES_LD;
            r[i] = -bp_matvec(Ai, xf, b[i]) * fm[i];
            for (int j = 0; j < ES_M; ++j) {
                float v = Ai[j] * fm[i] * fm[j];
                if (j == i) v += 1.0f - fm[j];
                Am[i * ES_LD + j] = v;
            }
        }
        LANE_SYNC();
        // forward elimination, rows below the pivot over the lanes
        for (int k = 0; k < ES_M - 1; ++k) {
            const float piv = Am[k * ES_LD + k];
            const float rk = r[k];
            LANE_FOR(i, k + 1, ES_M) {
                float* Ri = Am + i * ES_LD;
                const float fk = Ri[k] / piv;
                for (int j = k + 1; j < ES_M; ++j)
                    Ri[j] -= fk * Am[k * ES_LD + j];
                r[i] -= fk * rk;
            }
            LANE_SYNC();
        }
        // back substitution, column oriented (xn holds x_free)
        for (int i = ES_M - 1; i >= 0; --i) {
            const float xi = r[i] / Am[i * ES_LD + i];
            LANE_FOR(j, 0, i) r[j] -= Am[j * ES_LD + i] * xi;
            if (lane == 0) xn[i] = xi;
            LANE_SYNC();
        }
        LANE_FOR(i, 0, ES_M) xn[i] = xn[i] * fm[i] + xf[i];
        LANE_SYNC();
        LANE_FOR(i, 0, ES_M) {
            const float w = bp_matvec(A + i * ES_LD, xn, b[i]);
            const bool fr = fm[i] > 0.5f;
            int s = st[i];
            if (fr && xn[i] < l[i] - 1e-12f) s = BP_LO;
            if (fr && xn[i] > h[i] + 1e-12f) s = BP_HI;
            if (s == BP_LO && w < -1e-10f) s = BP_FREE;
            if (s == BP_HI && w > 1e-10f) s = BP_FREE;
            st[i] = s;
            x[i] = fminf(fmaxf(xn[i], l[i]), h[i]);
            if (damped) xb[i] = 0.5f * (xb[i] + x[i]);
        }
        LANE_SYNC();
    }

    // ---- PGS polish ----------------------------------------------------
    if (polish <= 0) {
        LANE_FOR(i, 0, ES_M) x[i] = x[i] * act[i];
        LANE_SYNC();
        return;
    }
    const float *lo = vec + ES_M, *hi = vec + 2 * ES_M, *mu = vec + 3 * ES_M;
    for (int sw = 0; sw < polish; ++sw) {
        for (int i = 0; i < ES_M; ++i) {
            const float* Ai = A + i * ES_LD;
            const float w_i = bp_row_dot(Ai, x, lane) + b[i];
            if (lane == 0) {
                const float d = Ai[i];
                const float invd = (d > 1e-12f) ? 1.0f / fmaxf(d, 1e-12f)
                                                : 0.0f;
                const float nw = x[i] - w_i * invd;
                float lo_i = lo[i], hi_i = hi[i];
                // plain rows keep their own bounds here (no +-1e20 cap)
                const int f = fidx[i];
                if (f >= 0) {
                    const float fb = mu[i] * fabsf(x[f]);
                    lo_i = fmaxf(lo[i], -fb);
                    hi_i = fminf(hi[i], fb);
                }
                x[i] = fminf(fmaxf(nw, lo_i), hi_i) * act[i];
            }
            LANE_SYNC();
        }
    }
}

// scratch floats of bp_tiers: the tier-2 point, then bp_solve's
constexpr int bp_tiers_scratch() { return ES_M + bp_solve_scratch(); }

// Tier 1 warm from lam (ES_M floats in shared memory), tier 2 cold when
// iters2 > 0, each ranked by es_residual and kept by es_take against
// `worst`, as the register body's tiers() does; lam is overwritten by the
// kept point.  take / kept are the same in every lane.
ES_FN void bp_tiers(const float* A, const float* vec, const int* fidx,
                    float* lam, float* scr, float worst, float tol,
                    int iters1, int refine1, int polish1, int iters2,
                    int refine2, int polish2, bool& take, float& kept,
                    int lane) {
    const float* b = vec;
    float* x2 = scr;
    float* sscr = scr + ES_M;
    float* x1 = x2;                 // tier 1's point, until tier 2 runs
    bp_solve(A, vec, fidx, lam, x1, sscr, iters1, refine1, polish1, lane);
    const float r1 = es_residual(A, b, b + ES_M, b + 2 * ES_M, b + 3 * ES_M,
                                 b + 4 * ES_M, x1, fidx, lane);
    take = es_take(worst, r1, tol);
    kept = take ? r1 : worst;
    if (take) LANE_FOR(i, 0, ES_M) lam[i] = x1[i];
    LANE_SYNC();
    if (iters2 > 0) {
        LANE_FOR(i, 0, ES_M) x2[i] = 0.0f;
        LANE_SYNC();
        bp_solve(A, vec, fidx, x2, x2, sscr, iters2, refine2, polish2, lane);
        const float r2 = es_residual(A, b, b + ES_M, b + 2 * ES_M,
                                     b + 3 * ES_M, b + 4 * ES_M, x2, fidx,
                                     lane);
        if (es_take(kept, r2, tol)) {
            LANE_FOR(i, 0, ES_M) lam[i] = x2[i];
            kept = r2;
            take = true;
        }
        LANE_SYNC();
    }
}

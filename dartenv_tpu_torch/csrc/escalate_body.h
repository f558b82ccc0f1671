// Per-env arithmetic of the escalation stage around the BPP solve, shared
// by the escalation kernel (bpp.cu, one warp per escalated env) and a host
// build (escalate_host.cpp) that runs it as one lane, so that a machine
// without a GPU can hold it against the plain PyTorch version
// (engine/hopper_substep.escalate_reference, lcp/hybrid.keep_best).
//
// The includer defines the sizes first (a header generated by
// lcp/hopper_bpp.py): ES_M, the rows of each LCP, and, for the fused mode
// over the substep kernel's packed `esc` rows, ES_N (dofs), ES_CAP
// (contact cap), ES_NS (contact slots), ES_MFULL (rows of lam_full), ES_CFM,
// and the offsets ES_O_* of `esc`'s blocks (engine/hopper_substep.
// _esc_layout), row width ES_W; and at most one refinement tier after the
// exact tiers: ES_REFC, the passes of the compensated (double-float)
// tier, or ES_REF64, the passes of the mixed-precision tier (float64
// residuals, float32 correction solve).  Matrices are row-major with the
// odd row stride ES_LD, so lanes that walk down a column hit distinct
// banks.
#pragma once

#include <stdint.h>

#include "linalg_body.h"
#include "pgs_row.h"

#ifndef ES_REFC
#define ES_REFC 0
#endif
#ifndef ES_REF64
#define ES_REF64 0
#endif
#if ES_REFC > 0 && ES_REF64 > 0
#error "one refinement tier per build: ES_REFC or ES_REF64"
#endif
// passes of the build's refinement tier (0: none)
#define ES_REF_PASSES (ES_REF64 > 0 ? ES_REF64 : ES_REFC)

#ifdef __CUDACC__
#define ES_FN __device__
#else
#define ES_FN static
#endif

#define ES_LD (ES_M | 1)

// lcp/hybrid.comp_residual of x: the normalized max complementarity
// violation over active rows, at x's own friction-bound fixed point.  Rows
// over lanes, each w_i summed in column order; every lane returns it.
ES_FN float es_residual(const float* A, const float* b, const float* lo,
                        const float* hi, const float* mu, const float* act,
                        const float* x, const int* fidx, int lane) {
    float amax = 0.0f;
    LANE_FOR(i, 0, ES_M) amax = fmaxf(amax, fabsf(x[i]));
    const float scale = fmaxf(1.0f, lanes_max(amax));
    const float eps = 1e-6f * scale + 1e-9f;
    float res = 0.0f;
    LANE_FOR(i, 0, ES_M) {
        float w = 0.0f;
        for (int j = 0; j < ES_M; ++j) w += A[i * ES_LD + j] * x[j];
        w += b[i];
        float l, h;
        const int f = fidx[i];
        if (f >= 0) {
            const float bound = mu[i] * fabsf(x[f]);
            l = fmaxf(lo[i], -bound);
            h = fminf(hi[i], bound);
        } else {
            l = fmaxf(lo[i], -1e20f);
            h = fminf(hi[i], 1e20f);
        }
        const float xi = x[i];
        const bool at_lo = xi <= l + eps;
        const bool at_hi = xi >= h - eps;
        float r = (at_lo && at_hi) ? 0.0f
                  : (at_lo ? -w : (at_hi ? w : fabsf(w)));
        r = fmaxf(r, fmaxf(l - xi, xi - h));
        if (act[i] > 0.5f) res = fmaxf(res, r);
    }
    return lanes_max(res) / scale;
}

// The keep-best rule of lcp/hybrid.keep_best: a re-solved point replaces
// the kept one only where the kept residual exceeds tol and the new one is
// lower.
ES_FN bool es_take(float res_kept, float res_new, float tol) {
    return (res_kept > tol) && (res_new < res_kept);
}

// ---- the compensated (double-float) refinement tier ----------------------
// lcp/dantzig.refine_compensated and comp_residual_ff.  The Dekker and
// Knuth identities hold only if every product and sum rounds on its own:
// the kernels are built with -fmad=false and the host builds with
// -ffp-contract=off (cuda_build.py), which this code relies on.
#define ES_SPLIT 4097.0f             // 2^12 + 1: Dekker split of a float

ES_FN void es_two_sum(float a, float b, float& s, float& e) {
    s = a + b;
    const float bb = s - a;
    e = (a - (s - bb)) + (b - bb);
}

ES_FN void es_two_prod(float a, float b, float& p, float& e) {
    p = a * b;
    const float ca = ES_SPLIT * a;
    const float ah = ca - (ca - a);
    const float al = a - ah;
    const float cb = ES_SPLIT * b;
    const float bh = cb - (cb - b);
    const float bl = b - bh;
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl;
}

// _comp_matvec_add: b_i + A_i . x with compensated sums, columns in order
ES_FN float es_comp_row(const float* Ai, const float* x, float bi) {
    float s = bi, c = 0.0f;
    for (int j = 0; j < ES_M; ++j) {
        float p, pe, se;
        es_two_prod(Ai[j], x[j], p, pe);
        es_two_sum(s, p, s, se);
        c = c + (se + pe);
    }
    return s + c;
}

// comp_residual_ff of x: es_residual with compensated row sums; every lane
// returns it.
ES_FN float es_residual_ff(const float* A, const float* vec, const int* fidx,
                           const float* x, int lane) {
    const float *b = vec, *lo = vec + ES_M, *hi = vec + 2 * ES_M,
                *mu = vec + 3 * ES_M, *act = vec + 4 * ES_M;
    float amax = 0.0f;
    LANE_FOR(i, 0, ES_M) amax = fmaxf(amax, fabsf(x[i]));
    const float scale = fmaxf(1.0f, lanes_max(amax));
    const float eps = 1e-6f * scale + 1e-9f;
    float res = 0.0f;
    LANE_FOR(i, 0, ES_M) {
        const float w = es_comp_row(A + i * ES_LD, x, b[i]);
        const int f = fidx[i];
        const float bd = f >= 0 ? mu[i] * fabsf(x[f]) : 1e20f;
        const float l = fmaxf(lo[i], -bd), h = fminf(hi[i], bd);
        const float xi = x[i];
        const bool at_lo = xi <= l + eps;
        const bool at_hi = xi >= h - eps;
        float r = (at_lo && at_hi) ? 0.0f
                  : (at_lo ? -w : (at_hi ? w : fabsf(w)));
        r = fmaxf(r, fmaxf(l - xi, xi - h));
        if (act[i] > 0.5f) res = fmaxf(res, r);
    }
    return lanes_max(res) / scale;
}

// scratch floats of es_refine: the point, the best point, lo_e, hi_e, the
// free mask, x_a, the rhs and the correction (ES_M each), the masked
// operator (ES_M x ES_LD) and la_solve_psd's scratch
constexpr int es_refine_scratch() {
    return 8 * ES_M + ES_M * ES_LD + la_solve_scratch(ES_M);
}

// refine_compensated of the point x (ES_M floats, overwritten by the best
// point) for `passes` passes: per pass, the free set of the current point
// at its own friction bounds, the compensated residual of the free-set
// system, a correction solve on the masked operator (la_solve_psd, eps
// 1e-12), a clip to the bounds, and keep-best by es_residual_ff.  A (ES_LD)
// and vec (b lo hi mu act) as es_residual takes them.
ES_FN void es_refine(const float* A, const float* vec, const int* fidx,
                     float* x, int passes, float* scr, int lane) {
    const float *b = vec, *lo = vec + ES_M, *hi = vec + 2 * ES_M,
                *mu = vec + 3 * ES_M, *act = vec + 4 * ES_M;
    float* xc = scr;                 // the current point
    float* loe = xc + ES_M;
    float* hie = loe + ES_M;
    float* fm = hie + ES_M;
    float* xa = fm + ES_M;
    float* r = xa + ES_M;
    float* d = r + ES_M;
    float* best = d + ES_M;
    float* Am = best + ES_M;
    float* lscr = Am + ES_M * ES_LD;
    LANE_FOR(i, 0, ES_M) {
        xc[i] = x[i];
        best[i] = x[i];
    }
    LANE_SYNC();
    float best_r = es_residual_ff(A, vec, fidx, x, lane);
    for (int p = 0; p < passes; ++p) {
        float amax = 0.0f;
        LANE_FOR(i, 0, ES_M) amax = fmaxf(amax, fabsf(xc[i]));
        const float eps = 1e-6f * fmaxf(1.0f, lanes_max(amax));
        LANE_FOR(i, 0, ES_M) {
            const int f = fidx[i];
            const float bd = f >= 0 ? mu[i] * fabsf(xc[f]) : 1e20f;
            const float l = fmaxf(lo[i], -bd) * act[i];
            const float h = fminf(hi[i], bd) * act[i];
            const bool at_lo = xc[i] <= l + eps;
            const bool at_hi = xc[i] >= h - eps;
            const float f_i = (act[i] > 0.5f && !at_lo && !at_hi) ? 1.0f
                                                                  : 0.0f;
            const float xf = (at_hi ? h : (at_lo ? l : 0.0f)) * act[i]
                             * (1.0f - f_i);
            loe[i] = l;
            hie[i] = h;
            fm[i] = f_i;
            xa[i] = xc[i] * f_i + xf;
        }
        LANE_SYNC();
        LANE_FOR(i, 0, ES_M) {
            r[i] = -es_comp_row(A + i * ES_LD, xa, b[i]) * fm[i];
            for (int j = 0; j < ES_M; ++j) {
                float v = A[i * ES_LD + j] * fm[i] * fm[j];
                if (i == j) v = v + (1.0f - fm[j]);
                Am[i * ES_LD + j] = v;
            }
        }
        LANE_SYNC();
        la_solve_psd<ES_M>(Am, ES_LD, r, d, lscr, 1e-12f, lane);
        LANE_FOR(i, 0, ES_M)
            xc[i] = fminf(fmaxf(xa[i] + d[i] * fm[i], loe[i]), hie[i]);
        LANE_SYNC();
        const float r_new = es_residual_ff(A, vec, fidx, xc, lane);
        if (r_new < best_r) {            // the same in every lane
            LANE_FOR(i, 0, ES_M) best[i] = xc[i];
            best_r = r_new;
        }
        LANE_SYNC();
    }
    LANE_FOR(i, 0, ES_M) x[i] = best[i];
    LANE_SYNC();
}

// ---- the mixed-precision refinement tier ----------------------------------
// lcp/dantzig.refine_mixed: the point, its bounds, the free-set residual
// and the keep-best residual in double (each row's sum over the columns in
// order, from 0, then + b), the correction solve on the float32 masked
// operator.  A candidate is judged after it is rounded to float, as the
// caller only ever sees the rounded point.  -fmad=false (the kernels) and
// -ffp-contract=off (the host builds) apply to the double products too.

// Max of every lane's partial max of a double (exact in any order).
ES_FN double es_lanes_max64(double v) {
#ifdef __CUDACC__
    for (int o = 16; o > 0; o >>= 1)
        v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
#endif
    return v;
}

// A_i . x in double, columns in order from 0 (math/linalg.seq_mv)
ES_FN double es_row64(const float* Ai, const double* x) {
    double w = 0.0;
    for (int j = 0; j < ES_M; ++j) w = w + (double)Ai[j] * x[j];
    return w;
}

// lcp/hybrid.comp_residual of x in double (seq=True); every lane returns
// it.
ES_FN double es_residual64(const float* A, const float* vec, const int* fidx,
                           const double* x, int lane) {
    const float *b = vec, *lo = vec + ES_M, *hi = vec + 2 * ES_M,
                *mu = vec + 3 * ES_M, *act = vec + 4 * ES_M;
    double amax = 0.0;
    LANE_FOR(i, 0, ES_M) amax = fmax(amax, fabs(x[i]));
    const double scale = fmax(1.0, es_lanes_max64(amax));
    const double eps = 1e-6 * scale + 1e-9;
    double res = 0.0;
    LANE_FOR(i, 0, ES_M) {
        const double w = es_row64(A + i * ES_LD, x) + (double)b[i];
        const int f = fidx[i];
        const double bd = f >= 0 ? (double)mu[i] * fabs(x[f]) : 1e20;
        const double l = fmax((double)lo[i], -bd);
        const double h = fmin((double)hi[i], bd);
        const double xi = x[i];
        const bool at_lo = xi <= l + eps;
        const bool at_hi = xi >= h - eps;
        double r = (at_lo && at_hi) ? 0.0
                   : (at_lo ? -w : (at_hi ? w : fabs(w)));
        r = fmax(r, fmax(l - xi, xi - h));
        if (act[i] > 0.5f) res = fmax(res, r);
    }
    return es_lanes_max64(res) / scale;
}

// scratch floats of es_refine64: 8-byte alignment slack, seven double
// vectors (the iterate, the best point, lo_e, hi_e, the free mask, x_a,
// the rounded candidate), the float rhs and correction, the masked
// operator and la_solve_psd's scratch
constexpr int es_refine64_scratch() {
    return 2 + 14 * ES_M + 2 * ES_M + ES_M * ES_LD + la_solve_scratch(ES_M);
}

// refine_mixed of the point x (ES_M floats, overwritten by the best point,
// rounded to float) for `passes` passes.
ES_FN void es_refine64(const float* A, const float* vec, const int* fidx,
                       float* x, int passes, float* scr, int lane) {
    const float *b = vec, *lo = vec + ES_M, *hi = vec + 2 * ES_M,
                *mu = vec + 3 * ES_M, *act = vec + 4 * ES_M;
    double* xc = reinterpret_cast<double*>(
        (reinterpret_cast<uintptr_t>(scr) + 7) & ~(uintptr_t)7);
    double* best = xc + ES_M;
    double* loe = best + ES_M;
    double* hie = loe + ES_M;
    double* fm = hie + ES_M;
    double* xa = fm + ES_M;
    double* cand = xa + ES_M;
    float* r = reinterpret_cast<float*>(cand + ES_M);
    float* d = r + ES_M;
    float* Am = d + ES_M;
    float* lscr = Am + ES_M * ES_LD;
    LANE_FOR(i, 0, ES_M) {
        xc[i] = (double)x[i];
        best[i] = xc[i];
    }
    LANE_SYNC();
    double best_r = es_residual64(A, vec, fidx, xc, lane);
    for (int p = 0; p < passes; ++p) {
        double amax = 0.0;
        LANE_FOR(i, 0, ES_M) amax = fmax(amax, fabs(xc[i]));
        const double eps = 1e-6 * fmax(1.0, es_lanes_max64(amax));
        LANE_FOR(i, 0, ES_M) {
            const int f = fidx[i];
            const double bd = f >= 0 ? (double)mu[i] * fabs(xc[f]) : 1e20;
            const double a = (double)act[i];
            const double l = fmax((double)lo[i], -bd) * a;
            const double h = fmin((double)hi[i], bd) * a;
            const bool at_lo = xc[i] <= l + eps;
            const bool at_hi = xc[i] >= h - eps;
            const double f_i = (act[i] > 0.5f && !at_lo && !at_hi) ? 1.0
                                                                   : 0.0;
            const double xf = (at_hi ? h : (at_lo ? l : 0.0)) * a
                              * (1.0 - f_i);
            loe[i] = l;
            hie[i] = h;
            fm[i] = f_i;
            xa[i] = xc[i] * f_i + xf;
        }
        LANE_SYNC();
        LANE_FOR(i, 0, ES_M) {
            const double ri = -((double)b[i] + es_row64(A + i * ES_LD, xa))
                              * fm[i];
            r[i] = (float)ri;
            const float fi = (float)fm[i];
            for (int j = 0; j < ES_M; ++j) {
                float v = A[i * ES_LD + j] * fi * (float)fm[j];
                if (i == j) v = v + (1.0f - (float)fm[j]);
                Am[i * ES_LD + j] = v;
            }
        }
        LANE_SYNC();
        la_solve_psd<ES_M>(Am, ES_LD, r, d, lscr, 1e-12f, lane);
        LANE_FOR(i, 0, ES_M) {
            const double di = (double)(d[i] * (float)fm[i]);
            xc[i] = fmin(fmax(xa[i] + di, loe[i]), hie[i]);
            cand[i] = (double)(float)xc[i];    // the iterate, rounded
        }
        LANE_SYNC();
        const double r_new = es_residual64(A, vec, fidx, cand, lane);
        if (r_new < best_r) {            // the same in every lane
            LANE_FOR(i, 0, ES_M) best[i] = cand[i];
            best_r = r_new;
        }
        LANE_SYNC();
    }
    LANE_FOR(i, 0, ES_M) x[i] = (float)best[i];
    LANE_SYNC();
}

// scratch floats of the build's refinement tier (es_refine_tier)
constexpr int es_tier_scratch() {
    return ES_M + (ES_REF64 > 0 ? es_refine64_scratch()
                                : es_refine_scratch());
}

// The refinement tier of engine/pallas_substep.escalate_batch after the
// exact tiers, the build's (ES_REF64: mixed-precision, else compensated):
// lam (ES_M, in shared memory) is the kept point and `kept` its residual
// (the PGS residual where no tier took); the refined point replaces it
// where kept > tol and its residual (es_residual) is lower.  `take` and
// `kept` are updated; the same in every lane.
ES_FN void es_refine_tier(const float* A, const float* vec, const int* fidx,
                          float* lam, float tol, int passes, float* scr,
                          bool& take, float& kept, int lane) {
    float* xr = scr;                           // ES_M
    LANE_FOR(i, 0, ES_M) xr[i] = lam[i];
    LANE_SYNC();
#if ES_REF64 > 0
    es_refine64(A, vec, fidx, xr, passes, scr + ES_M, lane);
#else
    es_refine(A, vec, fidx, xr, passes, scr + ES_M, lane);
#endif
    const float *b = vec;
    const float rr = es_residual(A, b, b + ES_M, b + 2 * ES_M, b + 3 * ES_M,
                                 b + 4 * ES_M, xr, fidx, lane);
    if (es_take(kept, rr, tol)) {
        LANE_FOR(i, 0, ES_M) lam[i] = xr[i];
        kept = rr;
        take = true;
    }
    LANE_SYNC();
}

#ifdef ES_N

// The operator of one escalated env from its `esc` row, as
// engine/hopper_substep.gather_escalation rebuilds it:
//   ES_N <= 12: L = chol(M + 1e-10 I) (math/linalg.chol's entry order; the
//               columns in turn, rows below over lanes), then
//               MiJ[c] = chol_solve(L, Jc[c]) (lanes over c);
//   ES_N > 12:  M^-1 = inv_psd(M, 1e-10) (linalg_body.h: the float32
//               jitter and the recursive Schur-complement inverse), then
//               MiJ = (M^-1 Jc^T)^T (lanes over entries);
//   A = Jc M^-1 Jc^T + cfm I, then act-masked (lanes over rows).
// MiJ is (ES_M, ES_N) row-major: MiJ[c * ES_N + d] = (M^-1 Jc^T)[d][c].
// L holds ES_N x ES_N floats (the factor, or M^-1); scr holds
// es_rebuild_scratch() floats.  Ends with the warp synchronized.
constexpr int es_rebuild_scratch() {
    return ES_N > LA_UNROLL_MAX ? la_inv_scratch(ES_N) : 0;
}

ES_FN void es_rebuild(const float* esc, float* L, float* MiJ, float* A,
                      float* scr, int lane) {
    const float* M = esc + ES_O_M;
    const float* Jc = esc + ES_O_JC;
    const float* act = esc + ES_O_ACT;
#if ES_N > LA_UNROLL_MAX
    la_inv_psd<ES_N>(M, ES_N, L, ES_N, scr, 1e-10f, lane);
    LANE_FOR(t, 0, ES_M * ES_N) {
        const int c = t / ES_N, d = t - c * ES_N;
        float s = 0.0f;
        for (int k = 0; k < ES_N; ++k) s += L[d * ES_N + k] * Jc[c * ES_N + k];
        MiJ[t] = s;
    }
#else
    (void)scr;
    la_chol<ES_N>(M, ES_N, L, ES_N, 1e-10f, lane);
    LANE_FOR(c, 0, ES_M) {
        const float* rhs = Jc + c * ES_N;
        float y[ES_N], x[ES_N];
        for (int i = 0; i < ES_N; ++i) {
            float s = rhs[i];
            for (int k = 0; k < i; ++k) s = s - L[i * ES_N + k] * y[k];
            y[i] = s / L[i * ES_N + i];
        }
        for (int i = ES_N - 1; i >= 0; --i) {
            float s = y[i];
            for (int k = i + 1; k < ES_N; ++k) s = s - L[k * ES_N + i] * x[k];
            x[i] = s / L[i * ES_N + i];
        }
        for (int i = 0; i < ES_N; ++i) MiJ[c * ES_N + i] = x[i];
    }
#endif
    LANE_SYNC();
    LANE_FOR(i, 0, ES_M) {
        for (int j = 0; j < ES_M; ++j) {
            float a = 0.0f;
            for (int k = 0; k < ES_N; ++k)
                a += Jc[i * ES_N + k] * MiJ[j * ES_N + k];
            if (i == j) a = a + ES_CFM;
            a = a * act[i] * act[j];
            if (i == j) a = a + (1.0f - act[j]);
            A[i * ES_LD + j] = a;
        }
    }
    LANE_SYNC();
}

// The delta patches of escalate_reference for an env whose point changed:
//   dq_plus += M^-1 Jc^T dlam            (lanes over dofs, sum over rows
//                                         in order)
//   lam_full[3 s + k] += dlam[3 r + k]   for the compacted contact row r
//                                         that holds slot s (sel_slots),
//   lam_full[3 ns + t] += dlam[3 cap + t] (limit and friction rows).
// Full rows of slots that no compacted row holds keep their value.
ES_FN void es_patch(const float* esc, const float* MiJ, const float* dlam,
                    const float* dqp_in, const float* lamf_in,
                    float* dqp_out, float* lamf_out, int lane) {
    LANE_FOR(d, 0, ES_N) {
        float acc = 0.0f;
        for (int c = 0; c < ES_M; ++c) acc += MiJ[c * ES_N + d] * dlam[c];
        dqp_out[d] = dqp_in[d] + acc;
    }
    const float* sel = esc + ES_O_SEL;
    LANE_FOR(i, 0, ES_MFULL) {
        if (i < 3 * ES_NS) {
            const float s = (float)(i / 3);
            for (int r = 0; r < ES_CAP; ++r)
                if (sel[r] == s)
                    lamf_out[i] = lamf_in[i] + dlam[3 * r + i % 3];
        } else {
            lamf_out[i] = lamf_in[i] + dlam[3 * ES_CAP + (i - 3 * ES_NS)];
        }
    }
}

#endif  // ES_N

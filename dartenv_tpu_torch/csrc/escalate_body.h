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
// _esc_layout), row width ES_W.  Matrices are row-major with the odd row
// stride ES_LD, so lanes that walk down a column hit distinct banks.
#pragma once

#include "pgs_row.h"

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

#ifdef ES_N

// The operator of one escalated env from its `esc` row, as
// engine/hopper_substep.gather_escalation rebuilds it:
//   L = chol(M + 1e-10 I)        (math/linalg.chol's entry order; the
//                                 columns in turn, rows below over lanes)
//   MiJ[c] = chol_solve(L, Jc[c]) (M^-1 Jc^T by columns, lanes over c)
//   A = Jc M^-1 Jc^T + cfm I, then act-masked (lanes over rows)
// MiJ is (ES_M, ES_N) row-major: MiJ[c * ES_N + d] = (M^-1 Jc^T)[d][c].
// Ends with the warp synchronized.
ES_FN void es_rebuild(const float* esc, float* L, float* MiJ, float* A,
                      int lane) {
    const float* M = esc + ES_O_M;
    const float* Jc = esc + ES_O_JC;
    const float* act = esc + ES_O_ACT;
    for (int j = 0; j < ES_N; ++j) {
        if (lane == 0) {
            float s = M[j * ES_N + j];
            s = s + 1e-10f;
            for (int k = 0; k < j; ++k)
                s = s - L[j * ES_N + k] * L[j * ES_N + k];
            L[j * ES_N + j] = sqrtf(fmaxf(s, 1e-30f));
        }
        LANE_SYNC();
        LANE_FOR(i, j + 1, ES_N) {
            float s = M[i * ES_N + j];
            for (int k = 0; k < j; ++k)
                s = s - L[i * ES_N + k] * L[j * ES_N + k];
            L[i * ES_N + j] = s / L[j * ES_N + j];
        }
        LANE_SYNC();
    }
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

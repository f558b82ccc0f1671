// Host build of the escalation kernel's core mode above 32 rows
// (bpp_body.h: the solve with the lanes over rows and the working matrix
// in shared memory), of its hybrid mode's per-env work (the tiers, then
// the build's refinement tier: ES_REFC passes of the compensated one or
// ES_REF64 passes of the mixed-precision one), and of the two
// refinements' arithmetic, as one lane in a loop over the problems.  Build
// with a C++ compiler and -ffp-contract=off (like the kernel's
// -fmad=false).
// For tests on machines without a GPU; nothing on the main path calls it.
#include <string.h>

#include "bpp_model.h"
#ifndef ES_REFC
#define ES_REFC 0
#endif
#include "bpp_body.h"

static void load_problem(const float* A_g, const float* b_g,
                         const float* lo_g, const float* hi_g,
                         const float* mu_g, const float* act_g, size_t k,
                         float* A, float* vec) {
    const size_t off = k * ES_M;
    for (int i = 0; i < ES_M; ++i)
        for (int j = 0; j < ES_M; ++j)
            A[i * ES_LD + j] = A_g[(off + i) * ES_M + j];
    memcpy(vec, b_g + off, ES_M * sizeof(float));
    memcpy(vec + ES_M, lo_g + off, ES_M * sizeof(float));
    memcpy(vec + 2 * ES_M, hi_g + off, ES_M * sizeof(float));
    memcpy(vec + 3 * ES_M, mu_g + off, ES_M * sizeof(float));
    memcpy(vec + 4 * ES_M, act_g + off, ES_M * sizeof(float));
}

// A (K, ES_M, ES_M); b, lo, hi, mu, act, lam0 (K, ES_M) -> lam (K, ES_M)
extern "C" int bpp_core_host(const float* A_g, const float* b_g,
                             const float* lo_g, const float* hi_g,
                             const float* mu_g, const float* act_g,
                             const float* lam0_g, const int* findex,
                             float* lam_g, int K, int iters, int refine,
                             int polish) {
    static float A[ES_M * ES_LD], vec[5 * ES_M], x[ES_M],
        scr[bp_solve_scratch()];
    for (int k = 0; k < K; ++k) {
        const size_t off = (size_t)k * ES_M;
        load_problem(A_g, b_g, lo_g, hi_g, mu_g, act_g, k, A, vec);
        memcpy(x, lam0_g + off, ES_M * sizeof(float));
        bp_solve(A, vec, findex, x, x, scr, iters, refine, polish, 0);
        memcpy(lam_g + off, x, ES_M * sizeof(float));
    }
    return 0;
}

// The compensated refinement tier's arithmetic (escalate_body.h es_refine,
// es_residual_ff) on K problems: x (K, ES_M) in, the refined points out
// (K, ES_M); res_ff (K, 2): comp_residual_ff of the input point and of the
// refined one.
extern "C" int refine_host(const float* A_g, const float* b_g,
                           const float* lo_g, const float* hi_g,
                           const float* mu_g, const float* act_g,
                           const float* x_g, const int* findex, int passes,
                           float* x_out, float* res_ff, int K) {
    static float A[ES_M * ES_LD], vec[5 * ES_M], x[ES_M],
        scr[es_refine_scratch()];
    for (int k = 0; k < K; ++k) {
        const size_t off = (size_t)k * ES_M;
        load_problem(A_g, b_g, lo_g, hi_g, mu_g, act_g, k, A, vec);
        memcpy(x, x_g + off, ES_M * sizeof(float));
        res_ff[2 * k] = es_residual_ff(A, vec, findex, x, 0);
        es_refine(A, vec, findex, x, passes, scr, 0);
        res_ff[2 * k + 1] = es_residual_ff(A, vec, findex, x, 0);
        memcpy(x_out + off, x, ES_M * sizeof(float));
    }
    return 0;
}

// The mixed-precision refinement tier's arithmetic (escalate_body.h
// es_refine64, es_residual64) on K problems: x (K, ES_M) in, the refined
// points out (K, ES_M); res64 (K, 2): the float64 residual of the input
// point and of the refined one.
extern "C" int refine64_host(const float* A_g, const float* b_g,
                             const float* lo_g, const float* hi_g,
                             const float* mu_g, const float* act_g,
                             const float* x_g, const int* findex, int passes,
                             float* x_out, double* res64, int K) {
    static float A[ES_M * ES_LD], vec[5 * ES_M], x[ES_M],
        scr[es_refine64_scratch()];
    static double xd[ES_M];
    for (int k = 0; k < K; ++k) {
        const size_t off = (size_t)k * ES_M;
        load_problem(A_g, b_g, lo_g, hi_g, mu_g, act_g, k, A, vec);
        memcpy(x, x_g + off, ES_M * sizeof(float));
        for (int i = 0; i < ES_M; ++i) xd[i] = x[i];
        res64[2 * k] = es_residual64(A, vec, findex, xd, 0);
        es_refine64(A, vec, findex, x, passes, scr, 0);
        for (int i = 0; i < ES_M; ++i) xd[i] = x[i];
        res64[2 * k + 1] = es_residual64(A, vec, findex, xd, 0);
        memcpy(x_out + off, x, ES_M * sizeof(float));
    }
    return 0;
}

constexpr int hybrid_work() {
    return bp_tiers_scratch() > es_tier_scratch() ? bp_tiers_scratch()
                                                  : es_tier_scratch();
}

// The hybrid mode's per-env work on K gathered problems (A (K, ES_M,
// ES_M), vectors and PGS impulses lam (K, ES_M), PGS residuals worst
// (K)): bp_tiers, then the build's es_refine_tier when the header asks
// for one, as bpp_hybrid_kernel runs them above 32 rows.  Writes
// the kept points (K, ES_M; lam where none was taken), take (K) and the
// kept point's residual (K).
extern "C" int hybrid_host(const float* A_g, const float* b_g,
                           const float* lo_g, const float* hi_g,
                           const float* mu_g, const float* act_g,
                           const float* lam_g, const float* worst,
                           const int* findex, float tol, int iters1,
                           int refine1, int polish1, int iters2, int refine2,
                           int polish2, float* x_out, int* take_out,
                           float* res_out, int K) {
    static float A[ES_M * ES_LD], vec[5 * ES_M], x[ES_M],
        scr[hybrid_work()];
    for (int k = 0; k < K; ++k) {
        const size_t off = (size_t)k * ES_M;
        load_problem(A_g, b_g, lo_g, hi_g, mu_g, act_g, k, A, vec);
        memcpy(x, lam_g + off, ES_M * sizeof(float));
        bool take;
        float kept;
        bp_tiers(A, vec, findex, x, scr, worst[k], tol, iters1, refine1,
                 polish1, iters2, refine2, polish2, take, kept, 0);
        if (ES_REF_PASSES > 0)
            es_refine_tier(A, vec, findex, x, tol, ES_REF_PASSES, scr, take,
                           kept, 0);
        memcpy(x_out + off, x, ES_M * sizeof(float));
        take_out[k] = take;
        res_out[k] = kept;
    }
    return 0;
}

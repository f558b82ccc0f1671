// Host build of the escalation stage's per-env arithmetic outside the
// solves (escalate_body.h: operator rebuild, residuals, keep-best, the
// refinement tier of the build, delta patches), as one lane in a loop over
// the escalated envs, with the exact tiers' impulses handed in instead of
// solved.  Build with a C++ compiler and -ffp-contract=off (no a*b+c
// contraction, like the kernel's -fmad=false).  For tests on machines
// without a GPU; nothing on the main path calls it.
#include <string.h>

#include "bpp_model.h"
#ifndef ES_REFC
#define ES_REFC 0
#endif
#include "escalate_body.h"

constexpr int host_work() {
    return es_rebuild_scratch() > es_tier_scratch() ? es_rebuild_scratch()
                                                    : es_tier_scratch();
}

// esc_rows (K, ES_W), dqp_rows (K, ES_N), lamf_rows (K, ES_MFULL): the
// escalated envs' rows; worst (K); lam1, lam2 (K, ES_M) the tiers' points
// (lam2 may be null: no tier 2).  Writes A (K, ES_M, ES_M), MiJ (K, ES_M,
// ES_N), res (K, 3): the two tiers' points' residuals and the kept point's
// (after the refinement tier, when the build has one), take (K), the patched
// rows.
extern "C" int escalate_host(const float* esc_rows, const float* dqp_rows,
                             const float* lamf_rows, const float* worst,
                             const float* lam1, const float* lam2,
                             const int* findex, float tol, float* A_out,
                             float* MiJ_out, float* res_out, int* take_out,
                             float* dqp_out, float* lamf_out, int K) {
    static float esc[ES_W], L[ES_N * ES_N], MiJ[ES_M * ES_N],
        A[ES_M * ES_LD], x[ES_M], lam[ES_M], dlam[ES_M], work[host_work()];
    for (int k = 0; k < K; ++k) {
        memcpy(esc, esc_rows + (size_t)k * ES_W, sizeof(esc));
        es_rebuild(esc, L, MiJ, A, work, 0);
        for (int i = 0; i < ES_M; ++i)
            for (int j = 0; j < ES_M; ++j)
                A_out[((size_t)k * ES_M + i) * ES_M + j] = A[i * ES_LD + j];
        memcpy(MiJ_out + (size_t)k * ES_M * ES_N, MiJ, sizeof(MiJ));
        const float* vec = esc + ES_O_B;
        const float* lamc = esc + ES_O_LAM;
        memcpy(x, lam1 + (size_t)k * ES_M, sizeof(x));
        const float r1 = es_residual(A, vec, vec + ES_M, vec + 2 * ES_M,
                                     vec + 3 * ES_M, vec + 4 * ES_M, x,
                                     findex, 0);
        bool take = es_take(worst[k], r1, tol);
        float kept = take ? r1 : worst[k];
        memcpy(lam, take ? lam1 + (size_t)k * ES_M : lamc, sizeof(lam));
        res_out[3 * k] = r1;
        res_out[3 * k + 1] = 0.0f;
        if (lam2 != nullptr) {
            memcpy(x, lam2 + (size_t)k * ES_M, sizeof(x));
            const float r2 = es_residual(A, vec, vec + ES_M, vec + 2 * ES_M,
                                         vec + 3 * ES_M, vec + 4 * ES_M, x,
                                         findex, 0);
            res_out[3 * k + 1] = r2;
            if (es_take(kept, r2, tol)) {
                memcpy(lam, x, sizeof(lam));
                kept = r2;
                take = true;
            }
        }
        if (ES_REF_PASSES > 0)
            es_refine_tier(A, vec, findex, lam, tol, ES_REF_PASSES, work, take,
                           kept, 0);
        res_out[3 * k + 2] = kept;
        take_out[k] = take;
        const float* dq_in = dqp_rows + (size_t)k * ES_N;
        const float* lf_in = lamf_rows + (size_t)k * ES_MFULL;
        float* dq_o = dqp_out + (size_t)k * ES_N;
        float* lf_o = lamf_out + (size_t)k * ES_MFULL;
        memcpy(dq_o, dq_in, ES_N * sizeof(float));
        memcpy(lf_o, lf_in, ES_MFULL * sizeof(float));
        if (take) {
            for (int i = 0; i < ES_M; ++i) dlam[i] = lam[i] - lamc[i];
            es_patch(esc, MiJ, dlam, dq_in, lf_in, dq_o, lf_o, 0);
        }
    }
    return 0;
}

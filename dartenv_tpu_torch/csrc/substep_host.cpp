// Host build of the fused substep's per-env arithmetic (substep_body.h):
// the same code the CUDA kernel runs per warp, as a plain loop over envs,
// each env run as one lane (every lane loop takes all its items in order).
// Build with a C++ compiler and -ffp-contract=off (no a*b+c contraction,
// like the kernel's -fmad=false).  For tests on machines without a GPU;
// nothing on the main path calls it.
#define DY_CONST static const
#include "substep_model.h"
#include "substep_body.h"

extern "C" int substep_dims(int* out) {
    out[0] = SS_N; out[1] = SS_M; out[2] = SS_NS; out[3] = SS_ESC;
    return 4;
}

extern "C" int substep_host(const float* q, const float* dq,
                            const float* tau, const float* lam_prev,
                            float* dq_plus, float* lam_full, float* res,
                            float* overflow, float* con_pos,
                            float* con_depth, float* con_active,
                            float* esc, int B) {
    static float sm[SS_SMEM];
    for (int e = 0; e < B; ++e) {
        substep_dyn(e, sm, q, dq, tau);
        substep_warp(e, 0, sm, lam_prev, dq_plus, lam_full, res, overflow,
                     con_pos, con_depth, con_active, esc);
    }
    return 0;
}

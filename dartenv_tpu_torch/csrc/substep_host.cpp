// Host build of the fused substep's per-env arithmetic (substep_body.h):
// the same code the CUDA kernel runs per thread, as a plain loop over envs.
// Build with a C++ compiler and -ffp-contract=off (no a*b+c contraction,
// like the kernel's -fmad=false).  For tests on machines without a GPU;
// nothing on the main path calls it.
#define SS_CONST static const
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
    for (int e = 0; e < B; ++e)
        substep_env(e, q, dq, tau, lam_prev, dq_plus, lam_full, res,
                    overflow, con_pos, con_depth, con_active, esc);
    return 0;
}

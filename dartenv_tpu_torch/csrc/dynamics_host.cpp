// Host build of the dynamics kernel's per-env arithmetic (dynamics_body.h):
// the same code the CUDA kernel runs per thread, as a plain loop over envs.
// Build with a C++ compiler and -ffp-contract=off (no a*b+c contraction,
// like the kernel's -fmad=false).  For tests on machines without a GPU;
// nothing on the main path calls it.
#define DY_CONST static const
#include "dynamics_model.h"
#include "dynamics_body.h"

extern "C" int dynamics_dims(int* out) {
    out[0] = DY_N; out[1] = DY_NB;
    return 2;
}

extern "C" int dynamics_host(const float* q, const float* dq,
                             const float* tau, float* dq_star, float* M,
                             float* phi, float* R_w, float* p_w, int B) {
    for (int e = 0; e < B; ++e)
        dynamics_env(e, q, dq, tau, dq_star, M, phi, R_w, p_w);
    return 0;
}

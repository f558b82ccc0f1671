// Host build of the dynamics kernel's per-env arithmetic (dynamics_body.h's
// dyn_group): the code the CUDA kernel runs on a group of lanes, as a plain
// loop over envs, each env run as one lane that takes every item in order.
// Build with a C++ compiler and -ffp-contract=off (no a*b+c contraction,
// like the kernel's -fmad=false).  For tests on machines without a GPU;
// nothing on the main path calls it.
#define DY_CONST static const
#include "dynamics_model.h"
#include "dynamics_body.h"

extern "C" int dynamics_dims(int* out) {
    out[0] = DY_N; out[1] = DY_NB; out[2] = DY_G;
    return 3;
}

extern "C" int dynamics_host(const float* q, const float* dq,
                             const float* tau, float* dq_star, float* M,
                             float* phi, float* R_w, float* p_w, int B) {
    static float scr[DY_SCRATCH], L[DY_N * DY_N];
    for (int e = 0; e < B; ++e)
        dyn_group(0, q + (size_t)e * DY_N, dq + (size_t)e * DY_N,
                  tau + (size_t)e * DY_N, R_w + (size_t)e * 9 * DY_NB,
                  p_w + (size_t)e * 3 * DY_NB, phi + (size_t)e * 6 * DY_N,
                  M + (size_t)e * DY_N * DY_N, dq_star + (size_t)e * DY_N,
                  L, scr);
    return 0;
}

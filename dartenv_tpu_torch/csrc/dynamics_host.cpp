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
    out[0] = DY_N; out[1] = DY_NB; out[2] = DY_G; out[3] = DR_F;
    return 4;
}

// dr: as dynamics.cu's dynamics_launch takes it
extern "C" int dynamics_host(const float* q, const float* dq,
                             const float* tau, float* dq_star, float* M,
                             float* phi, float* R_w, float* p_w,
                             const float* const* dr, int B) {
    static float scr[DY_SCRATCH], L[DY_N * DY_N];
    static float drl[DR_F > 0 ? DR_F : 1];
    for (int e = 0; e < B; ++e) {
#if DR_F
        dr_load_env(dr, drl, e);
#else
        (void)dr;
#endif
        dyn_group(0, q + (size_t)e * DY_N, dq + (size_t)e * DY_N,
                  tau + (size_t)e * DY_N, R_w + (size_t)e * 9 * DY_NB,
                  p_w + (size_t)e * 3 * DY_NB, phi + (size_t)e * 6 * DY_N,
                  M + (size_t)e * DY_N * DY_N, dq_star + (size_t)e * DY_N,
                  L, scr, drl);
    }
    return 0;
}

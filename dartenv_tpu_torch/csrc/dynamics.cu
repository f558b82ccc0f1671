// Smooth dynamics phase for Hopper (sm_90a): one launch per substep.
//
// Replaces the TPU kernel dartenv_tpu/dynamics/pallas_dynamics.py::
// _dyn_kernel (per-env body _trace_env, wrapper dynamics_pallas).  Per
// env, (q, dq, tau) -> (dq_star, M, phi, R_w, p_w): the transforms and
// S / S-dot rows of all ten joint types, the static tree recursion, the
// world-frame dof columns phi at the world origin, the composite mass
// matrix, bias forces, and the implicit spring/damping forward solve
// (Cholesky).  Collision, the constraint solve and the position update
// stay outside, as in the JAX package.
//
// What bounds it on this card: not bytes (3 n floats in, n + n^2 + 6 n +
// 12 nb out per env: 48 floats for cartpole) and not arithmetic (a few
// thousand flops per env); each env's work is a dependent chain (tree
// recursion, then the Cholesky solve), so the kernel is bound by latency
// and by how many envs are in flight.
//
// Design: ONE THREAD PER ENV, blocks of one warp, as the fused substep
// kernel (whose dynamics stage this is: both include dynamics_body.h).
// The per-env working set (poses, velocities, S rows, M, its factor) sits
// in registers and local memory.  The model is compiled in: sizes as
// macros and tables as __constant__ arrays from a header generated from
// the model's static digest (dynamics_model.h; one build per digest), read
// uniformly by a warp.  Outputs are written row-major in the boundary
// layout of the JAX kernel.  Domain-randomized model leaves as per-env
// inputs (the JAX kernel's DR_FIELDS_DYN) are not ported yet: they wait
// for the domain-randomization slice of the port.
//
// Built with -fmad=false: products and sums round separately, like the
// plain PyTorch version (dynamics/hopper_dynamics.dynamics_reference).

#include <cuda_runtime.h>

#include "dynamics_model.h"
#include "dynamics_body.h"

#define DY_BLOCK 32

__global__ void __launch_bounds__(DY_BLOCK)
dynamics_kernel(const float* __restrict__ q, const float* __restrict__ dq,
                const float* __restrict__ tau, float* __restrict__ dq_star,
                float* __restrict__ M, float* __restrict__ phi,
                float* __restrict__ R_w, float* __restrict__ p_w, int B) {
    const int e = blockIdx.x * DY_BLOCK + threadIdx.x;
    if (e >= B) return;                       // ragged edge: masked
    dynamics_env(e, q, dq, tau, dq_star, M, phi, R_w, p_w);
}

extern "C" int dynamics_dims(int* out) {
    out[0] = DY_N; out[1] = DY_NB;
    return 2;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int dynamics_launch(const float* q, const float* dq,
                               const float* tau, float* dq_star, float* M,
                               float* phi, float* R_w, float* p_w, int B,
                               void* stream) {
    const int grid = (B + DY_BLOCK - 1) / DY_BLOCK;
    dynamics_kernel<<<grid, DY_BLOCK, 0, (cudaStream_t)stream>>>(
        q, dq, tau, dq_star, M, phi, R_w, p_w, B);
    return (int)cudaGetLastError();
}

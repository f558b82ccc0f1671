// Fused physics substep for Hopper (sm_90a): one launch per substep.
//
// Replaces the TPU kernel dartenv_tpu/engine/pallas_substep.py::
// _substep_kernel (per-env body _trace_substep, wrapper substep_pallas;
// its dynamics stage is dynamics/pallas_dynamics.py::_trace_env).  Per env:
//   joint kinematics + tree recursion -> world dof columns phi -> mass
//   matrix + bias forces -> implicit forward dynamics (Cholesky) ->
//   halfspace collision (sphere 1 / capsule 2 / box 4-of-8 slots) ->
//   rank-select compaction (top-cap by score, original slot order) ->
//   contact + limit + dof-friction rows -> A = J M^-1 J^T + cfm ->
//   warm-started PGS -> fused normalized residual -> dq_plus, lam_full and
//   the packed `esc` buffer for the escalation stage.
//
// What bounds it on this card: not bytes (about 2.6 KB in + out per env)
// and not arithmetic (a few 1e4 flops per env); the per-env work is a long
// dependent chain (tree recursion, two Cholesky solves, PGS_ITERS x M_C
// sequential Gauss-Seidel row updates), so the kernel is bound by latency
// and by how many envs are in flight.
//
// Design: ONE THREAD PER ENV.  The per-env working set (A 24x24, Jc 24x9,
// M^-1 J^T 9x24, M 9x9, phi 9x6 for walker2d: ~1.3k floats) is far beyond
// 255 registers, so the big arrays are thread-local arrays in local memory
// (which the hardware interleaves across the threads of a warp, so a
// warp's accesses to one array element coalesce) and stay L1/L2 resident.
// Blocks are one warp wide, so a 4096-env batch spreads over 128 blocks
// and every SM gets work.  The ragged last block is masked (no padding).
//
// The model is NOT passed at run time: sizes are compile-time constants
// and the model tables are __constant__ arrays, both from a header
// generated from the model's static digest (substep_model.h; one build per
// distinct digest).  Every thread of a warp reads the same table entry at
// the same time, which is what the constant cache serves best.
//
// Joint types: WELD, REVOLUTE, PRISMATIC, PLANAR.  Geoms: sphere, capsule,
// box.  The per-env arithmetic lives in substep_body.h, which a host
// compiler can build too (substep_host.cpp).  Built with -fmad=false so
// products and sums round separately, as in the plain PyTorch version
// (engine/hopper_substep.substep_reference).

#include <cuda_runtime.h>

#include "substep_model.h"
#include "substep_body.h"

#define SS_BLOCK 32

__global__ void __launch_bounds__(SS_BLOCK)
substep_kernel(const float* __restrict__ q_g, const float* __restrict__ dq_g,
               const float* __restrict__ tau_g,
               const float* __restrict__ lam_g, float* __restrict__ dqp_g,
               float* __restrict__ lamf_g, float* __restrict__ res_g,
               float* __restrict__ ovf_g, float* __restrict__ cpos_g,
               float* __restrict__ cdep_g, float* __restrict__ cact_g,
               float* __restrict__ esc_g, int B) {
    const int e = blockIdx.x * SS_BLOCK + threadIdx.x;
    if (e >= B) return;                       // ragged edge: masked
    substep_env(e, q_g, dq_g, tau_g, lam_g, dqp_g, lamf_g, res_g, ovf_g,
                cpos_g, cdep_g, cact_g, esc_g);
}

extern "C" int substep_dims(int* out) {
    out[0] = SS_N; out[1] = SS_M; out[2] = SS_NS; out[3] = SS_ESC;
    return 4;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int substep_launch(const float* q, const float* dq,
                              const float* tau, const float* lam_prev,
                              float* dq_plus, float* lam_full, float* res,
                              float* overflow, float* con_pos,
                              float* con_depth, float* con_active,
                              float* esc, int B, void* stream) {
    const int grid = (B + SS_BLOCK - 1) / SS_BLOCK;
    substep_kernel<<<grid, SS_BLOCK, 0, (cudaStream_t)stream>>>(
        q, dq, tau, lam_prev, dq_plus, lam_full, res, overflow, con_pos,
        con_depth, con_active, esc, B);
    return (int)cudaGetLastError();
}

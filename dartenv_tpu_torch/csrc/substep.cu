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
// and by how many envs are in flight.  The earlier design (one thread per
// env, the working set in local memory, blocks of one warp) ran a batch of
// 4096 envs as 128 one-warp blocks: one warp on an SM, nothing to hide its
// local-memory latency, stores 447 floats apart.
//
// Design: ONE WARP PER ENV, SS_WARPS = 16 envs per block, two blocks per
// SM (64 registers), the per-env working set in dynamic shared memory
// (substep_body.h's SS_SMEM floats: A, Jc, M^-1 Jc^T, M, L, phi, R_w, p_w,
// the slot and row vectors; 6.6 KB for walker2d), so a 4096-env batch is
// one wave of 32 warps on each SM.  The lanes take the independent items:
// geoms in collision, the slots' compaction ranks, the contact / limit /
// friction rows, the M_C columns of M^-1 Jc^T, the rows of A, the
// residual rows, the output entries (every output row is stored by the
// warp as one coalesced run; `esc` is laid out in shared memory in its own
// order and copied).  The serial chains stay serial: the PGS sweeps are the
// PGS kernel's row update (pgs_row.h: a lane-wise product, a shuffle
// butterfly, one lane's write); the dynamics stage and the Cholesky of M
// run one env per THREAD, the block's 16 envs on the lanes of its first
// warp (a first version ran them on lane 0 of each env's warp: one
// warp-instruction per env instead of per 16 envs, and the stage took 64 %
// of the launch's cycles; bench/kernel_stages.py measures the split).
//
// The model is NOT passed at run time: sizes are compile-time constants
// and the model tables are __constant__ arrays, both from a header
// generated from the model's static digest (substep_model.h; one build per
// distinct digest).
//
// Joint types: WELD, REVOLUTE, PRISMATIC, PLANAR (the wrapper's gate; the
// shared dynamics stage takes all ten).  Geoms: sphere, capsule, box.  The
// per-env arithmetic lives in substep_body.h, whose dynamics stage is
// dynamics_body.h (shared with dynamics.cu); a host compiler can build both
// (substep_host.cpp), running each env as one lane.  Built with
// -fmad=false so products and sums round separately, as in the plain
// PyTorch version (engine/hopper_substep.substep_reference).

#include <cuda_runtime.h>

#include "substep_model.h"

// Envs (warps) per block; __launch_bounds__ asks for two blocks per SM
// (64 registers).  The dynamics stage runs the block's SS_WARPS envs on
// the first lanes of warp 0, so SS_WARPS must not exceed a warp.
#define SS_WARPS 16
static_assert(SS_WARPS <= 32, "the dynamics stage takes one lane per env");

// With SS_STAMPS defined (bench/kernel_stages.py), lane 0 of every warp
// adds the clock64() cycles of each stage of substep_body.h to
// ss_cycles[stage]; substep_stage_cycles reads and clears them.  Stages:
// 0 load + dynamics (to the block's barrier), 1 collision + compaction,
// 2 rows, 3 M^-1 Jc^T + A + warm start, 4 PGS, 5 residual + stores.
#define SS_NSTAGES 6
#ifdef SS_STAMPS
__device__ unsigned long long ss_cycles[SS_NSTAGES];
#define SS_STAMP_DECL long long ss_t0 = clock64();
#define SS_STAMP(k)                                                   \
    do {                                                              \
        if (lane == 0) {                                              \
            const long long t = clock64();                            \
            atomicAdd(&ss_cycles[k], (unsigned long long)(t - ss_t0)); \
            ss_t0 = t;                                                \
        }                                                             \
    } while (0)
#endif

#include "substep_body.h"

__global__ void __launch_bounds__(SS_WARPS * 32, 2)
substep_kernel(const float* __restrict__ q_g, const float* __restrict__ dq_g,
               const float* __restrict__ tau_g,
               const float* __restrict__ lam_g, float* __restrict__ dqp_g,
               float* __restrict__ lamf_g, float* __restrict__ res_g,
               float* __restrict__ ovf_g, float* __restrict__ cpos_g,
               float* __restrict__ cdep_g, float* __restrict__ cact_g,
               float* __restrict__ esc_g, int B) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int e0 = blockIdx.x * SS_WARPS;
    SS_STAMP_DECL
    // the dynamics stage: one thread per env, the block's envs on the
    // first lanes of warp 0
    if (warp == 0 && lane < SS_WARPS && e0 + lane < B)
        substep_dyn(e0 + lane, smem + lane * SS_SMEM, q_g, dq_g, tau_g);
    __syncthreads();
    SS_STAMP(0);
    const int e = e0 + warp;
    if (e >= B) return;               // ragged edge: whole warps, masked
    substep_warp(e, lane, smem + warp * SS_SMEM, lam_g, dqp_g, lamf_g,
                 res_g, ovf_g, cpos_g, cdep_g, cact_g, esc_g);
}

extern "C" int substep_dims(int* out) {
    out[0] = SS_N; out[1] = SS_M; out[2] = SS_NS; out[3] = SS_ESC;
    return 4;
}

// Dynamic shared memory of one block (SS_WARPS envs), in bytes.
extern "C" int substep_smem_bytes() {
    return SS_WARPS * SS_SMEM * (int)sizeof(float);
}

// The stage cycles summed over warps since the last call (cleared);
// returns the number of stages, or 0 in a build without SS_STAMPS.
extern "C" int substep_stage_cycles(unsigned long long* out) {
#ifdef SS_STAMPS
    cudaMemcpyFromSymbol(out, ss_cycles, sizeof(ss_cycles));
    unsigned long long zero[SS_NSTAGES] = {0};
    cudaMemcpyToSymbol(ss_cycles, zero, sizeof(zero));
    return SS_NSTAGES;
#else
    (void)out;
    return 0;
#endif
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int substep_launch(const float* q, const float* dq,
                              const float* tau, const float* lam_prev,
                              float* dq_plus, float* lam_full, float* res,
                              float* overflow, float* con_pos,
                              float* con_depth, float* con_active,
                              float* esc, int B, void* stream) {
    const int bytes = substep_smem_bytes();
    if (bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            substep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            bytes);
        if (err != cudaSuccess) return (int)err;
    }
    const int grid = (B + SS_WARPS - 1) / SS_WARPS;
    substep_kernel<<<grid, SS_WARPS * 32, bytes, (cudaStream_t)stream>>>(
        q, dq, tau, lam_prev, dq_plus, lam_full, res, overflow, con_pos,
        con_depth, con_active, esc, B);
    return (int)cudaGetLastError();
}

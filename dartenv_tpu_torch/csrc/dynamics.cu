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
// Design: A GROUP OF DY_G LANES PER ENV (the smallest power of two >=
// max(nb, n), at most 32: cartpole 2, walker2d 16; from the generated
// header), DY_THREADS / DY_G envs per block, the per-env working set in
// shared memory.  The group takes the independent items of each stage
// (bodies, tree levels, dofs, (body, dof) columns, mass-matrix entries;
// dynamics_body.h's dyn_group, shared with the fused substep kernel) and
// lane 0 the serial tail (the tree sum of the bias forces, the Cholesky
// and its solves).  The block loads its envs' rows of q, dq, tau and
// stores each output's rows as contiguous runs.  The earlier design ran
// one env per thread in one-warp blocks: 2 warps per SM for cartpole at
// B = 8192, each env's chain exposed, the working set in local memory,
// every store 32 rows apart.  The model is compiled in: sizes as macros
// and tables as __constant__ arrays from a header generated from the
// model's static digest (dynamics_model.h; one build per digest).  A
// group's lanes read different bodies' rows at once, which the constant
// cache serves one address at a time.  Domain-randomized model leaves (the
// JAX kernel's DR_FIELDS_DYN) are per-env inputs when the generated header
// carries a DR layout (DR_F floats per env, one (B, width) float32 array
// per leaf, in the order of its c_dr_w / c_dr_o tables): the block copies
// its envs' rows of every leaf into the env's block of shared memory, each
// leaf's rows read as one coalesced run, and dynamics_body.h's accessors
// read the leaves there instead of in their __constant__ tables.  Without
// a DR layout the kernel is the same as before DR inputs existed.
//
// Built with -fmad=false: products and sums round separately, like the
// plain PyTorch version (dynamics/hopper_dynamics.dynamics_reference);
// every output entry keeps the earlier design's operations in its order,
// so the two agree to the bit.

#include <cuda_runtime.h>

#include "dynamics_model.h"

#define DY_THREADS 128
#define DY_EPB (DY_THREADS / DY_G)           // envs per block
static_assert(DY_G >= 1 && DY_G <= 32 && 32 % DY_G == 0,
              "a lane group is a power of two within a warp");

// With DY_STAMPS defined (bench/kernel_stages.py), lane 0 of every warp
// adds the clock64() cycles of each stage to dy_cycles[stage];
// dynamics_stage_cycles reads and clears them.  Stages: 0 load, 1 joint
// kinematics, 2 tree composition, 3 phi, 4 mass matrix, 5 bias forces,
// 6 solve, 7 stores.
#define DY_NSTAGES 8
#ifdef DY_STAMPS
__device__ unsigned long long dy_cycles[DY_NSTAGES];
#define DY_STAMP_DECL long long dy_t0 = clock64();
#define DY_STAMP_RESTART dy_t0 = clock64();
#define DY_STAMP(k)                                                   \
    do {                                                              \
        if ((threadIdx.x & 31) == 0) {                                \
            const long long t = clock64();                            \
            atomicAdd(&dy_cycles[k], (unsigned long long)(t - dy_t0)); \
            dy_t0 = t;                                                \
        }                                                             \
    } while (0)
#endif

#include "dynamics_body.h"

// floats of one env in shared memory: q, dq, tau, dq_star, M, phi, R_w,
// p_w, L, the group's scratch and the DR block
#define DY_ENV_F (4 * DY_N + 2 * DY_N * DY_N + 6 * DY_N + 12 * DY_NB \
                  + DY_SCRATCH + DR_F)

__global__ void __launch_bounds__(DY_THREADS)
dynamics_kernel(const float* __restrict__ q_g, const float* __restrict__ dq_g,
                const float* __restrict__ tau_g, float* __restrict__ dqs_g,
                float* __restrict__ M_g, float* __restrict__ phi_g,
                float* __restrict__ Rw_g, float* __restrict__ pw_g, int B
#if DR_F
                , const DrInputs dr_g
#endif
                ) {
    extern __shared__ float smem[];
    const int k = threadIdx.x / DY_G, gl = threadIdx.x % DY_G;
    const int e0 = blockIdx.x * DY_EPB;
    const int nv = min(DY_EPB, B - e0);       // envs of this block
    // one array per field for the block's envs, each a run of rows
    float* sq = smem;
    float* sdq = sq + DY_EPB * DY_N;
    float* stau = sdq + DY_EPB * DY_N;
    float* sdqs = stau + DY_EPB * DY_N;
    float* sM = sdqs + DY_EPB * DY_N;
    float* sphi = sM + DY_EPB * DY_N * DY_N;
    float* sRw = sphi + DY_EPB * 6 * DY_N;
    float* spw = sRw + DY_EPB * 9 * DY_NB;
    float* sL = spw + DY_EPB * 3 * DY_NB;
    float* sscr = sL + DY_EPB * DY_N * DY_N;
    float* sdr = sscr + DY_EPB * DY_SCRATCH;   // DR_F floats per env
    DY_STAMP_DECL

    const size_t in0 = (size_t)e0 * DY_N;
    for (int i = threadIdx.x; i < DY_EPB * DY_N; i += DY_THREADS) {
        const bool in = i < nv * DY_N;        // ragged edge: zeros
        sq[i] = in ? q_g[in0 + i] : 0.0f;
        sdq[i] = in ? dq_g[in0 + i] : 0.0f;
        stau[i] = in ? tau_g[in0 + i] : 0.0f;
    }
#if DR_F
    dr_load_block(dr_g, sdr, DR_F, DY_EPB, e0, nv);
#endif
    __syncthreads();
    DY_STAMP(0);
    dyn_group(gl, sq + k * DY_N, sdq + k * DY_N, stau + k * DY_N,
              sRw + k * 9 * DY_NB, spw + k * 3 * DY_NB, sphi + k * 6 * DY_N,
              sM + k * DY_N * DY_N, sdqs + k * DY_N, sL + k * DY_N * DY_N,
              sscr + k * DY_SCRATCH, sdr + k * DR_F);
    __syncthreads();
    DY_STAMP_RESTART
    for (int i = threadIdx.x; i < nv * DY_N; i += DY_THREADS)
        dqs_g[in0 + i] = sdqs[i];
    for (int i = threadIdx.x; i < nv * DY_N * DY_N; i += DY_THREADS)
        M_g[(size_t)e0 * DY_N * DY_N + i] = sM[i];
    for (int i = threadIdx.x; i < nv * 6 * DY_N; i += DY_THREADS)
        phi_g[(size_t)e0 * 6 * DY_N + i] = sphi[i];
    for (int i = threadIdx.x; i < nv * 9 * DY_NB; i += DY_THREADS)
        Rw_g[(size_t)e0 * 9 * DY_NB + i] = sRw[i];
    for (int i = threadIdx.x; i < nv * 3 * DY_NB; i += DY_THREADS)
        pw_g[(size_t)e0 * 3 * DY_NB + i] = spw[i];
    DY_STAMP(7);
}

extern "C" int dynamics_dims(int* out) {
    out[0] = DY_N; out[1] = DY_NB; out[2] = DY_G; out[3] = DR_F;
    return 4;
}

// The stage cycles summed over warps since the last call (cleared);
// returns the number of stages, or 0 in a build without DY_STAMPS.
extern "C" int dynamics_stage_cycles(unsigned long long* out) {
#ifdef DY_STAMPS
    cudaMemcpyFromSymbol(out, dy_cycles, sizeof(dy_cycles));
    unsigned long long zero[DY_NSTAGES] = {0};
    cudaMemcpyToSymbol(dy_cycles, zero, sizeof(zero));
    return DY_NSTAGES;
#else
    (void)out;
    return 0;
#endif
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
// dr: DR_NF pointers to the DR leaves' (B, c_dr_w[f]) arrays (ignored
// without a DR layout).
extern "C" int dynamics_launch(const float* q, const float* dq,
                               const float* tau, float* dq_star, float* M,
                               float* phi, float* R_w, float* p_w,
                               const float* const* dr, int B,
                               void* stream) {
    const int bytes = DY_EPB * DY_ENV_F * (int)sizeof(float);
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            dynamics_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const int grid = (B + DY_EPB - 1) / DY_EPB;
#if DR_F
    DrInputs dr_in;
    for (int f = 0; f < DR_NF; ++f) dr_in.p[f] = dr[f];
    dynamics_kernel<<<grid, DY_THREADS, bytes, (cudaStream_t)stream>>>(
        q, dq, tau, dq_star, M, phi, R_w, p_w, B, dr_in);
#else
    (void)dr;
    dynamics_kernel<<<grid, DY_THREADS, bytes, (cudaStream_t)stream>>>(
        q, dq, tau, dq_star, M, phi, R_w, p_w, B);
#endif
    return (int)cudaGetLastError();
}

// Batched boxed-LCP projected Gauss-Seidel for Hopper (sm_90a).
//
// Replaces the TPU kernel dartenv_tpu/lcp/pallas_pgs.py::_pgs_kernel
// (wrapper pgs_solve_pallas).  Same algorithm, per env: lam = lam0, then
// `iters` sweeps over the rows in the static order 0..m-1, each row
//   w_i = A_i . lam + b_i;  new = lam_i - w_i * inv_diag_i * omega;
//   bounds [lo_i, hi_i], narrowed to [-mu_i lam_f, mu_i lam_f] when
//   findex_i = f >= 0 (no abs: the plain version's bound);
//   lam_i = clip(new) * active_i,
// and optionally the fused normalized complementarity residual of
// lcp/hybrid.comp_residual (friction bound from |lam_f|, eps = 1e-6 scale
// + 1e-9, active rows only), which the hybrid solver ranks envs by.
//
// What bounds it on this card: the bytes are small (A is m*m floats, read
// once; the vectors 8 m) and so are the operations (2 m^2 per sweep); the
// sweep is a SERIAL chain of m * iters row updates, each reading the
// impulses the previous one wrote.  So the kernel is bound by the latency
// of that chain and by how many envs are in flight.
//
// Design: ONE WARP PER ENV, up to 8 envs (warps) per block, and the chain
// in registers (the sweeps of pgs_row.h, shared with the fused substep
// kernel).  Lane l holds lam_j of its rows (j = l, l + 32, ...: R =
// ceil(m / 32) slots, a template argument chosen at launch) with the
// row's b, bounds, mu, act and inverse diagonal.  Row i is each lane's
// partial of A_i . lam over its own lam, the xor butterfly, and the owner
// lane's clip, which it keeps in its register: the next row's partials
// read it there.  So a row costs the butterfly and the clip, with no
// __syncwarp and no shared-memory round trip (the earlier design passed
// lam_i through shared memory between two __syncwarp per row).  A is
// staged once into shared memory and read by rows.  The fused residual is
// lane-parallel over rows, each lane replaying the butterfly's order on
// its row (it walked the rows one by one).  The sums keep the order of the
// plain version's row sums on the card, so the kernel follows it to the
// bit there.  m, findex, iters and omega are run-time arguments, so one
// build serves every model (m <= 32 * PG_MAX_R).

// Built with -fmad=false: products and sums round separately, like the
// plain PyTorch version (lcp/hopper_pgs.pgs_solve_reference).

#include <cuda_runtime.h>

#include "pgs_row.h"

#define WARP 32
#define MAX_WARPS 8
#define PG_MAX_R 8              // rows per lane: m <= 256

// With PG_STAMPS defined (bench/kernel_stages.py), lane 0 of every warp
// adds the clock64() cycles of each stage to pg_cycles[stage];
// pgs_stage_cycles reads and clears them.  Stages: 0 load, 1 sweeps,
// 2 residual, 3 stores.
#define PG_NSTAGES 4
#ifdef PG_STAMPS
__device__ unsigned long long pg_cycles[PG_NSTAGES];
#define PG_STAMP_DECL long long pg_t0 = clock64();
#define PG_STAMP(k)                                                   \
    do {                                                              \
        if (lane == 0) {                                              \
            const long long t = clock64();                            \
            atomicAdd(&pg_cycles[k], (unsigned long long)(t - pg_t0)); \
            pg_t0 = t;                                                \
        }                                                             \
    } while (0)
#else
#define PG_STAMP_DECL
#define PG_STAMP(k) ((void)0)
#endif

template <int R>
__global__ void pgs_kernel(const float* __restrict__ A_g,
                           const float* __restrict__ b_g,
                           const float* __restrict__ lo_g,
                           const float* __restrict__ hi_g,
                           const float* __restrict__ mu_g,
                           const float* __restrict__ act_g,
                           const float* __restrict__ lam0_g,
                           const int* __restrict__ findex,
                           float* __restrict__ lam_g,
                           float* __restrict__ res_g, int B, int m,
                           int iters, float omega) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
    const int wpb = blockDim.x / WARP;
    const int env = blockIdx.x * wpb + warp;
    PG_STAMP_DECL
    int* fidx = reinterpret_cast<int*>(smem + wpb * m * m);
    float* A = smem + warp * m * m;

    for (int i = threadIdx.x; i < m; i += blockDim.x) fidx[i] = findex[i];
    PgLane<R> s;
    if (env < B) {
        const float* Ae = A_g + (size_t)env * m * m;
        for (int k = lane; k < m * m; k += WARP) A[k] = Ae[k];
        const size_t off = (size_t)env * m;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int j = lane + r * WARP;
            const bool in = j < m;
            s.b[r] = in ? b_g[off + j] : 0.0f;
            s.lo[r] = in ? lo_g[off + j] : 0.0f;
            s.hi[r] = in ? hi_g[off + j] : 0.0f;
            s.mu[r] = in ? mu_g[off + j] : 0.0f;
            s.act[r] = in ? act_g[off + j] : 0.0f;
            s.lam[r] = in ? lam0_g[off + j] : 0.0f;
        }
    }
    __syncthreads();
    if (env >= B) return;                       // ragged last block
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int j = lane + r * WARP;
        s.invd[r] = j < m ? pgs_inv_diag(A[j * m + j], omega) : 0.0f;
    }
    PG_STAMP(0);

    // ---- sweeps, static row order (pgs_row.h) ---------------------------
#pragma unroll 1
    for (int it = 0; it < iters; ++it)
        pg_row_sweep(s, A, m, m, fidx, lane);
    PG_STAMP(1);

    // ---- fused normalized residual, lanes over rows ---------------------
    float res = 0.0f;
    if (res_g != nullptr) res = pg_row_residual(s, A, m, m, fidx, lane);
    PG_STAMP(2);
    const size_t off = (size_t)env * m;
#pragma unroll
    for (int r = 0; r < R; ++r)
        if (lane + r * WARP < m) lam_g[off + lane + r * WARP] = s.lam[r];
    if (res_g != nullptr && lane == 0) res_g[env] = res;
    PG_STAMP(3);
}

// The stage cycles summed over warps since the last call (cleared);
// returns the number of stages, or 0 in a build without PG_STAMPS.
extern "C" int pgs_stage_cycles(unsigned long long* out) {
#ifdef PG_STAMPS
    cudaMemcpyFromSymbol(out, pg_cycles, sizeof(pg_cycles));
    unsigned long long zero[PG_NSTAGES] = {0};
    cudaMemcpyToSymbol(pg_cycles, zero, sizeof(zero));
    return PG_NSTAGES;
#else
    (void)out;
    return 0;
#endif
}

// Envs per block for m rows: as many warps as fit in 48 KB of shared
// memory, at most MAX_WARPS (at least one; larger problems opt in to more
// dynamic shared memory at launch).
extern "C" int pgs_warps_per_block(int m) {
    const int per = m * m * (int)sizeof(float);
    int w = (48 * 1024 - m * (int)sizeof(int)) / (per > 0 ? per : 1);
    if (w > MAX_WARPS) w = MAX_WARPS;
    return w < 1 ? 1 : w;
}

extern "C" int pgs_smem_bytes(int m, int wpb) {
    return wpb * m * m * (int)sizeof(float) + m * (int)sizeof(int);
}

template <int R>
static int launch_r(const float* A, const float* b, const float* lo,
                    const float* hi, const float* mu, const float* act,
                    const float* lam0, const int* findex, float* lam,
                    float* res, int B, int m, int iters, float omega,
                    cudaStream_t stream) {
    const int wpb = pgs_warps_per_block(m);
    const int bytes = pgs_smem_bytes(m, wpb);
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            pgs_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const int grid = (B + wpb - 1) / wpb;
    pgs_kernel<R><<<grid, wpb * WARP, bytes, stream>>>(
        A, b, lo, hi, mu, act, lam0, findex, lam, res, B, m, iters, omega);
    return (int)cudaGetLastError();
}

// Launch on `stream`; `res` may be null (no residual).  Returns the
// cudaError_t of the launch (0 = ok; cudaErrorInvalidValue for m beyond
// 32 * PG_MAX_R rows).
extern "C" int pgs_solve_launch(const float* A, const float* b,
                                const float* lo, const float* hi,
                                const float* mu, const float* act,
                                const float* lam0, const int* findex,
                                float* lam, float* res, int B, int m,
                                int iters, float omega, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch ((m + WARP - 1) / WARP) {
#define PG_CASE(R)                                                        \
    case R:                                                               \
        return launch_r<R>(A, b, lo, hi, mu, act, lam0, findex, lam, res, \
                           B, m, iters, omega, st);
        PG_CASE(1) PG_CASE(2) PG_CASE(3) PG_CASE(4)
        PG_CASE(5) PG_CASE(6) PG_CASE(7) PG_CASE(8)
#undef PG_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
}

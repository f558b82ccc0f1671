// Batched boxed-LCP block principal pivoting and the escalation stage
// around it, for Hopper (sm_90a).
//
// Replaces the TPU kernel dartenv_tpu/lcp/pallas_bpp.py::_bpp_kernel
// (wrapper bpp_solve_pallas), and the XLA-fused escalation stage that the
// JAX package runs around it (engine/pallas_substep.py escalate_batch,
// lcp/hybrid.make_hybrid_solver).  The solve, per env: warm partition from
// lam0 -> `iters` damped pivots (bound source xb = (xb + x)/2) -> `refine`
// undamped pivots -> `polish` PGS sweeps; each pivot is a masked SPD solve
// by unpivoted Gaussian elimination with friction bounds mu * |x[findex]|.
//
// What bounds it on this card: neither bytes nor operations.  A problem is
// ~3 KB (m = 24) and the work is a SERIAL chain of (iters + refine) pivots
// x m elimination columns, then polish x m row updates; only K = 128 envs
// are escalated per substep, one warp each.  Around the solve, an eager
// PyTorch escalation stage costs some 550 small launches per substep
// (gather, operator rebuild, residuals, keep-best, patches); here it is
// the same launch.
//
// Design: ONE WARP PER ENV, one env per block (K blocks spread over the
// SMs), one build per row count ES_M <= 64 (a generated header).  Up to
// 32 rows every row loop is unrolled and ROW i LIVES IN LANE i:
//   * the working matrix of a pivot is held in registers, one row per
//     lane; the pivot row, and each x_i of the back substitution, reach the
//     other lanes by __shfl_sync from the lane that holds them, so a pivot
//     has no shared-memory round trip and no __syncwarp();
//   * the per-row vectors (b, bounds, state, x) are one register per lane;
//   * A stays in shared memory (odd row stride) for the matvecs, which
//     take x_j by shuffle and sum in column order, and for the polish,
//     whose rows are lane-wise products and a shuffle butterfly.
// Every entry's arithmetic, and its order, is the earlier shared-memory
// kernel's: f = Am[i][k] / piv, Am[i][j] -= f Am[k][j], back substitution in
// descending i, matvecs in column order, polish rows by the same butterfly.
// Above 32 rows (walker3d's 36, humanwalker's 41) a lane owns rows i and
// i + 32, and a register row of the working matrix per owned row would be
// 2 m registers; there the working matrix lives in shared memory and the
// lanes go over its rows (bpp_body.h, the same per-entry arithmetic,
// also built for the host).
//
// Three modes share that solve (one kernel each, same build):
//   core   (bpp_core_launch): (K, m, m) A and the vectors -> lam;
//   fused  (bpp_fused_launch, when the header carries the substep digest):
//          reads rows idx[k] of the substep kernel's packed `esc` itself,
//          rebuilds the operator in shared memory (escalate_body.h), runs
//          tier 1 warm and tier 2 cold, ranks by residual, keeps the best,
//          runs the header's refinement tier on the kept point when it
//          asks: ES_REFC passes of the compensated tier, or ES_REF64
//          passes of the mixed-precision (float64 residual) tier
//          (escalate_body.h es_refine_tier)
//          and writes the delta patches of dq_plus / lam_full in place
//          (the wrapper hands in copies);
//   hybrid (bpp_hybrid_launch): reads rows idx[k] of a phase-wise batch's
//          A, vectors and PGS lam, same tiers and keep-best, the same
//          es_refine_tier when the header defines ES_REFC or ES_REF64 > 0
//          (one build per (m, tier, passes)), writes lam rows in place
//          (into a copy).
//
// Built with -fmad=false: products and sums round separately, like the
// plain PyTorch versions (lcp/hopper_bpp.bpp_solve_reference,
// engine/hopper_substep.escalate_reference, lcp/hybrid); the refinement
// tier's exact two-sum and two-product identities need it too.

#include <cuda_runtime.h>

#include "bpp_model.h"
#ifndef ES_REFC
#define ES_REFC 0
#endif
#include "bpp_body.h"

#if ES_M > 64
#error "the BPP kernel holds at most two rows per lane: ES_M must be <= 64"
#endif
#if defined(ES_N) && \
    (ES_O_LO != ES_O_B + ES_M || ES_O_ACT != ES_O_B + 4 * ES_M)
#error "esc layout: b, lo, hi, mu, act must be consecutive blocks of ES_M"
#endif

// With ES_STAMPS defined (bench/kernel_stages.py), lane 0 adds the
// clock64() cycles of each stage of the fused mode to es_cycles[stage]:
// 0 load, 1 operator rebuild, 2 tiers (solves, residuals, keep-best),
// 3 patches; bpp_stage_cycles reads and clears them.
#define ES_NSTAGES 4
#ifdef ES_STAMPS
__device__ unsigned long long es_cycles[ES_NSTAGES];
#define ES_STAMP(k)                                                   \
    do {                                                              \
        if (lane == 0) {                                              \
            const long long t = clock64();                            \
            atomicAdd(&es_cycles[k], (unsigned long long)(t - es_t0)); \
            es_t0 = t;                                                \
        }                                                             \
    } while (0)
#else
#define ES_STAMP(k) ((void)0)
#endif

#define ST_FREE 0
#define ST_LO 1
#define ST_HI 2
#define WARP 32
#define FULL 0xffffffffu

#if ES_M <= 32
// ---- up to 32 rows: one row per lane, the working matrix in registers ---
// One lane's row of the problem (lanes >= ES_M hold an empty row).
struct Row {
    float b, lo, hi, mu, act;
    int f;
};

// Bounds of this lane's row with friction source src (x[f] by shuffle).
__device__ __forceinline__ void row_bounds(const Row& rw, float src,
                                           float& l, float& h) {
    const float sf = __shfl_sync(FULL, src, rw.f >= 0 ? rw.f : 0);
    l = rw.lo;
    h = rw.hi;
    if (rw.f >= 0) {
        const float fb = rw.mu * fabsf(sf);
        l = fmaxf(l, -fb);
        h = fminf(h, fb);
    } else {
        l = fmaxf(l, -1e20f);
        h = fminf(h, 1e20f);
    }
}

// sum_j Ar[j] v_j in column order, v_j from lane j
__device__ __forceinline__ float matvec(const float* Ar, float v) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < ES_M; ++j) acc += Ar[j] * __shfl_sync(FULL, v, j);
    return acc;
}

// The whole solve for one env; As is A in shared memory (row stride
// ES_LD).  Returns this lane's lam entry.
__device__ __noinline__ float bpp_warp(const float* As, Row rw, float x0,
                                       int iters, int refine, int polish,
                                       int lane) {
    const bool live = lane < ES_M;
    const float* Ar = As + (live ? lane : 0) * ES_LD;

    // ---- initial partition from the warm start -------------------------
    float l, h;
    float xb = x0;                       // raw warm start, clipped here
    row_bounds(rw, xb, l, h);
    float x = fminf(fmaxf(xb, l), h);
    int st = (x >= h - 1e-12f) ? ST_HI : ((x <= l + 1e-12f) ? ST_LO : ST_FREE);
    {
        const float w = matvec(Ar, x) + rw.b;
        if (st == ST_LO && w < 0.0f) st = ST_FREE;
        if (st == ST_HI && w > 0.0f) st = ST_FREE;
    }
    xb = x;

    // ---- damped pivots, then undamped refinement -----------------------
    for (int it = 0; it < iters + refine; ++it) {
        const bool damped = it < iters;
        if (!damped) xb = x;
        row_bounds(rw, xb, l, h);
        const float fm = (st == ST_FREE && rw.act > 0.5f) ? 1.0f : 0.0f;
        float xf = (st == ST_LO) ? l : ((st == ST_HI) ? h : 0.0f);
        xf = xf * rw.act * (1.0f - fm);
        float r = matvec(Ar, xf) + rw.b;         // rhs = -(b + A x_fixed) f
        r = -r * fm;
        float row[ES_M];                         // Am = A f f^T + diag(1 - f)
#pragma unroll
        for (int j = 0; j < ES_M; ++j) {
            const float fj = __shfl_sync(FULL, fm, j);
            float v = Ar[j] * fm * fj;
            if (j == lane) v += 1.0f - fj;
            row[j] = v;
        }
        // forward elimination, rows below the pivot only
#pragma unroll
        for (int k = 0; k < ES_M - 1; ++k) {
            const float piv = __shfl_sync(FULL, row[k], k);
            const float rk = __shfl_sync(FULL, r, k);
            const bool below = lane > k;
            const float fk = row[k] / piv;
#pragma unroll
            for (int j = k + 1; j < ES_M; ++j) {
                const float akj = __shfl_sync(FULL, row[j], k);
                if (below) row[j] -= fk * akj;
            }
            if (below) r -= fk * rk;
        }
        // back substitution, column oriented
        float xfree = 0.0f;
#pragma unroll
        for (int i = ES_M - 1; i >= 0; --i) {
            const float xi = __shfl_sync(FULL, r / row[i], i);
            if (lane == i) xfree = xi;
            if (lane < i) r -= row[i] * xi;
        }
        const float xn = xfree * fm + xf;        // x_free f + x_fixed
        const float w = matvec(Ar, xn) + rw.b;
        const bool fr = fm > 0.5f;
        if (fr && xn < l - 1e-12f) st = ST_LO;
        if (fr && xn > h + 1e-12f) st = ST_HI;
        if (st == ST_LO && w < -1e-10f) st = ST_FREE;
        if (st == ST_HI && w > 1e-10f) st = ST_FREE;
        x = fminf(fmaxf(xn, l), h);
        if (damped) xb = 0.5f * (xb + x);
    }

    // ---- PGS polish ----------------------------------------------------
    if (polish <= 0) return x * rw.act;
    const float d = live ? Ar[lane] : 0.0f;
    const float invd = (d > 1e-12f) ? 1.0f / fmaxf(d, 1e-12f) : 0.0f;
    for (int sw = 0; sw < polish; ++sw) {
        for (int i = 0; i < ES_M; ++i) {
            float part = 0.0f;
            if (live) part += As[i * ES_LD + lane] * x;
            for (int o = WARP / 2; o > 0; o >>= 1)
                part += __shfl_xor_sync(FULL, part, o);
            const float sf = __shfl_sync(FULL, x, rw.f >= 0 ? rw.f : 0);
            if (lane == i) {
                const float w_i = part + rw.b;
                const float nw = x - w_i * invd;
                float lo = rw.lo, hi = rw.hi;
                // plain rows keep their own bounds here (no +-1e20 cap)
                if (rw.f >= 0) {
                    const float fb = rw.mu * fabsf(sf);
                    lo = fmaxf(rw.lo, -fb);
                    hi = fminf(rw.hi, fb);
                }
                x = fminf(fmaxf(nw, lo), hi) * rw.act;
            }
        }
    }
    return x;
}

// Tier 1 warm from lamc, tier 2 cold when iters2 > 0, each ranked by
// es_residual and kept by es_take.  vec: b, lo, hi, mu, act (ES_M each) in
// shared memory; xs: ES_M floats of scratch.  Returns this lane's kept
// entry; take / kept residual are the same in every lane.
__device__ float tiers(const float* As, const Row& rw, const float* vec,
                       const int* fs, float* xs, float lamc, float worst,
                       float tol, int iters1, int refine1, int polish1,
                       int iters2, int refine2, int polish2, int lane,
                       bool& take, float& kept) {
    const bool live = lane < ES_M;
    const float* b = vec;
    const float x1 = bpp_warp(As, rw, lamc, iters1, refine1, polish1, lane);
    if (live) xs[lane] = x1;
    __syncwarp();
    const float r1 = es_residual(As, b, b + ES_M, b + 2 * ES_M, b + 3 * ES_M,
                                 b + 4 * ES_M, xs, fs, lane);
    __syncwarp();
    take = es_take(worst, r1, tol);
    kept = take ? r1 : worst;
    float lam = take ? x1 : lamc;
    if (iters2 > 0) {
        const float x2 = bpp_warp(As, rw, 0.0f, iters2, refine2, polish2,
                                  lane);
        if (live) xs[lane] = x2;
        __syncwarp();
        const float r2 = es_residual(As, b, b + ES_M, b + 2 * ES_M,
                                     b + 3 * ES_M, b + 4 * ES_M, xs, fs,
                                     lane);
        __syncwarp();
        if (es_take(kept, r2, tol)) {
            lam = x2;
            kept = r2;
            take = true;
        }
    }
    return lam;
}

__device__ __forceinline__ Row load_row(const float* b, const float* lo,
                                        const float* hi, const float* mu,
                                        const float* act, const int* fidx,
                                        int i) {
    Row rw;
    if (i < ES_M) {
        rw.b = b[i]; rw.lo = lo[i]; rw.hi = hi[i]; rw.mu = mu[i];
        rw.act = act[i]; rw.f = fidx[i];
    } else {
        rw.b = rw.lo = rw.hi = rw.mu = rw.act = 0.0f;
        rw.f = -1;
    }
    return rw;
}

#endif  // ES_M <= 32

__device__ __forceinline__ void load_matrix(const float* Ag, float* As,
                                            int lane) {
    for (int idx = lane; idx < ES_M * ES_M; idx += WARP) {
        const int i = idx / ES_M, j = idx - i * ES_M;
        As[i * ES_LD + j] = Ag[idx];
    }
}

// ---- core mode -----------------------------------------------------------
__global__ void __launch_bounds__(WARP)
bpp_core_kernel(const float* __restrict__ A_g, const float* __restrict__ b_g,
                const float* __restrict__ lo_g, const float* __restrict__ hi_g,
                const float* __restrict__ mu_g,
                const float* __restrict__ act_g,
                const float* __restrict__ lam0_g,
                const int* __restrict__ findex, float* __restrict__ lam_g,
                int iters, int refine, int polish) {
    extern __shared__ float As[];
    const int env = blockIdx.x, lane = threadIdx.x;
    const size_t off = (size_t)env * ES_M;
    load_matrix(A_g + off * ES_M, As, lane);
#if ES_M <= 32
    const Row rw = load_row(b_g + off, lo_g + off, hi_g + off, mu_g + off,
                            act_g + off, findex, lane);
    const float x0 = lane < ES_M ? lam0_g[off + lane] : 0.0f;
    __syncwarp();
    const float x = bpp_warp(As, rw, x0, iters, refine, polish, lane);
    if (lane < ES_M) lam_g[off + lane] = x;
#else
    float* vec = As + ES_M * ES_LD;               // b lo hi mu act
    float* x = vec + 5 * ES_M;
    int* fs = reinterpret_cast<int*>(x + ES_M);
    float* scr = reinterpret_cast<float*>(fs + ES_M);
    LANE_FOR(i, 0, ES_M) {
        vec[i] = b_g[off + i];
        vec[ES_M + i] = lo_g[off + i];
        vec[2 * ES_M + i] = hi_g[off + i];
        vec[3 * ES_M + i] = mu_g[off + i];
        vec[4 * ES_M + i] = act_g[off + i];
        x[i] = lam0_g[off + i];
        fs[i] = findex[i];
    }
    __syncwarp();
    bp_solve(As, vec, fs, x, x, scr, iters, refine, polish, lane);
    LANE_FOR(i, 0, ES_M) lam_g[off + i] = x[i];
#endif
}

// ---- hybrid mode: rows idx[k] of a phase-wise batch ----------------------
__global__ void __launch_bounds__(WARP)
bpp_hybrid_kernel(const float* __restrict__ A_g,
                  const float* __restrict__ b_g,
                  const float* __restrict__ lo_g,
                  const float* __restrict__ hi_g,
                  const float* __restrict__ mu_g,
                  const float* __restrict__ act_g,
                  const float* __restrict__ lam_g,
                  const long long* __restrict__ idx_g,
                  const float* __restrict__ worst_g,
                  const int* __restrict__ findex, float* __restrict__ out_g,
                  int* __restrict__ take_g, float* __restrict__ res_g,
                  float tol, int iters1, int refine1, int polish1,
                  int iters2, int refine2, int polish2) {
    extern __shared__ float sm[];
    float* As = sm;
    float* vec = As + ES_M * ES_LD;               // b lo hi mu act
    float* xs = vec + 5 * ES_M;
    int* fs = reinterpret_cast<int*>(xs + ES_M);
    const int k = blockIdx.x, lane = threadIdx.x;
    const size_t off = (size_t)idx_g[k] * ES_M;
    load_matrix(A_g + off * ES_M, As, lane);
    LANE_FOR(i, 0, ES_M) {
        vec[i] = b_g[off + i];
        vec[ES_M + i] = lo_g[off + i];
        vec[2 * ES_M + i] = hi_g[off + i];
        vec[3 * ES_M + i] = mu_g[off + i];
        vec[4 * ES_M + i] = act_g[off + i];
        fs[i] = findex[i];
    }
    [[maybe_unused]] float* scr = reinterpret_cast<float*>(fs + ES_M);
    bool take;
    float kept;
#if ES_M <= 32
    {
        const float lamc = lane < ES_M ? lam_g[off + lane] : 0.0f;
        __syncwarp();
        const Row rw = load_row(vec, vec + ES_M, vec + 2 * ES_M,
                                vec + 3 * ES_M, vec + 4 * ES_M, fs, lane);
        const float lam = tiers(As, rw, vec, fs, xs, lamc, worst_g[k], tol,
                                iters1, refine1, polish1, iters2, refine2,
                                polish2, lane, take, kept);
        if (lane < ES_M) xs[lane] = lam;
        __syncwarp();
    }
#else
    LANE_FOR(i, 0, ES_M) xs[i] = lam_g[off + i];
    __syncwarp();
    bp_tiers(As, vec, fs, xs, scr, worst_g[k], tol, iters1, refine1,
             polish1, iters2, refine2, polish2, take, kept, lane);
#endif
#if ES_REF_PASSES > 0
    es_refine_tier(As, vec, fs, xs, tol, ES_REF_PASSES, scr, take, kept,
                   lane);
#endif
    if (take) LANE_FOR(i, 0, ES_M) out_g[off + i] = xs[i];
    if (lane == 0) {
        take_g[k] = take;
        res_g[k] = kept;
    }
}

// floats of scratch after the core and hybrid modes' fixed blocks: the
// solve's above 32 rows, and the hybrid mode's refinement tier's (reused
// in turn)
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int solve_work() { return ES_M <= 32 ? 0 : bp_tiers_scratch(); }
constexpr int refine_work() {
    return ES_REF_PASSES > 0 ? es_tier_scratch() : 0;
}

#ifdef ES_N
// the fused mode's scratch: the operator rebuild's, then the tiers' and
// the refinement tier's (reused in turn)
constexpr int FUSED_WORK = cmax(es_rebuild_scratch(),
                                cmax(solve_work(), refine_work()));

// ---- fused mode: rows idx[k] of the substep kernel's outputs -------------
__global__ void __launch_bounds__(WARP)
bpp_fused_kernel(const float* __restrict__ esc_g,
                 const float* __restrict__ dqp_g,
                 const float* __restrict__ lamf_g,
                 const long long* __restrict__ idx_g,
                 const float* __restrict__ worst_g,
                 const int* __restrict__ findex,
                 float* __restrict__ dqp_out, float* __restrict__ lamf_out,
                 int* __restrict__ take_g, float* __restrict__ res_g,
                 float tol, int iters1, int refine1, int polish1,
                 int iters2, int refine2, int polish2) {
    extern __shared__ float sm[];
    float* esc = sm;                               // the env's `esc` row
    float* L = esc + ES_W;                         // factor of M, or M^-1
    float* MiJ = L + ES_N * ES_N;
    float* As = MiJ + ES_M * ES_N;
    float* xs = As + ES_M * ES_LD;                 // the kept point
    int* fs = reinterpret_cast<int*>(xs + ES_M);
    float* work = reinterpret_cast<float*>(fs + ES_M);   // FUSED_WORK
    const int k = blockIdx.x, lane = threadIdx.x;
#ifdef ES_STAMPS
    long long es_t0 = clock64();
#endif
    const size_t row = (size_t)idx_g[k];
    for (int t = lane; t < ES_W; t += WARP) esc[t] = esc_g[row * ES_W + t];
    LANE_FOR(i, 0, ES_M) fs[i] = findex[i];
    __syncwarp();
    ES_STAMP(0);
    es_rebuild(esc, L, MiJ, As, work, lane);
    ES_STAMP(1);
    const float* vec = esc + ES_O_B;               // b lo hi mu act, lam_c
    const float* lamc = esc + ES_O_LAM;
    bool take;
    float kept;
#if ES_M <= 32
    {
        const Row rw = load_row(vec, esc + ES_O_LO, esc + ES_O_HI,
                                esc + ES_O_MU, esc + ES_O_ACT, fs, lane);
        const float lam = tiers(As, rw, vec, fs, xs, lane < ES_M
                                ? lamc[lane] : 0.0f, worst_g[k], tol,
                                iters1, refine1, polish1, iters2, refine2,
                                polish2, lane, take, kept);
        if (lane < ES_M) xs[lane] = lam;
        __syncwarp();
    }
#else
    LANE_FOR(i, 0, ES_M) xs[i] = lamc[i];
    __syncwarp();
    bp_tiers(As, vec, fs, xs, work, worst_g[k], tol, iters1, refine1,
             polish1, iters2, refine2, polish2, take, kept, lane);
#endif
#if ES_REF_PASSES > 0
    es_refine_tier(As, vec, fs, xs, tol, ES_REF_PASSES, work, take, kept,
                   lane);
#endif
    if (lane == 0) {
        take_g[k] = take;
        res_g[k] = kept;
    }
    ES_STAMP(2);
    if (!take) return;                             // the same in every lane
    LANE_FOR(i, 0, ES_M) xs[i] = xs[i] - lamc[i];  // dlam
    __syncwarp();
    es_patch(esc, MiJ, xs, dqp_g + row * ES_N, lamf_g + row * ES_MFULL,
             dqp_out + row * ES_N, lamf_out + row * ES_MFULL, lane);
    ES_STAMP(3);
}
#endif

static int set_smem(const void* fn, int bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

extern "C" int bpp_rows() { return ES_M; }

// Passes of the compensated refinement tier the fused and hybrid modes run
extern "C" int bpp_ref_passes() { return ES_REFC; }

// Passes of the mixed-precision refinement tier they run
extern "C" int bpp_ref64_passes() { return ES_REF64; }

// The fused mode's stage cycles summed over envs since the last call
// (cleared); returns the number of stages, or 0 without ES_STAMPS.
extern "C" int bpp_stage_cycles(unsigned long long* out) {
#ifdef ES_STAMPS
    cudaMemcpyFromSymbol(out, es_cycles, sizeof(es_cycles));
    unsigned long long zero[ES_NSTAGES] = {0};
    cudaMemcpyToSymbol(es_cycles, zero, sizeof(zero));
    return ES_NSTAGES;
#else
    (void)out;
    return 0;
#endif
}

// Each launcher runs on `stream` and returns the cudaError_t of the launch
// (0 = ok).
static int core_smem_bytes() {
    return (ES_M * ES_LD + (ES_M <= 32 ? 0 : 7 * ES_M) + solve_work())
           * (int)sizeof(float);
}

// Blocks of the core mode (one env each) resident on one SM at once
// (registers, shared memory and the SM's block limit), or -1 on error.
extern "C" int bpp_core_blocks_per_sm() {
    const int bytes = core_smem_bytes();
    int n = 0;
    if (set_smem((const void*)bpp_core_kernel, bytes)) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, bpp_core_kernel, WARP, bytes) != cudaSuccess)
        return -1;
    return n;
}

extern "C" int bpp_core_launch(const float* A, const float* b,
                               const float* lo, const float* hi,
                               const float* mu, const float* act,
                               const float* lam0, const int* findex,
                               float* lam, int K, int iters, int refine,
                               int polish, void* stream) {
    const int bytes = core_smem_bytes();
    int e = set_smem((const void*)bpp_core_kernel, bytes);
    if (e) return e;
    bpp_core_kernel<<<K, WARP, bytes, (cudaStream_t)stream>>>(
        A, b, lo, hi, mu, act, lam0, findex, lam, iters, refine, polish);
    return (int)cudaGetLastError();
}

extern "C" int bpp_hybrid_launch(const float* A, const float* b,
                                 const float* lo, const float* hi,
                                 const float* mu, const float* act,
                                 const float* lam, const long long* idx,
                                 const float* worst, const int* findex,
                                 float* out, int* take, float* res, int K,
                                 float tol, int iters1, int refine1,
                                 int polish1, int iters2, int refine2,
                                 int polish2, void* stream) {
    const int bytes = (ES_M * ES_LD + 7 * ES_M
                       + cmax(solve_work(), refine_work()))
                      * (int)sizeof(float);
    int e = set_smem((const void*)bpp_hybrid_kernel, bytes);
    if (e) return e;
    bpp_hybrid_kernel<<<K, WARP, bytes, (cudaStream_t)stream>>>(
        A, b, lo, hi, mu, act, lam, idx, worst, findex, out, take, res, tol,
        iters1, refine1, polish1, iters2, refine2, polish2);
    return (int)cudaGetLastError();
}

#ifdef ES_N
extern "C" int bpp_fused_dims(int* out) {
    out[0] = ES_N; out[1] = ES_M; out[2] = ES_MFULL; out[3] = ES_W;
    out[4] = ES_REFC; out[5] = ES_REF64;
    return 6;
}

// Dynamic shared memory of one fused-mode block (one env), in bytes.
extern "C" int bpp_fused_smem_bytes() {
    return (ES_W + ES_N * ES_N + ES_M * ES_N + ES_M * ES_LD + 2 * ES_M
            + FUSED_WORK) * (int)sizeof(float);
}

extern "C" int bpp_fused_launch(const float* esc, const float* dq_plus,
                                const float* lam_full, const long long* idx,
                                const float* worst, const int* findex,
                                float* dqp_out, float* lamf_out, int* take,
                                float* res, int K, float tol, int iters1,
                                int refine1, int polish1, int iters2,
                                int refine2, int polish2, void* stream) {
    const int bytes = bpp_fused_smem_bytes();
    int e = set_smem((const void*)bpp_fused_kernel, bytes);
    if (e) return e;
    bpp_fused_kernel<<<K, WARP, bytes, (cudaStream_t)stream>>>(
        esc, dq_plus, lam_full, idx, worst, findex, dqp_out, lamf_out, take,
        res, tol, iters1, refine1, polish1, iters2, refine2, polish2);
    return (int)cudaGetLastError();
}
#endif

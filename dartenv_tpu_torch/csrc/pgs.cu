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
// Design: ONE WARP PER ENV, several envs (warps) per block.  Each env's A
// is staged once into shared memory, since every sweep and the residual
// read it again; the per-row vectors and lam sit beside it.  A row update is a
// lane-wise product over the columns (j = lane, lane + 32, ...), a
// __shfl_xor_sync butterfly that leaves the sum in every lane, and one
// lane's write of the new lam_i, which the next row reads from shared
// memory (the friction bound reads lam[findex_i] the same way).  The
// residual walks the rows in the same way, every lane holding the same w_i
// and the same running max.  m, findex, iters and omega are run-time
// arguments, so one build serves every model.
//
// Built with -fmad=false: products and sums round separately, like the
// plain PyTorch version (lcp/hopper_pgs.pgs_solve_reference).

#include <cuda_runtime.h>

#define WARP 32
#define FULL 0xffffffffu
#define MAX_WARPS 8

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = WARP / 2; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

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
    const int per = m * m + 8 * m;              // floats per env
    int* fidx = reinterpret_cast<int*>(smem + wpb * per);
    float* A = smem + warp * per;
    float* b = A + m * m;
    float* lo = b + m;
    float* hi = lo + m;
    float* mu = hi + m;
    float* act = mu + m;
    float* invd = act + m;
    float* lam = invd + m;

    for (int i = threadIdx.x; i < m; i += blockDim.x) fidx[i] = findex[i];
    if (env < B) {
        const float* Ae = A_g + (size_t)env * m * m;
        for (int k = lane; k < m * m; k += WARP) A[k] = Ae[k];
        const size_t off = (size_t)env * m;
        for (int i = lane; i < m; i += WARP) {
            b[i] = b_g[off + i];
            lo[i] = lo_g[off + i];
            hi[i] = hi_g[off + i];
            mu[i] = mu_g[off + i];
            act[i] = act_g[off + i];
            lam[i] = lam0_g[off + i];
        }
    }
    __syncthreads();
    if (env >= B) return;                       // ragged last block

    for (int i = lane; i < m; i += WARP) {
        const float d = A[i * m + i];
        invd[i] = (d > 1e-12f) ? (1.0f / fmaxf(d, 1e-12f)) * omega : 0.0f;
    }
    __syncwarp();

    // ---- sweeps, static row order --------------------------------------
    for (int it = 0; it < iters; ++it) {
        for (int i = 0; i < m; ++i) {
            const float* Ai = A + i * m;
            float part = 0.0f;
            for (int j = lane; j < m; j += WARP) part += Ai[j] * lam[j];
            const float w = warp_sum(part) + b[i];
            const float nw = lam[i] - w * invd[i];
            float l = lo[i], h = hi[i];
            const int f = fidx[i];
            if (f >= 0) {
                const float bound = mu[i] * lam[f];        // no abs here
                l = fmaxf(l, -bound);
                h = fminf(h, bound);
            }
            const float v = fminf(fmaxf(nw, l), h) * act[i];
            __syncwarp();            // every lane has read lam before ...
            if (lane == 0) lam[i] = v;
            __syncwarp();            // ... the new lam_i is visible to all
        }
    }
    const size_t off = (size_t)env * m;
    for (int i = lane; i < m; i += WARP) lam_g[off + i] = lam[i];
    if (res_g == nullptr) return;

    // ---- fused normalized residual (lcp/hybrid.comp_residual) -----------
    // rows in order, each w_i reduced across the lanes as in the sweeps
    float amax = 0.0f;
    for (int i = lane; i < m; i += WARP) amax = fmaxf(amax, fabsf(lam[i]));
    const float scale = fmaxf(1.0f, warp_max(amax));
    const float eps = 1e-6f * scale + 1e-9f;
    float res = 0.0f;
    for (int i = 0; i < m; ++i) {
        const float* Ai = A + i * m;
        float part = 0.0f;
        for (int j = lane; j < m; j += WARP) part += Ai[j] * lam[j];
        const float w = warp_sum(part) + b[i];
        float l, h;
        const int f = fidx[i];
        if (f >= 0) {
            const float bound = mu[i] * fabsf(lam[f]);
            l = fmaxf(lo[i], -bound);
            h = fminf(hi[i], bound);
        } else {
            l = fmaxf(lo[i], -1e20f);
            h = fminf(hi[i], 1e20f);
        }
        const float x = lam[i];
        const bool at_lo = x <= l + eps;
        const bool at_hi = x >= h - eps;
        float r = (at_lo && at_hi) ? 0.0f
                  : (at_lo ? -w : (at_hi ? w : fabsf(w)));
        r = fmaxf(r, fmaxf(l - x, x - h));
        if (act[i] > 0.5f) res = fmaxf(res, r);
    }
    if (lane == 0) res_g[env] = res / scale;
}

// Envs per block for m rows: as many warps as fit in 48 KB of shared
// memory, at most MAX_WARPS (at least one; larger problems opt in to more
// dynamic shared memory at launch).
extern "C" int pgs_warps_per_block(int m) {
    const int per = (m * m + 8 * m) * (int)sizeof(float);
    int w = (48 * 1024 - m * (int)sizeof(int)) / (per > 0 ? per : 1);
    if (w > MAX_WARPS) w = MAX_WARPS;
    return w < 1 ? 1 : w;
}

extern "C" int pgs_smem_bytes(int m, int wpb) {
    return wpb * (m * m + 8 * m) * (int)sizeof(float)
           + m * (int)sizeof(int);
}

// Launch on `stream`; `res` may be null (no residual).  Returns the
// cudaError_t of the launch (0 = ok).
extern "C" int pgs_solve_launch(const float* A, const float* b,
                                const float* lo, const float* hi,
                                const float* mu, const float* act,
                                const float* lam0, const int* findex,
                                float* lam, float* res, int B, int m,
                                int iters, float omega, void* stream) {
    const int wpb = pgs_warps_per_block(m);
    const int bytes = pgs_smem_bytes(m, wpb);
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            pgs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const int grid = (B + wpb - 1) / wpb;
    pgs_kernel<<<grid, wpb * WARP, bytes, (cudaStream_t)stream>>>(
        A, b, lo, hi, mu, act, lam0, findex, lam, res, B, m, iters, omega);
    return (int)cudaGetLastError();
}

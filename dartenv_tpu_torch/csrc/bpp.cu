// Batched boxed-LCP block principal pivoting for Hopper (sm_90a).
//
// Replaces the TPU kernel dartenv_tpu/lcp/pallas_bpp.py::_bpp_kernel
// (wrapper bpp_solve_pallas).  Same algorithm, per env: warm partition from
// lam0 -> `iters` damped pivots (bound source xb = (xb + x)/2) -> `refine`
// undamped pivots -> `polish` PGS sweeps; each pivot is a masked SPD solve
// by unpivoted Gaussian elimination with friction bounds mu * |x[findex]|.
//
// What bounds it on this card: neither bytes nor operations.  A problem is
// ~3 KB (m = 24) and the work is a SERIAL chain: (iters + refine) pivots x
// m elimination columns, then polish x m row updates, each step depending
// on the last.  The escalation batch is only K = 128 problems, so one
// thread per env would occupy a single block of the card.
//
// Design: ONE WARP PER ENV, one block per env (K = 128 blocks spread over
// the SMs).  A and the working copy Am live in shared memory (row stride
// padded to an odd length so lanes that walk down a column hit different
// banks); the per-row vectors live there too.  Rows are spread over the 32
// lanes with a stride loop, so any m works.  Elimination touches only the
// rows below the pivot and the columns right of it (the TPU kernel's
// full-slab masked updates exist for its vector layout only; the entries
// they additionally touch are never read again).  The serial steps are
// separated by __syncwarp().  findex is a device int array and the
// iteration counts are kernel arguments, so one build serves every model.
//
// Built with -fmad=false: products and sums round separately, like the
// plain PyTorch version (lcp/hopper_bpp.bpp_solve_reference).

#include <cuda_runtime.h>

#define ST_FREE 0
#define ST_LO 1
#define ST_HI 2
#define WARP 32
#define FULL 0xffffffffu

struct Smem {
    float *A, *Am, *b, *lo, *hi, *mu, *act, *x, *xb, *lo_i, *hi_i, *xs, *r,
        *fm, *w;
    int *state, *fidx;
};

__device__ __forceinline__ void row_bounds(const Smem& s, const float* src,
                                           int i, float& l, float& h) {
    l = s.lo[i];
    h = s.hi[i];
    const int f = s.fidx[i];
    if (f >= 0) {
        const float fb = s.mu[i] * fabsf(src[f]);
        l = fmaxf(l, -fb);
        h = fminf(h, fb);
    } else {
        l = fmaxf(l, -1e20f);
        h = fminf(h, 1e20f);
    }
}

// out[i] = sum_j A[i][j] v[j] + add[i]   (rows over lanes)
__device__ __forceinline__ void matvec_add(const float* A, int ld, int m,
                                           const float* v, const float* add,
                                           float* out, int lane) {
    for (int i = lane; i < m; i += WARP) {
        float acc = 0.0f;
        const float* Ai = A + i * ld;
        for (int j = 0; j < m; ++j) acc += Ai[j] * v[j];
        out[i] = acc + add[i];
    }
}

// One pivot: bounds from `src`, masked solve, set transitions, clip.
// Leaves the new iterate in s.x.
__device__ void pivot(const Smem& s, const float* src, int m, int ld,
                      int lane) {
    for (int i = lane; i < m; i += WARP) {
        float l, h;
        row_bounds(s, src, i, l, h);
        s.lo_i[i] = l;
        s.hi_i[i] = h;
        const int st = s.state[i];
        const float a = s.act[i];
        const float fm = (st == ST_FREE && a > 0.5f) ? 1.0f : 0.0f;
        float xf = (st == ST_LO) ? l : ((st == ST_HI) ? h : 0.0f);
        xf = xf * a * (1.0f - fm);
        s.fm[i] = fm;
        s.xs[i] = xf;                               // x_fixed
    }
    __syncwarp();
    // rhs = -(b + A x_fixed) * fmask
    matvec_add(s.A, ld, m, s.xs, s.b, s.r, lane);
    for (int i = lane; i < m; i += WARP) s.r[i] = -s.r[i] * s.fm[i];
    // Am = A * f f^T + diag(1 - f)
    for (int idx = lane; idx < m * m; idx += WARP) {
        const int i = idx / m, j = idx - i * m;
        float v = s.A[i * ld + j] * s.fm[i] * s.fm[j];
        if (i == j) v += 1.0f - s.fm[j];
        s.Am[i * ld + j] = v;
    }
    __syncwarp();
    // forward elimination, rows below the pivot only
    for (int k = 0; k < m - 1; ++k) {
        const float piv = s.Am[k * ld + k];
        const float rk = s.r[k];
        const float* Ak = s.Am + k * ld;
        for (int i = k + 1 + lane; i < m; i += WARP) {
            float* Ai = s.Am + i * ld;
            const float f = Ai[k] / piv;
            for (int j = k + 1; j < m; ++j) Ai[j] -= f * Ak[j];
            s.r[i] -= f * rk;
        }
        __syncwarp();
    }
    // back substitution, column oriented; x_free lands in s.w
    for (int i = m - 1; i >= 0; --i) {
        const float xi = s.r[i] / s.Am[i * ld + i];
        if (lane == 0) s.w[i] = xi;
        for (int rr = lane; rr < i; rr += WARP)
            s.r[rr] -= s.Am[rr * ld + i] * xi;
        __syncwarp();
    }
    // x_new = x_free * fmask + x_fixed
    for (int i = lane; i < m; i += WARP)
        s.xs[i] = s.w[i] * s.fm[i] + s.xs[i];
    __syncwarp();
    matvec_add(s.A, ld, m, s.xs, s.b, s.w, lane);   // w = A x_new + b
    for (int i = lane; i < m; i += WARP) {
        const float xn = s.xs[i], l = s.lo_i[i], h = s.hi_i[i];
        const bool free = s.fm[i] > 0.5f;
        int st = s.state[i];
        if (free && xn < l - 1e-12f) st = ST_LO;
        if (free && xn > h + 1e-12f) st = ST_HI;
        if (st == ST_LO && s.w[i] < -1e-10f) st = ST_FREE;
        if (st == ST_HI && s.w[i] > 1e-10f) st = ST_FREE;
        s.state[i] = st;
        s.x[i] = fminf(fmaxf(xn, l), h);
    }
    __syncwarp();
}

__global__ void __launch_bounds__(WARP)
bpp_kernel(const float* __restrict__ A_g, const float* __restrict__ b_g,
           const float* __restrict__ lo_g, const float* __restrict__ hi_g,
           const float* __restrict__ mu_g, const float* __restrict__ act_g,
           const float* __restrict__ lam0_g, const int* __restrict__ findex,
           float* __restrict__ lam_g, int m, int ld, int iters, int refine,
           int polish) {
    extern __shared__ float smem[];
    const int env = blockIdx.x;
    const int lane = threadIdx.x;
    Smem s;
    float* p = smem;
    s.A = p;  p += m * ld;
    s.Am = p; p += m * ld;
    s.b = p;  p += m;
    s.lo = p; p += m;
    s.hi = p; p += m;
    s.mu = p; p += m;
    s.act = p; p += m;
    s.x = p;  p += m;
    s.xb = p; p += m;
    s.lo_i = p; p += m;
    s.hi_i = p; p += m;
    s.xs = p; p += m;
    s.r = p;  p += m;
    s.fm = p; p += m;
    s.w = p;  p += m;
    s.state = reinterpret_cast<int*>(p);
    s.fidx = s.state + m;

    const float* Ae = A_g + (size_t)env * m * m;
    for (int idx = lane; idx < m * m; idx += WARP) {
        const int i = idx / m, j = idx - i * m;
        s.A[i * ld + j] = Ae[idx];
    }
    const size_t off = (size_t)env * m;
    for (int i = lane; i < m; i += WARP) {
        s.b[i] = b_g[off + i];
        s.lo[i] = lo_g[off + i];
        s.hi[i] = hi_g[off + i];
        s.mu[i] = mu_g[off + i];
        s.act[i] = act_g[off + i];
        s.xb[i] = lam0_g[off + i];      // raw warm start, clipped below
        s.fidx[i] = findex[i];
    }
    __syncwarp();

    // ---- initial partition from the warm start -------------------------
    for (int i = lane; i < m; i += WARP) {
        float l, h;
        row_bounds(s, s.xb, i, l, h);
        s.lo_i[i] = l;
        s.hi_i[i] = h;
    }
    __syncwarp();
    for (int i = lane; i < m; i += WARP) {
        const float l = s.lo_i[i], h = s.hi_i[i];
        const float x0 = fminf(fmaxf(s.xb[i], l), h);
        s.x[i] = x0;
        s.state[i] = (x0 >= h - 1e-12f) ? ST_HI
                     : ((x0 <= l + 1e-12f) ? ST_LO : ST_FREE);
    }
    __syncwarp();
    matvec_add(s.A, ld, m, s.x, s.b, s.w, lane);
    for (int i = lane; i < m; i += WARP) {
        int st = s.state[i];
        if (st == ST_LO && s.w[i] < 0.0f) st = ST_FREE;
        if (st == ST_HI && s.w[i] > 0.0f) st = ST_FREE;
        s.state[i] = st;
        s.xb[i] = s.x[i];
    }
    __syncwarp();

    // ---- damped pivots, then undamped refinement -----------------------
    for (int it = 0; it < iters; ++it) {
        pivot(s, s.xb, m, ld, lane);
        for (int i = lane; i < m; i += WARP)
            s.xb[i] = 0.5f * (s.xb[i] + s.x[i]);
        __syncwarp();
    }
    for (int it = 0; it < refine; ++it) {
        for (int i = lane; i < m; i += WARP) s.xb[i] = s.x[i];
        __syncwarp();
        pivot(s, s.xb, m, ld, lane);
    }

    // ---- PGS polish ----------------------------------------------------
    if (polish > 0) {
        // inv_diag in s.fm, lam in s.x
        for (int i = lane; i < m; i += WARP) {
            const float d = s.A[i * ld + i];
            s.fm[i] = (d > 1e-12f) ? 1.0f / fmaxf(d, 1e-12f) : 0.0f;
        }
        __syncwarp();
        for (int sw = 0; sw < polish; ++sw) {
            for (int i = 0; i < m; ++i) {
                float part = 0.0f;
                const float* Ai = s.A + i * ld;
                for (int j = lane; j < m; j += WARP) part += Ai[j] * s.x[j];
                for (int o = WARP / 2; o > 0; o >>= 1)
                    part += __shfl_xor_sync(FULL, part, o);
                if (lane == 0) {
                    const float w_i = part + s.b[i];
                    const float nw = s.x[i] - w_i * s.fm[i];
                    float l, h;
                    row_bounds(s, s.x, i, l, h);
                    // plain rows keep their own bounds here (no +-1e20 cap)
                    if (s.fidx[i] < 0) { l = s.lo[i]; h = s.hi[i]; }
                    s.x[i] = fminf(fmaxf(nw, l), h) * s.act[i];
                }
                __syncwarp();
            }
        }
        for (int i = lane; i < m; i += WARP) lam_g[off + i] = s.x[i];
    } else {
        for (int i = lane; i < m; i += WARP)
            lam_g[off + i] = s.x[i] * s.act[i];
    }
}

extern "C" int bpp_smem_bytes(int m) {
    const int ld = (m % 2 == 0) ? m + 1 : m;
    return (2 * m * ld + 13 * m) * (int)sizeof(float) + 2 * m * (int)sizeof(int);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int bpp_solve_launch(const float* A, const float* b,
                                const float* lo, const float* hi,
                                const float* mu, const float* act,
                                const float* lam0, const int* findex,
                                float* lam, int B, int m, int iters,
                                int refine, int polish, void* stream) {
    const int ld = (m % 2 == 0) ? m + 1 : m;
    const int bytes = bpp_smem_bytes(m);
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            bpp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return (int)e;
    }
    bpp_kernel<<<B, WARP, bytes, (cudaStream_t)stream>>>(
        A, b, lo, hi, mu, act, lam0, findex, lam, m, ld, iters, refine,
        polish);
    return (int)cudaGetLastError();
}

// Host build of the PGS kernel's per-env arithmetic (the sweeps and the
// fused residual of pgs_row.h), as a plain loop over envs, each env run as
// ONE lane that holds every row, in the order the card's lanes take them.
// Build with a C++ compiler and -ffp-contract=off (no a*b+c contraction,
// like the kernel's -fmad=false).  For tests on machines without a GPU;
// nothing on the main path calls it.
#include "pgs_row.h"

#define PG_HOST_ROWS 256

// Same arguments as pgs.cu's pgs_solve_launch (no stream); `res` may be
// null.  Returns 0, or 1 for m beyond PG_HOST_ROWS.
extern "C" int pgs_host(const float* A_g, const float* b, const float* lo,
                        const float* hi, const float* mu, const float* act,
                        const float* lam0, const int* findex, float* lam,
                        float* res, int B, int m, int iters, float omega) {
    if (m > PG_HOST_ROWS) return 1;
    static float A[PG_HOST_ROWS * PG_HOST_ROWS];
    static PgLane<PG_HOST_ROWS> s;
    for (int e = 0; e < B; ++e) {
        const float* Ae = A_g + (size_t)e * m * m;
        const size_t off = (size_t)e * m;
        for (int idx = 0; idx < m * m; ++idx) A[idx] = Ae[idx];
        for (int j = 0; j < m; ++j) {
            s.b[j] = b[off + j];
            s.lo[j] = lo[off + j];
            s.hi[j] = hi[off + j];
            s.mu[j] = mu[off + j];
            s.act[j] = act[off + j];
            s.lam[j] = lam0[off + j];
            s.invd[j] = pgs_inv_diag(A[j * m + j], omega);
        }
        for (int it = 0; it < iters; ++it)
            pg_row_sweep(s, A, m, m, findex, 0);
        if (res != nullptr) res[e] = pg_row_residual(s, A, m, m, findex, 0);
        for (int j = 0; j < m; ++j) lam[off + j] = s.lam[j];
    }
    return 0;
}

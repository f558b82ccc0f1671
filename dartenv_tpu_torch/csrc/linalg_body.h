// Small dense SPD linear algebra for one warp (or one host lane), with the
// policies of the plain PyTorch version (math/linalg.py), so that the
// escalation kernel's operator rebuild and its refinement tier compute the
// same functions as their plain versions:
//
//   la_inv_psd<N>   inv_psd: A + (eps + 1e-6 mean(diag A)) I (the float32
//                   jitter), then the recursive 2x2 Schur-complement block
//                   inverse (_inv_psd_rec), whose leaves of N <= 12 are an
//                   unrolled Cholesky, a triangular inverse and Li^T Li;
//   la_solve_psd<N> solve_psd: for N > 12 the product of la_inv_psd with
//                   the right-hand side, else Cholesky (eps on the
//                   diagonal) and two substitutions.
//
// Matrices are row-major with a leading dimension; every sum runs over its
// index in ascending order.  The items of a stage (rows of a column of the
// factor, columns of the triangular inverse, entries of a product) go over
// the lanes with LANE_FOR (pgs_row.h); a host build runs them as one lane.
// Each routine ends with the warp synchronized.  The sizes are
// compile-time, so the recursion is resolved by the compiler; `scr` is
// scratch of la_inv_scratch(N) (la_solve_scratch(N)) floats.
#pragma once

#include "pgs_row.h"

#ifdef __CUDACC__
#define LA_FN __device__
#else
#define LA_FN static
#endif

#define LA_UNROLL_MAX 12

// scratch floats of la_inv_psd_rec<N>
constexpr int la_rec_scratch(int n) {
    return n <= LA_UNROLL_MAX
               ? 2 * n * n
               : ((n + 1) / 2) * (n - (n + 1) / 2)
                     + (n - (n + 1) / 2) * (n - (n + 1) / 2)
                     + (la_rec_scratch((n + 1) / 2)
                                > la_rec_scratch(n - (n + 1) / 2)
                            ? la_rec_scratch((n + 1) / 2)
                            : la_rec_scratch(n - (n + 1) / 2));
}
// scratch floats of la_inv_psd<N> (the jittered copy, then the recursion)
constexpr int la_inv_scratch(int n) { return n * n + la_rec_scratch(n); }
// scratch floats of la_solve_psd<N>
constexpr int la_solve_scratch(int n) {
    return n > LA_UNROLL_MAX ? n * n + la_inv_scratch(n) : n * n + n;
}

// L = chol(A + eps I) of math/linalg.chol's unrolled branch: column j's
// diagonal by lane 0, then the rows below it over the lanes.  L (ldl) gets
// the lower triangle; the upper triangle is not written.
template <int N>
LA_FN void la_chol(const float* A, int lda, float* L, int ldl, float eps,
                   int lane) {
    for (int j = 0; j < N; ++j) {
        if (lane == 0) {
            float s = A[j * lda + j];
            s = s + eps;
            for (int k = 0; k < j; ++k)
                s = s - L[j * ldl + k] * L[j * ldl + k];
            L[j * ldl + j] = sqrtf(fmaxf(s, 1e-30f));
        }
        LANE_SYNC();
        LANE_FOR(i, j + 1, N) {
            float s = A[i * lda + j];
            for (int k = 0; k < j; ++k)
                s = s - L[i * ldl + k] * L[j * ldl + k];
            L[i * ldl + j] = s / L[j * ldl + j];
        }
        LANE_SYNC();
    }
}

// _inv_psd_rec of A (N x N, lda) into out (ldo), no jitter.
template <int N>
LA_FN void la_inv_psd_rec(const float* A, int lda, float* out, int ldo,
                          float* scr, int lane) {
    if constexpr (N <= LA_UNROLL_MAX) {
        float* L = scr;            // N x N
        float* X = scr + N * N;    // Li = L^-1, N x N (lower)
        la_chol<N>(A, lda, L, N, 0.0f, lane);
        // _tri_inv_unrolled, lanes over columns
        LANE_FOR(j, 0, N) {
            for (int i = 0; i < j; ++i) X[i * N + j] = 0.0f;
            X[j * N + j] = 1.0f / L[j * N + j];
            for (int i = j + 1; i < N; ++i) {
                float s = L[i * N + j] * X[j * N + j];
                for (int k = j + 1; k < i; ++k) s = s + L[i * N + k] * X[k * N + j];
                X[i * N + j] = -s / L[i * N + i];
            }
        }
        LANE_SYNC();
        // Li^T Li
        LANE_FOR(t, 0, N * N) {
            const int a = t / N, b = t - a * N;
            float s = 0.0f;
            for (int k = 0; k < N; ++k) s += X[k * N + a] * X[k * N + b];
            out[a * ldo + b] = s;
        }
        LANE_SYNC();
    } else {
        constexpr int K = (N + 1) / 2, N2 = N - K;
        float* U = scr;                 // K x N2: i11 A12
        float* S = U + K * N2;          // N2 x N2: A22 - A12^T U
        float* child = S + N2 * N2;
        float* i11 = out;               // out[:K, :K]
        float* i22 = out + K * ldo + K; // out[K:, K:]
        la_inv_psd_rec<K>(A, lda, i11, ldo, child, lane);
        LANE_FOR(t, 0, K * N2) {
            const int i = t / N2, j = t - i * N2;
            float s = 0.0f;
            for (int l = 0; l < K; ++l)
                s += i11[i * ldo + l] * A[l * lda + K + j];
            U[t] = s;
        }
        LANE_SYNC();
        LANE_FOR(t, 0, N2 * N2) {
            const int i = t / N2, j = t - i * N2;
            float s = 0.0f;
            for (int l = 0; l < K; ++l) s += A[l * lda + K + i] * U[l * N2 + j];
            S[t] = A[(K + i) * lda + K + j] - s;
        }
        LANE_SYNC();
        la_inv_psd_rec<N2>(S, N2, i22, ldo, child, lane);
        // B12 = -U i22 into out[:K, K:] and its transpose into out[K:, :K]
        LANE_FOR(t, 0, K * N2) {
            const int i = t / N2, j = t - i * N2;
            float s = 0.0f;
            for (int l = 0; l < N2; ++l) s += U[i * N2 + l] * i22[l * ldo + j];
            out[i * ldo + K + j] = -s;
            out[(K + j) * ldo + i] = -s;
        }
        LANE_SYNC();
        // B11 = i11 - B12 U^T, in place (each entry reads only its own i11)
        LANE_FOR(t, 0, K * K) {
            const int i = t / K, j = t - i * K;
            float s = 0.0f;
            for (int l = 0; l < N2; ++l)
                s += out[i * ldo + K + l] * U[j * N2 + l];
            out[i * ldo + j] = out[i * ldo + j] - s;
        }
        LANE_SYNC();
    }
}

// inv_psd(A, eps) of a float32 A: the jitter eps + 1e-6 mean(diag A) on
// the diagonal, then _inv_psd_rec.  out (ldo) may not alias A.
template <int N>
LA_FN void la_inv_psd(const float* A, int lda, float* out, int ldo,
                      float* scr, float eps, int lane) {
    float* Aj = scr;                    // N x N: the jittered copy
    float d = 0.0f;
    for (int i = 0; i < N; ++i) d += A[i * lda + i];
    const float jit = 1e-6f * (d / (float)N) + eps;
    LANE_FOR(t, 0, N * N) {
        const int i = t / N, j = t - i * N;
        Aj[t] = A[i * lda + j] + (i == j ? jit : 0.0f);
    }
    LANE_SYNC();
    la_inv_psd_rec<N>(Aj, N, out, ldo, scr + N * N, lane);
}

// x = solve_psd(A, r, eps) (A N x N with lda; r, x: N floats; x may not
// alias r).
template <int N>
LA_FN void la_solve_psd(const float* A, int lda, const float* r, float* x,
                        float* scr, float eps, int lane) {
    if constexpr (N > LA_UNROLL_MAX) {
        float* Ai = scr;                // N x N
        la_inv_psd<N>(A, lda, Ai, N, scr + N * N, eps, lane);
        LANE_FOR(i, 0, N) {
            float s = 0.0f;
            for (int j = 0; j < N; ++j) s += Ai[i * N + j] * r[j];
            x[i] = s;
        }
        LANE_SYNC();
    } else {
        float* L = scr;                 // N x N
        float* y = scr + N * N;         // N
        la_chol<N>(A, lda, L, N, eps, lane);
        if (lane == 0) {
            for (int i = 0; i < N; ++i) {
                float s = r[i];
                for (int k = 0; k < i; ++k) s = s - L[i * N + k] * y[k];
                y[i] = s / L[i * N + i];
            }
            for (int i = N - 1; i >= 0; --i) {
                float s = y[i];
                for (int k = i + 1; k < N; ++k) s = s - L[k * N + i] * x[k];
                x[i] = s / L[i * N + i];
            }
        }
        LANE_SYNC();
    }
}

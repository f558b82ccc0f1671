// Per-env smooth dynamics, shared by the dynamics kernel (dynamics.cu), the
// fused substep kernel (substep_body.h) and their host builds
// (dynamics_host.cpp, substep_host.cpp): joint kinematics of all ten joint
// types -> tree recursion -> world dof columns phi -> mass matrix -> bias
// forces -> implicit spring/damping forward solve (Cholesky), on one
// thread (dyn_stage, the fused substep kernel's) or on a group of lanes
// (dyn_group, the dynamics kernel's).  This is the per-env body _trace_env
// of dartenv_tpu/dynamics/pallas_dynamics.py.
//
// The includer first includes a header generated from the model's static
// digest (dartenv_tpu_torch/dynamics/hopper_dynamics.dynamics_header): the
// sizes DY_N, DY_NB, DY_MAXDOF, the step DY_DT, the mask DY_JMASK of joint
// types present (bit t set for type t; branches of absent types are
// removed at compile time), the lane group DY_G and the item counts of
// its stages, and the model tables as DY_CONST arrays (__constant__ under
// nvcc, static const in a host build).
#pragma once

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#define DI __device__ __forceinline__
#define SS_FN __device__
#else
#define DI static inline
#define SS_FN static
#endif

#define JT_WELD 0
#define JT_REVOLUTE 1
#define JT_PRISMATIC 2
#define JT_UNIVERSAL 3
#define JT_EULER 4
#define JT_BALL 5
#define JT_TRANSLATIONAL 6
#define JT_PLANAR 7
#define JT_FREE 8
#define JT_SCREW 9
#define DY_HAS(t) (((DY_JMASK) >> (t)) & 1)

// Stage stamps (dynamics.cu with DY_STAMPS); nothing in another build.
#ifndef DY_STAMP
#define DY_STAMP_DECL
#define DY_STAMP_RESTART
#define DY_STAMP(k) ((void)0)
#endif

// Lane-group loops of dyn_group: on the card an env runs on DY_G lanes
// (gl = 0..DY_G-1; a lane with gl >= DY_G takes no item) and
// `GL_FOR(i, lo, hi)` spreads a loop's items over them; GL_SYNC() is
// __syncwarp() (every lane of the warp calls it: the groups of a warp run
// the same stages).  A host build runs one lane that takes every item in
// order.
#ifdef __CUDACC__
#define GL_FOR(i, lo, hi) \
    for (int i = (lo) + gl; gl < DY_G && i < (hi); i += DY_G)
#define GL_SYNC() __syncwarp()
#else
#define GL_FOR(i, lo, hi) for (int i = (lo); i < (hi); ++i)
#define GL_SYNC() ((void)0)
#endif


// ---- per-env domain-randomized leaves --------------------------------------
// A leaf named in the generated header's DR layout (DR_HAS_<LEAF>, at float
// offset DR_O_<LEAF> of the env's block of DR_F floats, flattened row-major
// as the model array) is read from that block, `dr`; any other leaf from its
// DY_CONST table.  The functions below take `dr` (unused without a DR
// layout, which then compiles to the same code as before the layout
// existed).  The JAX kernel's DR_FIELDS_DYN: mass, com, inertia, damping,
// spring_stiff, rest_pos, gravity.
#ifndef DR_F
#define DR_F 0
#define DR_NF 0
#endif
#if DR_F
// the DR leaves' arrays of a launch: one (B, c_dr_w[f]) float32 array per
// leaf, in the order of the generated c_dr_w / c_dr_o tables
struct DrInputs {
    const float* p[DR_NF];
};
#ifdef __CUDACC__
// The block's threads copy the DR blocks of envs e0 .. e0 + nenv - 1 into
// dst + k * stride (env e0 + k), each leaf's rows read as one coalesced
// run; an env k >= nv (past the batch) takes env e0 + nv - 1's values.
__device__ __forceinline__ void dr_load_block(const DrInputs& in, float* dst,
                                              int stride, int nenv, int e0,
                                              int nv) {
#pragma unroll
    for (int f = 0; f < DR_NF; ++f) {
        const int w = c_dr_w[f], o = c_dr_o[f];
        const float* src = in.p[f] + (size_t)e0 * w;
        for (int i = threadIdx.x; i < nenv * w; i += blockDim.x) {
            const int k = i / w, j = i - k * w;
            dst[k * stride + o + j] = src[(k < nv ? k : nv - 1) * w + j];
        }
    }
}
#else
// A host build's copy of env e's DR block into dst.
static inline void dr_load_env(const float* const* in, float* dst, int e) {
    for (int f = 0; f < DR_NF; ++f)
        for (int j = 0; j < c_dr_w[f]; ++j)
            dst[c_dr_o[f] + j] = in[f][(size_t)e * c_dr_w[f] + j];
}
#endif
#endif
#ifdef DR_HAS_MASS
#define DY_MASS(b) dr[DR_O_MASS + (b)]
#else
#define DY_MASS(b) c_mass[b]
#endif
#ifdef DR_HAS_COM
#define DY_COM(b) (&dr[DR_O_COM + 3 * (b)])
#else
#define DY_COM(b) (&c_com[3 * (b)])
#endif
#ifdef DR_HAS_INERTIA
#define DY_INERTIA(b) (&dr[DR_O_INERTIA + 9 * (b)])
#else
#define DY_INERTIA(b) (&c_inertia[9 * (b)])
#endif
#ifdef DR_HAS_DAMPING
#define DY_DAMP(d) dr[DR_O_DAMPING + (d)]
#else
#define DY_DAMP(d) c_damping[d]
#endif
#ifdef DR_HAS_SPRING_STIFF
#define DY_SPRING(d) dr[DR_O_SPRING_STIFF + (d)]
#else
#define DY_SPRING(d) c_spring[d]
#endif
#ifdef DR_HAS_REST_POS
#define DY_REST(d) dr[DR_O_REST_POS + (d)]
#else
#define DY_REST(d) c_rest[d]
#endif
#ifdef DR_HAS_GRAVITY
#define DY_GRAV(k) dr[DR_O_GRAVITY + (k)]
#else
#define DY_GRAV(k) c_gravity[k]
#endif

DI float dot3(const float* a, const float* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
DI void cross3(const float* a, const float* b, float* o) {
    const float x = a[1] * b[2] - a[2] * b[1];
    const float y = a[2] * b[0] - a[0] * b[2];
    const float z = a[0] * b[1] - a[1] * b[0];
    o[0] = x; o[1] = y; o[2] = z;
}
DI void m3v(const float* M, const float* v, float* o) {
    const float x = M[0] * v[0] + M[1] * v[1] + M[2] * v[2];
    const float y = M[3] * v[0] + M[4] * v[1] + M[5] * v[2];
    const float z = M[6] * v[0] + M[7] * v[1] + M[8] * v[2];
    o[0] = x; o[1] = y; o[2] = z;
}
DI void m3tv(const float* M, const float* v, float* o) {   // M^T v
    const float x = M[0] * v[0] + M[3] * v[1] + M[6] * v[2];
    const float y = M[1] * v[0] + M[4] * v[1] + M[7] * v[2];
    const float z = M[2] * v[0] + M[5] * v[1] + M[8] * v[2];
    o[0] = x; o[1] = y; o[2] = z;
}
DI void m3m(const float* A, const float* B, float* C) {    // C != A, B
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j]
                           + A[3 * i + 2] * B[6 + j];
}
DI void m3mt(const float* A, const float* B, float* C) {   // C = A B^T
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            C[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1]
                           + A[3 * i + 2] * B[3 * j + 2];
}

// Rodrigues for a unit axis u: R = I + s K + (1 - c) K^2, K = skew(u)
DI void rod_axis(const float* u, float s, float c, float* R) {
    const float K[9] = {0.0f, -u[2], u[1], u[2], 0.0f, -u[0],
                        -u[1], u[0], 0.0f};
    float K2[9];
    m3m(K, K, K2);
    const float omc = 1.0f - c;
    for (int i = 0; i < 9; ++i)
        R[i] = ((i % 4 == 0) ? 1.0f : 0.0f) + K[i] * s + K2[i] * omc;
}
// rod(u, theta) a = c a + s (u x a) + (1 - c) (u.a) u
DI void rot_vec(const float* u, const float* a, float s, float c, float* o) {
    float w[3];
    cross3(u, a, w);
    const float d = dot3(u, a);
    for (int k = 0; k < 3; ++k)
        o[k] = c * a[k] + s * w[k] + (1.0f - c) * (d * u[k]);
}
// d/dt of rot_vec at theta(t): thdot (-s a + c (u x a) + s (u.a) u)
DI void rot_vec_dot(const float* u, const float* a, float s, float c,
                    float thdot, float* o) {
    float w[3];
    cross3(u, a, w);
    const float d = dot3(u, a);
    for (int k = 0; k < 3; ++k)
        o[k] = thdot * (-s * a[k] + c * w[k] + s * (d * u[k]));
}
// Rodrigues for a run-time rotation vector w (BALL, FREE), Taylor-safe at
// 0, as math/spatial.so3_exp: R = I + a K + b K^2, K = skew(w)
DI void so3_exp_rt(const float* w, float* R) {
    const float t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const float th = sqrtf(t2 + 1e-18f);
    const bool small = t2 < 1e-12f;
    const float a = small ? 1.0f - t2 / 6.0f : sinf(th) / th;
    const float bq = small ? 0.5f - t2 / 24.0f : (1.0f - cosf(th)) / t2;
    const float K[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0],
                        -w[1], w[0], 0.0f};
    float K2[9];
    m3m(K, K, K2);
    for (int i = 0; i < 9; ++i)
        R[i] = ((i % 4 == 0) ? 1.0f : 0.0f) + a * K[i] + bq * K2[i];
}
// [E,0; -E r^, E] v with E = R^T (R given)
DI void xmotion_Rt(const float* R, const float* r, const float* v6,
                   float* o6) {
    float t[3], u[3];
    m3tv(R, v6, o6);
    cross3(r, v6, t);
    for (int k = 0; k < 3; ++k) u[k] = v6[3 + k] - t[k];
    m3tv(R, u, o6 + 3);
}
DI void crm6(const float* v, const float* m, float* o) {
    float a[3], b[3];
    cross3(v, m, o);
    cross3(v, m + 3, a);
    cross3(v + 3, m, b);
    for (int k = 0; k < 3; ++k) o[3 + k] = a[k] + b[k];
}
DI void crf6(const float* v, const float* f, float* o) {
    float a[3], b[3];
    cross3(v, f, a);
    cross3(v + 3, f + 3, b);
    for (int k = 0; k < 3; ++k) o[k] = a[k] + b[k];
    cross3(v, f + 3, o + 3);
}
// Ad_{T_cj}: joint-frame S row -> child-body frame
DI void ad_cj(int b, const float* row6, float* o6) {
    float t[3];
    m3v(&c_cj_rot[9 * b], row6, o6);
    m3v(&c_cj_rot[9 * b], row6 + 3, o6 + 3);
    cross3(&c_cj_pos[3 * b], o6, t);
    for (int k = 0; k < 3; ++k) o6[3 + k] += t[k];
}
// body-frame spatial inertia times motion vector (structural form)
DI void inertia_mul(const float* dr, int b, const float* v6, float* o6) {
    (void)dr;
    const float m_b = DY_MASS(b);
    const float* c = DY_COM(b);
    float Icw[3], cxw[3], d[3], t[3];
    m3v(DY_INERTIA(b), v6, Icw);
    cross3(c, v6, cxw);
    for (int k = 0; k < 3; ++k) d[k] = v6[3 + k] - cxw[k];
    cross3(c, d, t);
    for (int k = 0; k < 3; ++k) {
        o6[k] = Icw[k] + t[k] * m_b;
        o6[3 + k] = d[k] * m_b;
    }
}

// unrolled-recurrence Cholesky of A + eps I (lower L), guards as
// math/linalg.chol: sqrt(max(s, 1e-30))
DI void chol_n(const float* A, float* L) {
#pragma unroll 1
    for (int i = 0; i < DY_N; ++i) {
        for (int j = 0; j <= i; ++j) {
            float s = A[i * DY_N + j];
            if (j == i) s += 1e-10f;
            for (int k = 0; k < j; ++k) s -= L[i * DY_N + k] * L[j * DY_N + k];
            L[i * DY_N + j] = (i == j) ? sqrtf(fmaxf(s, 1e-30f))
                                       : s / L[j * DY_N + j];
        }
    }
}
// Forward and back substitution with a Cholesky factor L (lower, of
// chol_n or chol_group): x = L^-T L^-1 rhs, on one lane; the loops unroll and the
// intermediates stay in registers.
DI void chol_solve_n(const float* L, const float* rhs, float* x) {
    float y[DY_N], xl[DY_N];
#pragma unroll
    for (int i = 0; i < DY_N; ++i) {
        float s = rhs[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s -= L[i * DY_N + k] * y[k];
        y[i] = s / L[i * DY_N + i];
    }
#pragma unroll
    for (int i = DY_N - 1; i >= 0; --i) {
        float s = y[i];
#pragma unroll
        for (int k = i + 1; k < DY_N; ++k) s -= L[k * DY_N + i] * xl[k];
        xl[i] = s / L[i * DY_N + i];
    }
#pragma unroll
    for (int i = 0; i < DY_N; ++i) x[i] = xl[i];
}

// Cholesky factor L (lower) of A + 1e-10 I, guards as math/linalg.chol
// (sqrt(max(s, 1e-30))): a column at a time, the column's rows over the
// group's lanes, every entry's operations in the order of the row-by-row
// recurrence  s = A_ij (+ 1e-10 on the diagonal) - sum_{k<j} L_ik L_jk
// (k in order);  L_jj = sqrt(max(s, 1e-30)), L_ij = s / L_jj.  Every lane
// computes the column's diagonal for itself (the same operations).
DI void chol_group(int gl, const float* A, float* L) {
    for (int j = 0; j < DY_N; ++j) {
        float sd = A[j * DY_N + j] + 1e-10f;
        for (int k = 0; k < j; ++k) sd -= L[j * DY_N + k] * L[j * DY_N + k];
        const float ljj = sqrtf(fmaxf(sd, 1e-30f));
        GL_FOR(i, j, DY_N) {
            float s = ljj;
            if (i > j) {
                s = A[i * DY_N + j];
                for (int k = 0; k < j; ++k)
                    s -= L[i * DY_N + k] * L[j * DY_N + k];
                s = s / ljj;
            }
            L[i * DY_N + j] = s;
        }
        GL_SYNC();
    }
}

// Joint b's transform (Rj, pj) and its S / S-dot rows in the JOINT frame
// (dynamics/batched.joint_transforms / joint_S, S-dot written out).  Sj and
// Sdj come in zeroed, Rj as the identity and pj as zero.
DI void joint_kin(int b, const float* q, const float* dq, float* Rj,
                  float* pj, float (*Sj)[6], float (*Sdj)[6]) {
    const int t = c_jt[b], qs = c_qstart[b];
    const float* ax = &c_axes[9 * b];      // raw axes rows
    const float* axu = &c_axes_unit[9 * b];
    const float* nrm = &c_axes_norm[3 * b];
    if (t == JT_REVOLUTE) {
        const float th = nrm[0] * q[qs];
        rod_axis(axu, sinf(th), cosf(th), Rj);
        for (int k = 0; k < 3; ++k) Sj[0][k] = ax[k];
    } else if (t == JT_PRISMATIC) {
        for (int k = 0; k < 3; ++k) {
            pj[k] = ax[k] * q[qs];
            Sj[0][3 + k] = ax[k];
        }
    } else if (t == JT_PLANAR) {
        const float th = nrm[2] * q[qs + 2];
        const float r2 = nrm[2] * dq[qs + 2];
        const float s = sinf(th), c = cosf(th);
        rod_axis(axu + 6, s, c, Rj);
        for (int k = 0; k < 3; ++k)
            pj[k] = ax[k] * q[qs] + ax[3 + k] * q[qs + 1];
        // S = [0, R^T a0], [0, R^T a1], [a2, 0]
        rot_vec(axu + 6, ax, -s, c, &Sj[0][3]);
        rot_vec(axu + 6, ax + 3, -s, c, &Sj[1][3]);
        rot_vec_dot(axu + 6, ax, -s, c, -r2, &Sdj[0][3]);
        rot_vec_dot(axu + 6, ax + 3, -s, c, -r2, &Sdj[1][3]);
        for (int k = 0; k < 3; ++k) Sj[2][k] = ax[6 + k];
    } else if (DY_HAS(JT_SCREW) && t == JT_SCREW) {
        // rotation about a0, translation a1 * q (a1 = pitch / 2 pi * axis)
        const float th = nrm[0] * q[qs];
        rod_axis(axu, sinf(th), cosf(th), Rj);
        for (int k = 0; k < 3; ++k) {
            pj[k] = ax[3 + k] * q[qs];
            Sj[0][k] = ax[k];
            Sj[0][3 + k] = ax[3 + k];
        }
    } else if (DY_HAS(JT_UNIVERSAL) && t == JT_UNIVERSAL) {
        // R = rod(a0, q0) rod(a1, q1); S = [R2^T a0, 0], [a1, 0]
        const float th0 = nrm[0] * q[qs];
        const float th1 = nrm[1] * q[qs + 1];
        const float r1 = nrm[1] * dq[qs + 1];
        const float s1 = sinf(th1), c1 = cosf(th1);
        float R0[9], R1[9];
        rod_axis(axu, sinf(th0), cosf(th0), R0);
        rod_axis(axu + 3, s1, c1, R1);
        m3m(R0, R1, Rj);
        rot_vec(axu + 3, ax, -s1, c1, Sj[0]);
        rot_vec_dot(axu + 3, ax, -s1, c1, -r1, Sdj[0]);
        for (int k = 0; k < 3; ++k) Sj[1][k] = ax[3 + k];
    } else if (DY_HAS(JT_EULER) && t == JT_EULER) {
        // R = rod(a0, q0) (rod(a1, q1) rod(a2, q2));
        // S = [R3^T R2^T a0, 0], [R3^T a1, 0], [a2, 0]
        const float th0 = nrm[0] * q[qs];
        const float th1 = nrm[1] * q[qs + 1];
        const float th2 = nrm[2] * q[qs + 2];
        const float r1 = nrm[1] * dq[qs + 1];
        const float r2 = nrm[2] * dq[qs + 2];
        const float s1 = sinf(th1), c1 = cosf(th1);
        const float s2 = sinf(th2), c2 = cosf(th2);
        float R0[9], R1[9], R2[9], R12[9];
        rod_axis(axu, sinf(th0), cosf(th0), R0);
        rod_axis(axu + 3, s1, c1, R1);
        rod_axis(axu + 6, s2, c2, R2);
        m3m(R1, R2, R12);
        m3m(R0, R12, Rj);
        float g[3], gd[3], hd[3], t3[3];
        rot_vec(axu + 3, ax, -s1, c1, g);                // R2^T a0
        rot_vec_dot(axu + 3, ax, -s1, c1, -r1, gd);
        rot_vec(axu + 6, g, -s2, c2, Sj[0]);             // h = R3^T g
        // h-dot = R3^T g-dot + q2dot (-u2 x h)
        rot_vec(axu + 6, gd, -s2, c2, hd);
        const float nu2[3] = {-axu[6], -axu[7], -axu[8]};
        cross3(nu2, Sj[0], t3);
        for (int k = 0; k < 3; ++k) Sdj[0][k] = hd[k] + t3[k] * r2;
        rot_vec(axu + 6, ax + 3, -s2, c2, Sj[1]);        // R3^T a1
        rot_vec_dot(axu + 6, ax + 3, -s2, c2, -r2, Sdj[1]);
        for (int k = 0; k < 3; ++k) Sj[2][k] = ax[6 + k];
    } else if (DY_HAS(JT_BALL) && t == JT_BALL) {
        so3_exp_rt(&q[qs], Rj);
        for (int k = 0; k < 3; ++k) Sj[k][k] = 1.0f;
    } else if (DY_HAS(JT_TRANSLATIONAL) && t == JT_TRANSLATIONAL) {
        for (int k = 0; k < 3; ++k) {
            pj[k] = q[qs + k];
            Sj[k][3 + k] = 1.0f;
        }
    } else if (DY_HAS(JT_FREE) && t == JT_FREE) {
        so3_exp_rt(&q[qs], Rj);
        for (int k = 0; k < 3; ++k) pj[k] = q[qs + 3 + k];
        for (int k = 0; k < 6; ++k) Sj[k][k] = 1.0f;
    }
}

// ---- the dynamics stage on one thread ------------------------------------
// The dynamics stage of one env on ONE thread (the fused substep kernel
// runs the envs of a block on the lanes of a warp, one env per lane):
// (q, dq, tau) -> world poses R_w / p_w, world dof columns phi, mass
// matrix M (full, symmetric), dq_star, and the Cholesky factor L of M +
// diag(dt d + dt^2 k).
DI void dyn_stage(const float* q, const float* dq, const float* tau,
                  float (*R_w)[9], float (*p_w)[3], float (*phi)[6],
                  float* M, float* dq_star, float* L, const float* dr) {
    (void)dr;
    // ---- joint kinematics + tree recursion ------------------------------
    float vel[DY_NB][6], ab[DY_NB][6];
    float S[DY_N][6], Sd[DY_N][6];
    const float a_base[6] = {0.0f, 0.0f, 0.0f, -DY_GRAV(0), -DY_GRAV(1),
                             -DY_GRAV(2)};
#pragma unroll 1
    for (int b = 0; b < DY_NB; ++b) {
        float Rj[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
        float pj[3] = {0, 0, 0};
        float Sj[DY_MAXDOF][6], Sdj[DY_MAXDOF][6];
        for (int k = 0; k < DY_MAXDOF; ++k)
            for (int c = 0; c < 6; ++c) { Sj[k][c] = 0.0f; Sdj[k][c] = 0.0f; }
        const int qs = c_qstart[b], nd = c_ndof[b];
        joint_kin(b, q, dq, Rj, pj, Sj, Sdj);
        // T_rel = T_pj o T_joint o inv(T_cj)
        float R1[9], p1[3], R_rel[9], p_rel[3], t3[3];
        m3m(&c_pj_rot[9 * b], Rj, R1);
        m3v(&c_pj_rot[9 * b], pj, t3);
        for (int k = 0; k < 3; ++k) p1[k] = c_pj_pos[3 * b + k] + t3[k];
        m3m(R1, &c_cji_rot[9 * b], R_rel);
        m3v(R1, &c_cji_pos[3 * b], t3);
        for (int k = 0; k < 3; ++k) p_rel[k] = p1[k] + t3[k];

        float vJ[6] = {0, 0, 0, 0, 0, 0}, cJ[6] = {0, 0, 0, 0, 0, 0};
        for (int k = 0; k < nd; ++k) {
            const int d = qs + k;
            ad_cj(b, Sj[k], S[d]);
            ad_cj(b, Sdj[k], Sd[d]);
            for (int c = 0; c < 6; ++c) {
                vJ[c] += S[d][c] * dq[d];
                cJ[c] += Sd[d][c] * dq[d];
            }
        }
        const int par = c_parent[b];
        float xa[6], cr[6];
        if (par < 0) {
            for (int k = 0; k < 9; ++k) R_w[b][k] = R_rel[k];
            for (int k = 0; k < 3; ++k) p_w[b][k] = p_rel[k];
            for (int c = 0; c < 6; ++c) vel[b][c] = vJ[c];
            xmotion_Rt(R_rel, p_rel, a_base, xa);
        } else {
            m3m(R_w[par], R_rel, R_w[b]);
            m3v(R_w[par], p_rel, t3);
            for (int k = 0; k < 3; ++k) p_w[b][k] = p_w[par][k] + t3[k];
            float xv[6];
            xmotion_Rt(R_rel, p_rel, vel[par], xv);
            for (int c = 0; c < 6; ++c) vel[b][c] = xv[c] + vJ[c];
            xmotion_Rt(R_rel, p_rel, ab[par], xa);
        }
        crm6(vel[b], vJ, cr);
        for (int c = 0; c < 6; ++c) ab[b][c] = xa[c] + (cr[c] + cJ[c]);
    }

    // ---- world-frame dof columns at the world origin --------------------
    for (int d = 0; d < DY_N; ++d) {
        const int b = c_dof_body[d];
        float t3[3];
        m3v(R_w[b], S[d], phi[d]);
        m3v(R_w[b], &S[d][3], &phi[d][3]);
        cross3(p_w[b], phi[d], t3);
        for (int k = 0; k < 3; ++k) phi[d][3 + k] += t3[k];
    }

    // ---- mass matrix: M[i][j] = sum_b phi_i . (I_w(b) phi_j) ------------
    for (int i = 0; i < DY_N * DY_N; ++i) M[i] = 0.0f;
#pragma unroll 1
    for (int b = 0; b < DY_NB; ++b) {
        const float m_b = DY_MASS(b);
        float d_w[3], IcR[9], Ic_w[9], t3[3];
        m3v(R_w[b], DY_COM(b), t3);
        for (int k = 0; k < 3; ++k) d_w[k] = p_w[b][k] + t3[k];
        m3m(R_w[b], DY_INERTIA(b), IcR);
        m3mt(IcR, R_w[b], Ic_w);
        float F[DY_N][6];
        for (int j = 0; j < DY_N; ++j) {
            if (!c_anc[b * DY_N + j]) continue;
            float u[3], a3[3], c3[3];
            cross3(d_w, phi[j], t3);
            for (int k = 0; k < 3; ++k) u[k] = phi[j][3 + k] - t3[k];
            m3v(Ic_w, phi[j], a3);
            cross3(d_w, u, c3);
            for (int k = 0; k < 3; ++k) {
                F[j][k] = a3[k] + c3[k] * m_b;
                F[j][3 + k] = u[k] * m_b;
            }
            for (int i = 0; i <= j; ++i) {
                if (!c_anc[b * DY_N + i]) continue;
                float acc = 0.0f;
                for (int c = 0; c < 6; ++c) acc += phi[i][c] * F[j][c];
                M[i * DY_N + j] += acc;
            }
        }
    }
    for (int i = 0; i < DY_N; ++i)
        for (int j = 0; j < i; ++j) M[i * DY_N + j] = M[j * DY_N + i];

    // ---- bias forces ----------------------------------------------------
    float f_sub[DY_NB][6];
    for (int b = 0; b < DY_NB; ++b) {
        float Ia[6], Iv[6], cf[6], fb[6], t3[3];
        inertia_mul(dr, b, ab[b], Ia);
        inertia_mul(dr, b, vel[b], Iv);
        crf6(vel[b], Iv, cf);
        for (int c = 0; c < 6; ++c) fb[c] = Ia[c] + cf[c];
        // inverse force transform (E = R_w^T, r = p_w)
        m3v(R_w[b], fb + 3, &f_sub[b][3]);
        m3v(R_w[b], fb, f_sub[b]);
        cross3(p_w[b], &f_sub[b][3], t3);
        for (int k = 0; k < 3; ++k) f_sub[b][k] += t3[k];
    }
    for (int b = DY_NB - 1; b > 0; --b) {
        const int par = c_parent[b];
        if (par >= 0)
            for (int c = 0; c < 6; ++c) f_sub[par][c] += f_sub[b][c];
    }

    // ---- implicit-scheme forward dynamics -------------------------------
    float rhs[DY_N], Mi[DY_N * DY_N], ddq[DY_N];
    for (int i = 0; i < DY_N * DY_N; ++i) Mi[i] = M[i];
    for (int d = 0; d < DY_N; ++d) {
        const int b = c_dof_body[d];
        float Cd = 0.0f;
        for (int c = 0; c < 6; ++c) Cd += phi[d][c] * f_sub[b][c];
        float td = tau[d] - Cd;
        td -= DY_DAMP(d) * dq[d];
        td -= DY_SPRING(d) * ((q[d] - DY_REST(d)) + DY_DT * dq[d]);
        rhs[d] = td;
        Mi[d * DY_N + d] += DY_DT * DY_DAMP(d)
                            + (DY_DT * DY_DT) * DY_SPRING(d);
    }
    chol_n(Mi, L);
    chol_solve_n(L, rhs, ddq);
    for (int d = 0; d < DY_N; ++d) dq_star[d] = dq[d] + DY_DT * ddq[d];
}

// ---- the dynamics stage on a group of lanes ------------------------------
// The dynamics stage of one env on a group of lanes (the dynamics kernel):
// dyn_stage's outputs with dyn_stage's arithmetic, entry by entry and in
// the same order (so the two agree to the bit), with the independent
// items over the group's lanes: one body per lane
// for the joint kinematics, T_rel, the S / S-dot rows and vJ / cJ; the
// world composition (R_w, p_w, vel, ab) one tree level at a time (the
// levels are a table of the generated header); one dof per lane for phi;
// one body per lane for Ic_w and d_w, one (body, dof) per lane for the F
// columns; the M entries (i <= j) over lanes, each summing over bodies
// b = 0..nb-1 in order; one body per lane for the bias forces.  The
// backward accumulation of f_sub (a parent with two children adds them in
// index order) and the triangular solves stay on lane 0; the Cholesky
// takes a column at a time, its rows over the lanes (chol_group).  The working
// set is `scr` (DY_SCRATCH floats, shared memory on the card).
#define DY_O_S 0                             // S rows, 6 per dof
#define DY_O_VEL (DY_O_S + 6 * DY_N)
#define DY_O_AB (DY_O_VEL + 6 * DY_NB)
#define DY_O_FSUB (DY_O_AB + 6 * DY_NB)
#define DY_O_MI (DY_O_FSUB + 6 * DY_NB)
#define DY_O_RHS (DY_O_MI + DY_N * DY_N)
#define DY_O_U (DY_O_RHS + DY_N)             // two phases share this
#define DY_O_RREL DY_O_U                     // kinematics + composition
#define DY_O_PREL (DY_O_RREL + 9 * DY_NB)
#define DY_O_VJ (DY_O_PREL + 3 * DY_NB)
#define DY_O_CJ (DY_O_VJ + 6 * DY_NB)
#define DY_U_A (24 * DY_NB)
#define DY_O_F DY_O_U                        // mass matrix
#define DY_O_ICW (DY_O_F + 6 * DY_NB * DY_N)
#define DY_O_DW (DY_O_ICW + 9 * DY_NB)
#define DY_U_B (6 * DY_NB * DY_N + 12 * DY_NB)
#define DY_SCRATCH (DY_O_U + (DY_U_A > DY_U_B ? DY_U_A : DY_U_B))

// q, dq, tau in; world poses R_w (9 per body) / p_w (3 per body), world dof
// columns phi (6 per dof), mass matrix M (full), dq_star and the Cholesky
// factor L of M + diag(dt d + dt^2 k) out (written by lane 0 or by the
// lanes; visible to the group after its last GL_SYNC).
DI void dyn_group(int gl, const float* q, const float* dq, const float* tau,
                  float* R_w, float* p_w, float* phi, float* M,
                  float* dq_star, float* L, float* scr,
                  const float* dr) {
    (void)dr;
    float* S = scr + DY_O_S;
    float* vel = scr + DY_O_VEL;
    float* ab = scr + DY_O_AB;
    float* f_sub = scr + DY_O_FSUB;
    float* Mi = scr + DY_O_MI;
    float* rhs = scr + DY_O_RHS;
    float* R_rel = scr + DY_O_RREL;
    float* p_rel = scr + DY_O_PREL;
    float* vJ = scr + DY_O_VJ;
    float* cJ = scr + DY_O_CJ;
    float* F = scr + DY_O_F;
    float* Ic_w = scr + DY_O_ICW;
    float* d_w = scr + DY_O_DW;
    DY_STAMP_DECL

    // ---- joint kinematics: one body per lane ----------------------------
    GL_FOR(b, 0, DY_NB) {
        float Rj[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
        float pj[3] = {0, 0, 0};
        float Sj[DY_MAXDOF][6], Sdj[DY_MAXDOF][6];
        for (int k = 0; k < DY_MAXDOF; ++k)
            for (int c = 0; c < 6; ++c) { Sj[k][c] = 0.0f; Sdj[k][c] = 0.0f; }
        const int qs = c_qstart[b], nd = c_ndof[b];
        joint_kin(b, q, dq, Rj, pj, Sj, Sdj);
        // T_rel = T_pj o T_joint o inv(T_cj)
        float R1[9], p1[3], t3[3];
        m3m(&c_pj_rot[9 * b], Rj, R1);
        m3v(&c_pj_rot[9 * b], pj, t3);
        for (int k = 0; k < 3; ++k) p1[k] = c_pj_pos[3 * b + k] + t3[k];
        m3m(R1, &c_cji_rot[9 * b], &R_rel[9 * b]);
        m3v(R1, &c_cji_pos[3 * b], t3);
        for (int k = 0; k < 3; ++k) p_rel[3 * b + k] = p1[k] + t3[k];
        float vj[6] = {0, 0, 0, 0, 0, 0}, cj[6] = {0, 0, 0, 0, 0, 0};
        for (int k = 0; k < nd; ++k) {
            const int d = qs + k;
            float Sr[6], Sdr[6];
            ad_cj(b, Sj[k], Sr);
            ad_cj(b, Sdj[k], Sdr);
            for (int c = 0; c < 6; ++c) {
                S[6 * d + c] = Sr[c];
                vj[c] += Sr[c] * dq[d];
                cj[c] += Sdr[c] * dq[d];
            }
        }
        for (int c = 0; c < 6; ++c) {
            vJ[6 * b + c] = vj[c];
            cJ[6 * b + c] = cj[c];
        }
    }
    GL_SYNC();
    DY_STAMP(1);

    // ---- world composition, one tree level at a time --------------------
    const float a_base[6] = {0.0f, 0.0f, 0.0f, -DY_GRAV(0), -DY_GRAV(1),
                             -DY_GRAV(2)};
    for (int lv = 0; lv < DY_NLEVEL; ++lv) {
        GL_FOR(t, c_lvl_start[lv], c_lvl_start[lv + 1]) {
            const int b = c_lvl_body[t];
            const int par = c_parent[b];
            const float* Rr = &R_rel[9 * b];
            const float* pr = &p_rel[3 * b];
            float xa[6], cr[6], t3[3];
            if (par < 0) {
                for (int k = 0; k < 9; ++k) R_w[9 * b + k] = Rr[k];
                for (int k = 0; k < 3; ++k) p_w[3 * b + k] = pr[k];
                for (int c = 0; c < 6; ++c) vel[6 * b + c] = vJ[6 * b + c];
                xmotion_Rt(Rr, pr, a_base, xa);
            } else {
                m3m(&R_w[9 * par], Rr, &R_w[9 * b]);
                m3v(&R_w[9 * par], pr, t3);
                for (int k = 0; k < 3; ++k)
                    p_w[3 * b + k] = p_w[3 * par + k] + t3[k];
                float xv[6];
                xmotion_Rt(Rr, pr, &vel[6 * par], xv);
                for (int c = 0; c < 6; ++c)
                    vel[6 * b + c] = xv[c] + vJ[6 * b + c];
                xmotion_Rt(Rr, pr, &ab[6 * par], xa);
            }
            crm6(&vel[6 * b], &vJ[6 * b], cr);
            for (int c = 0; c < 6; ++c)
                ab[6 * b + c] = xa[c] + (cr[c] + cJ[6 * b + c]);
        }
        GL_SYNC();
    }
    DY_STAMP(2);

    // ---- world-frame dof columns at the world origin: one dof per lane --
    GL_FOR(d, 0, DY_N) {
        const int b = c_dof_body[d];
        float t3[3], ph[6];
        m3v(&R_w[9 * b], &S[6 * d], ph);
        m3v(&R_w[9 * b], &S[6 * d + 3], ph + 3);
        cross3(&p_w[3 * b], ph, t3);
        for (int k = 0; k < 3; ++k) ph[3 + k] += t3[k];
        for (int c = 0; c < 6; ++c) phi[6 * d + c] = ph[c];
    }
    GL_SYNC();
    DY_STAMP(3);

    // ---- mass matrix: M[i][j] = sum_b phi_i . (I_w(b) phi_j) ------------
    GL_FOR(b, 0, DY_NB) {                   // world COM and inertia
        float IcR[9], t3[3];
        m3v(&R_w[9 * b], DY_COM(b), t3);
        for (int k = 0; k < 3; ++k) d_w[3 * b + k] = p_w[3 * b + k] + t3[k];
        m3m(&R_w[9 * b], DY_INERTIA(b), IcR);
        m3mt(IcR, &R_w[9 * b], &Ic_w[9 * b]);
    }
    GL_SYNC();
    GL_FOR(t, 0, DY_NF) {                   // F columns of (body, dof)
        const int b = c_f_body[t], j = c_f_dof[t];
        const float m_b = DY_MASS(b);
        const float* dw = &d_w[3 * b];
        const float* pj = &phi[6 * j];
        float* Fj = &F[6 * (b * DY_N + j)];
        float u[3], a3[3], c3[3], t3[3];
        cross3(dw, pj, t3);
        for (int k = 0; k < 3; ++k) u[k] = pj[3 + k] - t3[k];
        m3v(&Ic_w[9 * b], pj, a3);
        cross3(dw, u, c3);
        for (int k = 0; k < 3; ++k) {
            Fj[k] = a3[k] + c3[k] * m_b;
            Fj[3 + k] = u[k] * m_b;
        }
    }
    GL_SYNC();
    GL_FOR(t, 0, DY_NPAIR) {                // entries i <= j, and mirrored
        const int i = c_pair_i[t], j = c_pair_j[t];
        float mij = 0.0f;
        for (int b = 0; b < DY_NB; ++b) {
            if (!c_anc[b * DY_N + j] || !c_anc[b * DY_N + i]) continue;
            const float* Fj = &F[6 * (b * DY_N + j)];
            float acc = 0.0f;
            for (int c = 0; c < 6; ++c) acc += phi[6 * i + c] * Fj[c];
            mij += acc;
        }
        M[i * DY_N + j] = mij;
        M[j * DY_N + i] = mij;
    }
    DY_STAMP(4);

    // ---- bias forces: one body per lane, then the tree sum on lane 0 ----
    GL_FOR(b, 0, DY_NB) {
        float Ia[6], Iv[6], cf[6], fb[6], t3[3];
        float* fs = &f_sub[6 * b];
        inertia_mul(dr, b, &ab[6 * b], Ia);
        inertia_mul(dr, b, &vel[6 * b], Iv);
        crf6(&vel[6 * b], Iv, cf);
        for (int c = 0; c < 6; ++c) fb[c] = Ia[c] + cf[c];
        // inverse force transform (E = R_w^T, r = p_w)
        m3v(&R_w[9 * b], fb + 3, fs + 3);
        m3v(&R_w[9 * b], fb, fs);
        cross3(&p_w[3 * b], fs + 3, t3);
        for (int k = 0; k < 3; ++k) fs[k] += t3[k];
    }
    GL_SYNC();
    if (gl == 0) {
        for (int b = DY_NB - 1; b > 0; --b) {
            const int par = c_parent[b];
            if (par >= 0)
                for (int c = 0; c < 6; ++c)
                    f_sub[6 * par + c] += f_sub[6 * b + c];
        }
    }
    GL_SYNC();
    DY_STAMP(5);

    // ---- implicit-scheme forward dynamics -------------------------------
    GL_FOR(k, 0, DY_N * DY_N) {
        float v = M[k];
        if (k % (DY_N + 1) == 0) {
            const int d = k / (DY_N + 1);
            v += DY_DT * DY_DAMP(d) + (DY_DT * DY_DT) * DY_SPRING(d);
        }
        Mi[k] = v;
    }
    GL_FOR(d, 0, DY_N) {
        const int b = c_dof_body[d];
        float Cd = 0.0f;
        for (int c = 0; c < 6; ++c) Cd += phi[6 * d + c] * f_sub[6 * b + c];
        float td = tau[d] - Cd;
        td -= DY_DAMP(d) * dq[d];
        td -= DY_SPRING(d) * ((q[d] - DY_REST(d)) + DY_DT * dq[d]);
        rhs[d] = td;
    }
    GL_SYNC();
    chol_group(gl, Mi, L);
    if (gl == 0) {
        float ddq[DY_N];
        chol_solve_n(L, rhs, ddq);
        for (int d = 0; d < DY_N; ++d) dq_star[d] = dq[d] + DY_DT * ddq[d];
    }
    GL_SYNC();
    DY_STAMP(6);
}

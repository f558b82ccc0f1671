// Per-env arithmetic of the fused substep, shared by the CUDA kernel
// (substep.cu, one thread per env) and by a host build (substep_host.cpp,
// a plain loop over envs) that lets a machine without a GPU hold this
// arithmetic against the plain PyTorch version.  See substep.cu for what
// is computed and why it is laid out this way.  The includer defines the
// model through substep_model.h (generated) before including this file.
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
#define JT_PLANAR 7
#define G_SPHERE 0
#define G_CAPSULE 1
#define G_BOX 2
#define BIGF 1e20f


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
DI void inertia_mul(int b, const float* v6, float* o6) {
    const float m_b = c_mass[b];
    const float* c = &c_com[3 * b];
    float Icw[3], cxw[3], d[3], t[3];
    m3v(&c_inertia[9 * b], v6, Icw);
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
    for (int i = 0; i < SS_N; ++i) {
        for (int j = 0; j <= i; ++j) {
            float s = A[i * SS_N + j];
            if (j == i) s += 1e-10f;
            for (int k = 0; k < j; ++k) s -= L[i * SS_N + k] * L[j * SS_N + k];
            L[i * SS_N + j] = (i == j) ? sqrtf(fmaxf(s, 1e-30f))
                                       : s / L[j * SS_N + j];
        }
    }
}
DI void chol_solve_n(const float* L, const float* rhs, float* x) {
    float y[SS_N];
    for (int i = 0; i < SS_N; ++i) {
        float s = rhs[i];
        for (int k = 0; k < i; ++k) s -= L[i * SS_N + k] * y[k];
        y[i] = s / L[i * SS_N + i];
    }
    for (int i = SS_N - 1; i >= 0; --i) {
        float s = y[i];
        for (int k = i + 1; k < SS_N; ++k) s -= L[k * SS_N + i] * x[k];
        x[i] = s / L[i * SS_N + i];
    }
}

// One env's whole substep: reads row e of the inputs, writes row e of the
// eight outputs.
SS_FN void substep_env(int e, const float* __restrict__ q_g,
                       const float* __restrict__ dq_g,
                       const float* __restrict__ tau_g,
                       const float* __restrict__ lam_g,
                       float* __restrict__ dqp_g, float* __restrict__ lamf_g,
                       float* __restrict__ res_g, float* __restrict__ ovf_g,
                       float* __restrict__ cpos_g, float* __restrict__ cdep_g,
                       float* __restrict__ cact_g,
                       float* __restrict__ esc_g) {

    float q[SS_N], dq[SS_N], tau[SS_N];
    for (int d = 0; d < SS_N; ++d) {
        q[d] = q_g[(size_t)e * SS_N + d];
        dq[d] = dq_g[(size_t)e * SS_N + d];
        tau[d] = tau_g[(size_t)e * SS_N + d];
    }

    // ---- joint kinematics + tree recursion ------------------------------
    float R_w[SS_NB][9], p_w[SS_NB][3], vel[SS_NB][6], ab[SS_NB][6];
    float S[SS_N][6], Sd[SS_N][6];
    const float a_base[6] = {0.0f, 0.0f, 0.0f, -c_gravity[0], -c_gravity[1],
                             -c_gravity[2]};
#pragma unroll 1
    for (int b = 0; b < SS_NB; ++b) {
        float Rj[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
        float pj[3] = {0, 0, 0};
        float Sj[3][6], Sdj[3][6];
        for (int k = 0; k < 3; ++k)
            for (int c = 0; c < 6; ++c) { Sj[k][c] = 0.0f; Sdj[k][c] = 0.0f; }
        const int t = c_jt[b], qs = c_qstart[b], nd = c_ndof[b];
        const float* ax = &c_axes[9 * b];      // raw axes rows
        const float* axu = &c_axes_unit[9 * b];
        if (t == JT_REVOLUTE) {
            const float th = c_axes_norm[3 * b] * q[qs];
            rod_axis(axu, sinf(th), cosf(th), Rj);
            for (int k = 0; k < 3; ++k) Sj[0][k] = ax[k];
        } else if (t == JT_PRISMATIC) {
            for (int k = 0; k < 3; ++k) {
                pj[k] = ax[k] * q[qs];
                Sj[0][3 + k] = ax[k];
            }
        } else if (t == JT_PLANAR) {
            const float nrm = c_axes_norm[3 * b + 2];
            const float th = nrm * q[qs + 2];
            const float r2 = nrm * dq[qs + 2];
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
        }
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
    float phi[SS_N][6];
    for (int d = 0; d < SS_N; ++d) {
        const int b = c_dof_body[d];
        float t3[3];
        m3v(R_w[b], S[d], phi[d]);
        m3v(R_w[b], &S[d][3], &phi[d][3]);
        cross3(p_w[b], phi[d], t3);
        for (int k = 0; k < 3; ++k) phi[d][3 + k] += t3[k];
    }

    // ---- mass matrix: M[i][j] = sum_b phi_i . (I_w(b) phi_j) ------------
    float M[SS_N * SS_N];
    for (int i = 0; i < SS_N * SS_N; ++i) M[i] = 0.0f;
#pragma unroll 1
    for (int b = 0; b < SS_NB; ++b) {
        const float m_b = c_mass[b];
        float d_w[3], IcR[9], Ic_w[9], t3[3];
        m3v(R_w[b], &c_com[3 * b], t3);
        for (int k = 0; k < 3; ++k) d_w[k] = p_w[b][k] + t3[k];
        m3m(R_w[b], &c_inertia[9 * b], IcR);
        m3mt(IcR, R_w[b], Ic_w);
        float F[SS_N][6];
        for (int j = 0; j < SS_N; ++j) {
            if (!c_anc[b * SS_N + j]) continue;
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
                if (!c_anc[b * SS_N + i]) continue;
                float acc = 0.0f;
                for (int c = 0; c < 6; ++c) acc += phi[i][c] * F[j][c];
                M[i * SS_N + j] += acc;
            }
        }
    }
    for (int i = 0; i < SS_N; ++i)
        for (int j = 0; j < i; ++j) M[i * SS_N + j] = M[j * SS_N + i];

    // ---- bias forces ----------------------------------------------------
    float f_sub[SS_NB][6];
    for (int b = 0; b < SS_NB; ++b) {
        float Ia[6], Iv[6], cf[6], fb[6], t3[3];
        inertia_mul(b, ab[b], Ia);
        inertia_mul(b, vel[b], Iv);
        crf6(vel[b], Iv, cf);
        for (int c = 0; c < 6; ++c) fb[c] = Ia[c] + cf[c];
        // inverse force transform (E = R_w^T, r = p_w)
        m3v(R_w[b], fb + 3, &f_sub[b][3]);
        m3v(R_w[b], fb, f_sub[b]);
        cross3(p_w[b], &f_sub[b][3], t3);
        for (int k = 0; k < 3; ++k) f_sub[b][k] += t3[k];
    }
    for (int b = SS_NB - 1; b > 0; --b) {
        const int par = c_parent[b];
        if (par >= 0)
            for (int c = 0; c < 6; ++c) f_sub[par][c] += f_sub[b][c];
    }

    // ---- implicit-scheme forward dynamics -------------------------------
    float dq_star[SS_N];
    float L[SS_N * SS_N];
    {
        float rhs[SS_N], Mi[SS_N * SS_N], ddq[SS_N];
        for (int i = 0; i < SS_N * SS_N; ++i) Mi[i] = M[i];
        for (int d = 0; d < SS_N; ++d) {
            const int b = c_dof_body[d];
            float Cd = 0.0f;
            for (int c = 0; c < 6; ++c) Cd += phi[d][c] * f_sub[b][c];
            float td = tau[d] - Cd;
            td -= c_damping[d] * dq[d];
            td -= c_spring[d] * ((q[d] - c_rest[d]) + SS_DT * dq[d]);
            rhs[d] = td;
            Mi[d * SS_N + d] += SS_DT * c_damping[d]
                                + (SS_DT * SS_DT) * c_spring[d];
        }
        chol_n(Mi, L);
        chol_solve_n(L, rhs, ddq);
        for (int d = 0; d < SS_N; ++d) dq_star[d] = dq[d] + SS_DT * ddq[d];
    }
#if SS_IMPLICIT
    chol_n(M, L);          // the A build factors M itself, not M + diag
#endif

    // ---- collision: halfspace slots -------------------------------------
    float slot_pos[SS_NS_A][3], slot_depth[SS_NS_A], slot_active[SS_NS_A];
#pragma unroll 1
    for (int g = 0; g < SS_NG; ++g) {
        const int b = c_g_body[g];
        const float* nrm = &c_g_n[3 * g];
        const float off = c_g_off[g];
        const float* size = &c_g_size[3 * g];
        float Rg[9], pg[3], t3[3];
        m3m(R_w[b], &c_g_rot[9 * g], Rg);
        m3v(R_w[b], &c_g_pos[3 * g], t3);
        for (int k = 0; k < 3; ++k) pg[k] = p_w[b][k] + t3[k];
        const int s0 = c_g_slot0[g];
        const int gt = c_g_type[g];
        if (gt == G_SPHERE) {
            const float dist = dot3(nrm, pg) - off;
            for (int k = 0; k < 3; ++k) slot_pos[s0][k] = pg[k] - nrm[k] * dist;
            slot_depth[s0] = size[0] - dist;
        } else if (gt == G_CAPSULE) {
            const float axis[3] = {Rg[2], Rg[5], Rg[8]};
            for (int h = 0; h < 2; ++h) {
                const float sh = (h == 0 ? 1.0f : -1.0f) * size[1];
                float ept[3];
                for (int k = 0; k < 3; ++k) ept[k] = pg[k] + axis[k] * sh;
                const float dist = dot3(nrm, ept) - off;
                for (int k = 0; k < 3; ++k)
                    slot_pos[s0 + h][k] = ept[k] - nrm[k] * dist;
                slot_depth[s0 + h] = size[0] - dist;
            }
        } else {                          // G_BOX: deepest 4 of 8 corners
            float cpos[8][3], cdep[8];
            for (int c8 = 0; c8 < 8; ++c8) {
                const float loc[3] = {((c8 & 4) ? 1.0f : -1.0f) * size[0],
                                      ((c8 & 2) ? 1.0f : -1.0f) * size[1],
                                      ((c8 & 1) ? 1.0f : -1.0f) * size[2]};
                float cw[3];
                m3v(Rg, loc, cw);
                for (int k = 0; k < 3; ++k) cw[k] += pg[k];
                const float dist = dot3(nrm, cw) - off;
                for (int k = 0; k < 3; ++k) cpos[c8][k] = cw[k] - nrm[k] * dist;
                cdep[c8] = -dist;
            }
            for (int c8 = 0; c8 < 8; ++c8) {
                int rank = 0;
                for (int o = 0; o < 8; ++o) {
                    if (o == c8) continue;
                    rank += (o < c8) ? (cdep[o] >= cdep[c8])
                                     : (cdep[o] > cdep[c8]);
                }
                if (rank < 4) {
                    for (int k = 0; k < 3; ++k)
                        slot_pos[s0 + rank][k] = cpos[c8][k];
                    slot_depth[s0 + rank] = cdep[c8];
                }
            }
        }
    }
    float n_active = 0.0f;
    for (int s = 0; s < SS_NS; ++s) {
        slot_active[s] = (slot_depth[s] > SS_CONTACT_EPS) ? 1.0f : 0.0f;
        n_active += slot_active[s];
        for (int k = 0; k < 3; ++k)
            cpos_g[(size_t)e * (3 * SS_NS) + 3 * s + k] = slot_pos[s][k];
        cdep_g[(size_t)e * SS_NS + s] = slot_depth[s];
        cact_g[(size_t)e * SS_NS + s] = slot_active[s];
    }
#if SS_COMPACT
    ovf_g[e] = fmaxf(n_active - (float)SS_CAP, 0.0f);
#else
    ovf_g[e] = 0.0f;
#endif

    // ---- active-set compaction: top-cap by score, original order --------
    int sel[SS_CAP_A];
    for (int r = 0; r < SS_CAP; ++r) sel[r] = r;
#if SS_COMPACT
    {
        float score[SS_NS_A];
        for (int s = 0; s < SS_NS; ++s)
            score[s] = slot_active[s] * 1e4f + slot_depth[s];
        int r = 0;
        for (int s = 0; s < SS_NS; ++s) {
            int rank = 0;
            for (int o = 0; o < SS_NS; ++o) {
                if (o == s) continue;
                rank += (o < s) ? (score[o] >= score[s])
                                : (score[o] > score[s]);
            }
            if (rank < SS_CAP && r < SS_CAP) sel[r++] = s;
        }
    }
#endif

    // ---- compacted rows -------------------------------------------------
    float Jc[SS_MC_A * SS_N];
    float bv[SS_MC_A], lov[SS_MC_A], hiv[SS_MC_A], muv[SS_MC_A], act[SS_MC_A];
    for (int i = 0; i < SS_MC * SS_N; ++i) Jc[i] = 0.0f;
#pragma unroll 1
    for (int r = 0; r < SS_CAP; ++r) {
        const int s = sel[r];
        const int g = c_slot_geom[s];
        const int body = c_g_body[g];
        const float* D[3] = {&c_g_n[3 * g], &c_g_t1[3 * g], &c_g_t2[3 * g]};
        float vstar[3] = {0, 0, 0}, vnb = 0.0f;
        for (int i = 0; i < SS_N; ++i) {
            if (!c_anc[body * SS_N + i]) continue;
            float col[3];
            cross3(phi[i], slot_pos[s], col);
            for (int k = 0; k < 3; ++k) col[k] += phi[i][3 + k];
            for (int r3 = 0; r3 < 3; ++r3) {
                const float jv = dot3(D[r3], col);
                Jc[(3 * r + r3) * SS_N + i] = jv;
                vstar[r3] += jv * dq_star[i];
                if (r3 == 0) vnb += jv * dq[i];
            }
        }
        const float bounce = c_g_rest[g] * fmaxf(-vnb, 0.0f);
        const float erp_push = fminf(
            SS_ERP_DT * fmaxf(slot_depth[s] - SS_ALLOWANCE, 0.0f), SS_MAX_ERV);
        const float desired = fmaxf(bounce, erp_push);
        for (int r3 = 0; r3 < 3; ++r3) {
            const int row = 3 * r + r3;
            bv[row] = (r3 == 0) ? vstar[0] - desired : vstar[r3];
            lov[row] = (r3 == 0) ? 0.0f : -BIGF;
            hiv[row] = BIGF;
            muv[row] = (r3 == 0) ? 0.0f : c_g_fric[g];
            act[row] = slot_active[s];
        }
    }
    // limit rows
    for (int l = 0; l < SS_NLIM; ++l) {
        const int d = c_lim_dof[l], row = 3 * SS_CAP + l;
        const float lo_v = c_q_lower[d] - q[d];
        const float hi_v = q[d] - c_q_upper[d];
        const bool high = hi_v > 0.0f;
        const float sign = high ? -1.0f : 1.0f;
        const float viol = fmaxf(fmaxf(lo_v, hi_v), 0.0f);
        Jc[row * SS_N + d] = sign;
        bv[row] = sign * dq_star[d] - fminf(SS_JERP_DT * viol, SS_MAX_ERV);
        lov[row] = 0.0f;
        hiv[row] = BIGF;
        muv[row] = 0.0f;
        act[row] = ((lo_v > 0.0f || high) ? 1.0f : 0.0f) * c_limited[d];
    }
    // dof Coulomb friction rows
    for (int f = 0; f < SS_NFRIC; ++f) {
        const int d = c_fric_dof[f], row = 3 * SS_CAP + SS_NLIM + f;
        const float bound = c_dof_friction[d] * SS_DT;
        Jc[row * SS_N + d] = 1.0f;
        bv[row] = dq_star[d];
        lov[row] = -bound;
        hiv[row] = bound;
        muv[row] = 0.0f;
        act[row] = 1.0f;
    }

    // ---- A = J M^-1 J^T + cfm I, masked ---------------------------------
    float MiJ[SS_MC_A * SS_N];            // row c = M^-1 Jc[c]^T
#pragma unroll 1
    for (int c = 0; c < SS_MC; ++c)
        chol_solve_n(L, &Jc[c * SS_N], &MiJ[c * SS_N]);
    float A[SS_MC_A * SS_MC_A];
#pragma unroll 1
    for (int i = 0; i < SS_MC; ++i) {
        for (int j = 0; j <= i; ++j) {
            float aij = 0.0f;
            for (int k = 0; k < SS_N; ++k)
                aij += Jc[i * SS_N + k] * MiJ[j * SS_N + k];
            if (i == j) aij += SS_CFM;
            aij *= act[i] * act[j];
            if (i == j) aij += 1.0f - act[i];
            A[i * SS_MC + j] = aij;
            A[j * SS_MC + i] = aij;
        }
    }

    // ---- warm start: compact lam_prev, mask by active -------------------
    float lam[SS_MC_A];
    const float* lam_prev = lam_g + (size_t)e * SS_M;
    for (int r = 0; r < SS_CAP; ++r)
        for (int r3 = 0; r3 < 3; ++r3)
            lam[3 * r + r3] = lam_prev[3 * sel[r] + r3] * act[3 * r + r3];
    for (int t = 0; t < SS_MC - 3 * SS_CAP; ++t)
        lam[3 * SS_CAP + t] = lam_prev[3 * SS_NS + t] * act[3 * SS_CAP + t];

    // ---- PGS sweeps (static row order, SOR omega) -----------------------
    float inv_d[SS_MC_A];
    for (int i = 0; i < SS_MC; ++i) {
        const float di = A[i * SS_MC + i];
        inv_d[i] = (di > 1e-12f) ? SS_OMEGA / fmaxf(di, 1e-12f) : 0.0f;
    }
#pragma unroll 1
    for (int it = 0; it < SS_PGS_ITERS; ++it) {
#pragma unroll 1
        for (int i = 0; i < SS_MC; ++i) {
            float w = bv[i];
            for (int j = 0; j < SS_MC; ++j) w += A[i * SS_MC + j] * lam[j];
            const float nw = lam[i] - w * inv_d[i];
            float lo_i = lov[i], hi_i = hiv[i];
            const int fi = c_findex[i];
            if (fi >= 0) {
                const float bound = muv[i] * lam[fi];     // no abs here
                lo_i = fmaxf(lo_i, -bound);
                hi_i = fminf(hi_i, bound);
            }
            lam[i] = fminf(fmaxf(nw, lo_i), hi_i) * act[i];
        }
    }

    // ---- fused normalized residual (lcp/hybrid.comp_residual) -----------
    float scale = 1.0f;
    for (int i = 0; i < SS_MC; ++i) scale = fmaxf(scale, fabsf(lam[i]));
    const float epsr = 1e-6f * scale + 1e-9f;
    float res = 0.0f;
#pragma unroll 1
    for (int i = 0; i < SS_MC; ++i) {
        float w = bv[i];
        for (int j = 0; j < SS_MC; ++j) w += A[i * SS_MC + j] * lam[j];
        float lo_e = lov[i], hi_e = hiv[i];
        const int fi = c_findex[i];
        if (fi >= 0) {
            const float bound = muv[i] * fabsf(lam[fi]);
            lo_e = fmaxf(lo_e, -bound);
            hi_e = fminf(hi_e, bound);
        }
        const float li = lam[i];
        const bool at_lo = li <= lo_e + epsr;
        const bool at_hi = li >= hi_e - epsr;
        float r_i = (at_lo && at_hi) ? 0.0f
                    : (at_lo ? -w : (at_hi ? w : fabsf(w)));
        r_i = fmaxf(r_i, fmaxf(lo_e - li, li - hi_e));
        if (act[i] > 0.5f) res = fmaxf(res, r_i);
    }
    res_g[e] = res / scale;

    // ---- dq_plus + lam scattered back to the full row stack -------------
    for (int k = 0; k < SS_N; ++k) {
        float acc = dq_star[k];
        for (int i = 0; i < SS_MC; ++i) acc += MiJ[i * SS_N + k] * lam[i];
        dqp_g[(size_t)e * SS_N + k] = acc;
    }
    float* lamf = lamf_g + (size_t)e * SS_M;
    for (int i = 0; i < 3 * SS_NS; ++i) lamf[i] = 0.0f;
    for (int r = 0; r < SS_CAP; ++r)
        for (int r3 = 0; r3 < 3; ++r3)
            lamf[3 * sel[r] + r3] = lam[3 * r + r3];
    for (int t = 0; t < SS_MC - 3 * SS_CAP; ++t)
        lamf[3 * SS_NS + t] = lam[3 * SS_CAP + t];

    // ---- packed escalation inputs: b lo hi mu act lam sel M Jc ----------
    float* esc = esc_g + (size_t)e * SS_ESC;
    for (int i = 0; i < SS_MC; ++i) {
        esc[i] = bv[i];
        esc[SS_MC + i] = lov[i];
        esc[2 * SS_MC + i] = hiv[i];
        esc[3 * SS_MC + i] = muv[i];
        esc[4 * SS_MC + i] = act[i];
        esc[5 * SS_MC + i] = lam[i];
    }
    esc += 6 * SS_MC;
    for (int r = 0; r < SS_CAP; ++r) esc[r] = (float)sel[r];
    esc += SS_CAP;
    for (int i = 0; i < SS_N * SS_N; ++i) esc[i] = M[i];
    esc += SS_N * SS_N;
    for (int i = 0; i < SS_MC * SS_N; ++i) esc[i] = Jc[i];
}


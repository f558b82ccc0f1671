// Per-env arithmetic of the fused substep, shared by the CUDA kernel
// (substep.cu, one thread per env) and by a host build (substep_host.cpp,
// a plain loop over envs) that lets a machine without a GPU hold this
// arithmetic against the plain PyTorch version.  See substep.cu for what
// is computed and why it is laid out this way.  The includer defines the
// model through substep_model.h (generated) before including this file;
// the dynamics stage and the small vector helpers are dynamics_body.h,
// shared with the dynamics kernel.
#pragma once

#include "dynamics_body.h"

#define G_SPHERE 0
#define G_CAPSULE 1
#define G_BOX 2
#define BIGF 1e20f

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

    // ---- dynamics stage (dynamics_body.h) --------------------------------
    float R_w[SS_NB][9], p_w[SS_NB][3], phi[SS_N][6];
    float M[SS_N * SS_N], dq_star[SS_N], L[SS_N * SS_N];
    dyn_stage(q, dq, tau, R_w, p_w, phi, M, dq_star, L);
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


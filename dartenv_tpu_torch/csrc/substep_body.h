// Per-env arithmetic of the fused substep, shared by the CUDA kernel
// (substep.cu, ONE WARP PER ENV) and by a host build (substep_host.cpp, a
// plain loop over envs that runs each env as one lane) that lets a machine
// without a GPU hold this arithmetic against the plain PyTorch version.
// See substep.cu for what is computed and why it is laid out this way.
// The includer defines the model through substep_model.h (generated)
// before including this file; the dynamics stage and the small vector
// helpers are dynamics_body.h, shared with the dynamics kernel; the lane
// loops, the lane reductions and the PGS row update are pgs_row.h, shared
// with the PGS kernel.
#pragma once

#include "dynamics_body.h"
#include "pgs_row.h"

#define G_SPHERE 0
#define G_CAPSULE 1
#define G_BOX 2
#define BIGF 1e20f

// ---- the per-env working set, in floats (shared memory on the card) ----
// The first SS_ESC floats are the packed `esc` row in its own order
// (b lo hi mu act lam | sel_slots | M | Jc), so the kernel computes those
// blocks in place and stores the row with one coalesced copy.
#define SS_LDA (SS_MC_A | 1)        // odd row stride of A: no bank conflicts
#define SM_Q SS_ESC
#define SM_DQ (SM_Q + SS_N)
#define SM_TAU (SM_DQ + SS_N)
#define SM_DQS (SM_TAU + SS_N)
#define SM_L (SM_DQS + SS_N)
#define SM_RW (SM_L + SS_N * SS_N)
#define SM_PW (SM_RW + 9 * SS_NB)
#define SM_PHI (SM_PW + 3 * SS_NB)
#define SM_SPOS (SM_PHI + 6 * SS_N)
#define SM_SDEP (SM_SPOS + 3 * SS_NS_A)
#define SM_SACT (SM_SDEP + SS_NS_A)
#define SM_SCORE (SM_SACT + SS_NS_A)
#define SM_MIJ (SM_SCORE + SS_NS_A)
#define SM_A (SM_MIJ + SS_MC_A * SS_N)
#define SM_INVD (SM_A + SS_MC_A * SS_LDA)
#define SM_SEL (SM_INVD + SS_MC_A)          // int: compacted row -> slot
#define SM_FLAG (SM_SEL + SS_CAP_A)         // int: slot among the top cap
#define SM_SLOTR (SM_FLAG + SS_NS_A)        // int: slot -> compacted row
#define SS_SMEM (SM_SLOTR + SS_NS_A)

// Stage stamps (see substep.cu); nothing in a normal or host build.
#ifndef SS_STAMP
#define SS_STAMP_DECL
#define SS_STAMP(k) ((void)0)
#endif

// The dynamics stage of env e, by ONE thread (the kernel runs it for the
// envs of a block on the lanes of one warp, one env per lane, as the
// dynamics kernel does): reads row e of q, dq, tau into the env's scratch
// `sm` and leaves there R_w, p_w, phi, M (in the `esc` block), dq_star and
// the Cholesky factor L of M (dynamics_body.h).
SS_FN void substep_dyn(int e, float* sm, const float* __restrict__ q_g,
                       const float* __restrict__ dq_g,
                       const float* __restrict__ tau_g) {
    float* q = sm + SM_Q;
    float* dq = sm + SM_DQ;
    float* tau = sm + SM_TAU;
    float* M = sm + 6 * SS_MC + SS_CAP;
    for (int d = 0; d < SS_N; ++d) {
        q[d] = q_g[(size_t)e * SS_N + d];
        dq[d] = dq_g[(size_t)e * SS_N + d];
        tau[d] = tau_g[(size_t)e * SS_N + d];
    }
    dyn_stage(q, dq, tau, (float (*)[9])(sm + SM_RW),
              (float (*)[3])(sm + SM_PW), (float (*)[6])(sm + SM_PHI), M,
              sm + SM_DQS, sm + SM_L);
#if SS_IMPLICIT
    chol_n(M, sm + SM_L);  // the A build factors M itself, not M + diag
#endif
}

// The rest of env e's substep on one warp (lane = 0..31; the host build
// runs it as lane 0 alone), after substep_dyn: writes row e of the eight
// outputs.  Items that are independent (geoms, slots, rows, columns,
// output entries) go over the lanes; the PGS sweeps are the row update of
// pgs_row.h.
SS_FN void substep_warp(int e, int lane, float* sm,
                        const float* __restrict__ lam_g,
                       float* __restrict__ dqp_g, float* __restrict__ lamf_g,
                       float* __restrict__ res_g, float* __restrict__ ovf_g,
                       float* __restrict__ cpos_g, float* __restrict__ cdep_g,
                       float* __restrict__ cact_g,
                       float* __restrict__ esc_g) {
    float* esc = sm;
    float* bv = esc;
    float* lov = esc + SS_MC;
    float* hiv = esc + 2 * SS_MC;
    float* muv = esc + 3 * SS_MC;
    float* act = esc + 4 * SS_MC;
    float* lam = esc + 5 * SS_MC;
    float* sel_f = esc + 6 * SS_MC;
    float* M = sel_f + SS_CAP;
    float* Jc = M + SS_N * SS_N;
    float* q = sm + SM_Q;
    float* dq = sm + SM_DQ;
    float* dq_star = sm + SM_DQS;
    float* L = sm + SM_L;
    float (*R_w)[9] = (float (*)[9])(sm + SM_RW);
    float (*p_w)[3] = (float (*)[3])(sm + SM_PW);
    float (*phi)[6] = (float (*)[6])(sm + SM_PHI);
    float (*slot_pos)[3] = (float (*)[3])(sm + SM_SPOS);
    float* slot_depth = sm + SM_SDEP;
    float* slot_active = sm + SM_SACT;
    float* score = sm + SM_SCORE;
    float* MiJ = sm + SM_MIJ;             // row c = M^-1 Jc[c]^T
    float* A = sm + SM_A;
    float* inv_d = sm + SM_INVD;
    int* sel = (int*)(sm + SM_SEL);
    int* flag = (int*)(sm + SM_FLAG);
    int* slot_r = (int*)(sm + SM_SLOTR);
    SS_STAMP_DECL

    // ---- collision: halfspace slots, lanes over geoms ---------------------
    LANE_FOR(g, 0, SS_NG) {
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
    LANE_SYNC();
    LANE_FOR(s, 0, SS_NS) {
        slot_active[s] = (slot_depth[s] > SS_CONTACT_EPS) ? 1.0f : 0.0f;
        score[s] = slot_active[s] * 1e4f + slot_depth[s];
    }
    LANE_FOR(r, 0, SS_CAP) sel[r] = r;
    LANE_SYNC();
    LANE_FOR(k, 0, 3 * SS_NS)
        cpos_g[(size_t)e * (3 * SS_NS) + k] = (&slot_pos[0][0])[k];
    LANE_FOR(s, 0, SS_NS) {
        cdep_g[(size_t)e * SS_NS + s] = slot_depth[s];
        cact_g[(size_t)e * SS_NS + s] = slot_active[s];
    }
    if (lane == 0) {
        float n_active = 0.0f;
        for (int s = 0; s < SS_NS; ++s) n_active += slot_active[s];
#if SS_COMPACT
        ovf_g[e] = fmaxf(n_active - (float)SS_CAP, 0.0f);
#else
        (void)n_active;
        ovf_g[e] = 0.0f;
#endif
    }

    // ---- active-set compaction: top-cap by score, original order ----------
    // (lanes over slots: each slot's rank, then its place among the
    // selected slots before it)
#if SS_COMPACT
    LANE_FOR(s, 0, SS_NS) {
        int rank = 0;
        for (int o = 0; o < SS_NS; ++o) {
            if (o == s) continue;
            rank += (o < s) ? (score[o] >= score[s]) : (score[o] > score[s]);
        }
        flag[s] = rank < SS_CAP;
    }
    LANE_SYNC();
    LANE_FOR(s, 0, SS_NS) {
        if (flag[s]) {
            int r = 0;
            for (int o = 0; o < s; ++o) r += flag[o];
            if (r < SS_CAP) sel[r] = s;
        }
    }
    LANE_SYNC();
#endif
    LANE_FOR(s, 0, SS_NS) {               // the compacted row of each slot
        int rs = -1;
        for (int r = 0; r < SS_CAP; ++r)
            if (sel[r] == s) rs = r;
        slot_r[s] = rs;
    }
    LANE_FOR(r, 0, SS_CAP) sel_f[r] = (float)sel[r];
    LANE_FOR(i, 0, SS_MC * SS_N) Jc[i] = 0.0f;
    LANE_SYNC();
    SS_STAMP(1);

    // ---- compacted rows: lanes over contact, limit and friction rows ------
    LANE_FOR(t, 0, SS_CAP + SS_NLIM + SS_NFRIC) {
        if (t < SS_CAP) {
            const int r = t;
            const int s = sel[r];
            const int g = c_slot_geom[s];
            const int body = c_g_body[g];
            const float* D[3] = {&c_g_n[3 * g], &c_g_t1[3 * g],
                                 &c_g_t2[3 * g]};
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
                SS_ERP_DT * fmaxf(slot_depth[s] - SS_ALLOWANCE, 0.0f),
                SS_MAX_ERV);
            const float desired = fmaxf(bounce, erp_push);
            for (int r3 = 0; r3 < 3; ++r3) {
                const int row = 3 * r + r3;
                bv[row] = (r3 == 0) ? vstar[0] - desired : vstar[r3];
                lov[row] = (r3 == 0) ? 0.0f : -BIGF;
                hiv[row] = BIGF;
                muv[row] = (r3 == 0) ? 0.0f : c_g_fric[g];
                act[row] = slot_active[s];
            }
        } else if (t < SS_CAP + SS_NLIM) {        // limit rows
            const int l = t - SS_CAP;
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
        } else {                                  // dof Coulomb friction rows
            const int f = t - SS_CAP - SS_NLIM;
            const int d = c_fric_dof[f], row = 3 * SS_CAP + SS_NLIM + f;
            const float bound = c_dof_friction[d] * SS_DT;
            Jc[row * SS_N + d] = 1.0f;
            bv[row] = dq_star[d];
            lov[row] = -bound;
            hiv[row] = bound;
            muv[row] = 0.0f;
            act[row] = 1.0f;
        }
    }
    LANE_SYNC();
    SS_STAMP(2);

    // ---- A = J M^-1 J^T + cfm I, masked -----------------------------------
    LANE_FOR(c, 0, SS_MC) chol_solve_n(L, &Jc[c * SS_N], &MiJ[c * SS_N]);
    LANE_SYNC();
    // lanes over rows; entry (i, j) sums over k in order with the row of
    // the larger index first, so A is symmetric to the bit
    LANE_FOR(i, 0, SS_MC) {
        for (int j = 0; j < SS_MC; ++j) {
            const int hi_ij = i > j ? i : j, lo_ij = i > j ? j : i;
            float aij = 0.0f;
            for (int k = 0; k < SS_N; ++k)
                aij += Jc[hi_ij * SS_N + k] * MiJ[lo_ij * SS_N + k];
            if (i == j) aij += SS_CFM;
            aij *= act[hi_ij] * act[lo_ij];
            if (i == j) aij += 1.0f - act[i];
            A[i * SS_LDA + j] = aij;
        }
    }
    // ---- warm start: compact lam_prev, mask by active ---------------------
    const float* lam_prev = lam_g + (size_t)e * SS_M;
    LANE_FOR(t, 0, SS_MC) {
        lam[t] = (t < 3 * SS_CAP)
                     ? lam_prev[3 * sel[t / 3] + t % 3] * act[t]
                     : lam_prev[3 * SS_NS + (t - 3 * SS_CAP)] * act[t];
    }
    LANE_SYNC();

    // ---- PGS sweeps (static row order, SOR omega; pgs_row.h) --------------
    LANE_FOR(i, 0, SS_MC) inv_d[i] = pgs_inv_diag(A[i * SS_LDA + i], SS_OMEGA);
    LANE_SYNC();
    SS_STAMP(3);
#pragma unroll 1
    for (int it = 0; it < SS_PGS_ITERS; ++it)
#pragma unroll 1
        for (int i = 0; i < SS_MC; ++i)
            pgs_row(&A[i * SS_LDA], lam, SS_MC, i, bv[i], inv_d[i], lov[i],
                    hiv[i], muv[i], act[i], c_findex[i], lane);
    SS_STAMP(4);

    // ---- fused normalized residual (lcp/hybrid.comp_residual) -------------
    // lanes over rows, w_i summed in column order, then a lane max
    float amax = 0.0f;
    LANE_FOR(i, 0, SS_MC) amax = fmaxf(amax, fabsf(lam[i]));
    const float scale = fmaxf(1.0f, lanes_max(amax));
    const float epsr = 1e-6f * scale + 1e-9f;
    float res = 0.0f;
    LANE_FOR(i, 0, SS_MC) {
        float w = 0.0f;
        for (int j = 0; j < SS_MC; ++j) w += A[i * SS_LDA + j] * lam[j];
        w += bv[i];
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
    res = lanes_max(res);
    if (lane == 0) res_g[e] = res / scale;

    // ---- dq_plus, lam_full, packed `esc`: coalesced row stores ------------
    LANE_FOR(k, 0, SS_N) {
        float acc = dq_star[k];
        for (int i = 0; i < SS_MC; ++i) acc += MiJ[i * SS_N + k] * lam[i];
        dqp_g[(size_t)e * SS_N + k] = acc;
    }
    LANE_FOR(i, 0, SS_M) {
        float v;
        if (i < 3 * SS_NS) {
            const int r = slot_r[i / 3];
            v = (r >= 0) ? lam[3 * r + i % 3] : 0.0f;
        } else {
            v = lam[3 * SS_CAP + (i - 3 * SS_NS)];
        }
        lamf_g[(size_t)e * SS_M + i] = v;
    }
    LANE_FOR(k, 0, SS_ESC) esc_g[(size_t)e * SS_ESC + k] = esc[k];
    SS_STAMP(5);
}

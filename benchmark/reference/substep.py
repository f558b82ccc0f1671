"""The fused substep as plain PyTorch: a frozen copy of the program's plain
version (engine/hopper_substep.py's substep_reference and
escalate_reference) and its static digest.

One substep: dynamics -> halfspace collision -> active-set compaction ->
rows -> warm-started PGS -> normalized residual; then the exact
re-solve of the worst K envs of the batch (top-K by residual, tier 1
(+ tier 2), keep-best, the refinement tier) and the position update.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import batched
from benchmark.reference.narrowphase import collide
from benchmark.reference.constraints import (
    assemble_lcp, build_layout, compact_lam, compacted_findex,
    has_servo_rows, scatter_lam,
)
from benchmark.reference import bpp
from benchmark.reference.hybrid import (
    comp_residual, escalation_size, keep_best,
)
from benchmark.reference.pgs import pgs_solve
from benchmark.reference.linalg import (
    _UNROLL_MAX, chol, chol_solve, inv_psd, seq_mm, seq_mv,
)
from benchmark.reference.skel_model import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_SPHERE, SkelModel,
)


_NSLOTS = {GEOM_SPHERE: 1, GEOM_CAPSULE: 2, GEOM_BOX: 4}


_OUT_FIELDS = ("dq_plus", "lam_full", "res", "overflow", "con_pos",
               "con_depth", "con_active", "esc")


def in_fused_scope(model: SkelModel) -> bool:
    """Can the fused substep path (kernel or plain) serve this model?"""
    if model.nb < 1 or model.self_pairs or has_servo_rows(model):
        return False
    for gi, _ in model.world_pairs:
        if int(model.geom_type[gi]) not in _NSLOTS:
            return False
    return build_layout(model).m > 0


class _SubStatic:
    """Static digest of a model for the fused substep: sizes, constraint
    layout, per-geom contact tables (float64 numpy, host side)."""

    def __init__(self, model: SkelModel):
        self.layout = build_layout(model)
        self.cfg = model.solver
        self.dt = float(model.dt)
        self.n, self.nb = model.n, model.nb
        h = model.host
        self.slots: List[dict] = []
        for gi, wi in model.world_pairs:
            t = int(model.geom_type[gi])
            n = h("wg_normal")[wi]
            ref = (np.array([1.0, 0, 0]) if abs(n[0]) < 0.9
                   else np.array([0.0, 0, 1.0]))
            t1 = np.cross(n, ref)
            t1 = t1 / np.linalg.norm(t1)
            self.slots.append(dict(
                gtype=t, body=int(model.geom_body[gi]), gi=int(gi),
                wi=int(wi), rot=h("geom_rot")[gi], pos=h("geom_pos")[gi],
                size=h("geom_size")[gi], n=n, off=float(h("wg_offset")[wi]),
                fric=min(float(h("geom_friction")[gi]),
                         float(h("wg_friction")[wi])),
                rest=max(float(h("geom_restitution")[gi]),
                         float(h("wg_restitution")[wi])),
                t1=t1, t2=np.cross(n, t1), nslots=_NSLOTS[t],
            ))
        self.ns = sum(d["nslots"] for d in self.slots)
        assert self.ns == self.layout.contact_slots
        self.cap = int(self.cfg.contact_cap)
        self.compact = 0 < self.cap < self.ns
        if not self.compact:
            self.cap = self.ns
        self.m_c = 3 * self.cap + (self.layout.m - 3 * self.ns)
        self.findex_c = (compacted_findex(self.layout, self.cap)
                         if self.ns else np.asarray(self.layout.findex))

    @property
    def ref_passes(self):
        """(compensated, mixed-precision) refinement passes of the
        escalation: SolverConfig.escalate_ref and escalate_ref64, the
        latter winning where both are set."""
        return bpp.ref_tiers(self.cfg.escalate_ref,
                                    self.cfg.escalate_ref64)


def _esc_layout(st: _SubStatic):
    """Slice table of the packed `esc` buffer: name -> (start, stop)."""
    n, m_c, cap = st.n, st.m_c, st.cap
    sizes = (("b", m_c), ("lo", m_c), ("hi", m_c), ("mu", m_c),
             ("act", m_c), ("lam_c", m_c),
             ("sel_slots", cap), ("M", n * n), ("Jc", m_c * n))
    off, table = 0, {}
    for name, k in sizes:
        table[name] = (off, off + k)
        off += k
    return table, off


def unpack_esc(st: _SubStatic, esc) -> Dict[str, torch.Tensor]:
    """The named blocks of a packed `esc` tensor (..., width): views."""
    tab, _ = _esc_layout(st)
    return {name: esc[..., a:b] for name, (a, b) in tab.items()}


def substep_reference(model: SkelModel, st: _SubStatic, q, dq, tau,
                      lam_prev):
    """The fused substep as plain batched tensor code: the composition of
    dynamics/batched, collision/narrowphase, engine/constraints and
    lcp/pgs, plus the residual, the selected-slot table and the `esc`
    packing.  q, dq, tau: (B, n); lam_prev: (B, m).  Any dtype, any device.

    Returns the kernel's eight outputs ((B, k) tensors, `_out_sizes`) and,
    for tests, the intermediate fields dq_star, b, lo, hi, mu, act, lam_c,
    sel_slots, M, Jc."""
    B = q.shape[0]
    dt, cfg, layout = st.dt, st.cfg, st.layout
    kin = batched.bkin(model, q, dq)
    ddq, M = batched.forward_dynamics(model, kin, q, dq, tau, dt)
    dq_star = dq + dt * ddq
    contacts = collide(model, kin.R_w, kin.p_w)
    A, b, lo, hi, act, mu, findex, MinvJt, row_sel, Jc = assemble_lcp(
        model, layout, kin.phi, M, q, dq, dq_star, contacts, dt)
    lam0 = compact_lam(lam_prev, row_sel, act)
    lam = pgs_solve(A, b, lo, hi, findex, mu, act, iters=cfg.pgs_iters,
                    omega=cfg.pgs_omega, lam0=lam0)
    res = comp_residual(A, b, lam, lo, hi, findex, mu, act)
    dq_plus = dq_star + torch.sum(MinvJt * lam[:, None, :], dim=-1)
    lam_full = scatter_lam(lam, row_sel, layout.m)
    if row_sel is not None:
        sel_slots = (row_sel[:, 0:3 * st.cap:3] // 3).to(q.dtype)
    else:
        sel_slots = torch.arange(st.cap, device=q.device,
                                 dtype=q.dtype).expand(B, st.cap)
    esc = torch.cat([b, lo, hi, mu, act, lam, sel_slots,
                     M.reshape(B, -1), Jc.reshape(B, -1)], dim=1)
    return dict(
        dq_plus=dq_plus, lam_full=lam_full, res=res[:, None],
        overflow=contacts.overflow[:, None],
        con_pos=contacts.pos.reshape(B, -1), con_depth=contacts.depth,
        con_active=contacts.active, esc=esc,
        dq_star=dq_star, b=b, lo=lo, hi=hi, mu=mu, act=act, lam_c=lam,
        sel_slots=sel_slots, M=M.reshape(B, -1), Jc=Jc.reshape(B, -1),
    )


def gather_escalation(st: _SubStatic, cfg, outs):
    """Top-K by residual and ONE gather of the packed `esc` buffer; the
    boxed LCPs of the worst K envs, operator rebuilt from M and Jc with the
    port's own Cholesky.  Returns a dict (worst, idx, A, b, lo, hi, mu,
    act, lam_c, sel_slots, MinvJt).  Its sums run in the escalation
    kernel's order (math/linalg.seq_mm): it is the plain version of the
    kernel's rebuild."""
    n, m_c = st.n, st.m_c
    res = outs["res"][:, 0]
    B = res.shape[0]
    K = escalation_size(B, cfg.escalate_frac, cfg.escalate_kmax)
    worst, idx = torch.topk(res, K)
    blk = unpack_esc(st, outs["esc"][idx])
    actk = blk["act"]
    Mk = blk["M"].reshape(K, n, n)
    Jk = blk["Jc"].reshape(K, m_c, n)
    Jt = Jk.transpose(-1, -2)
    if n > _UNROLL_MAX:
        MinvJt = seq_mm(inv_psd(Mk, eps=1e-10, seq=True), Jt)
    else:
        MinvJt = chol_solve(chol(Mk, eps=1e-10), Jt)
    eye = torch.eye(m_c, dtype=actk.dtype, device=actk.device)
    Ak = seq_mm(Jk, MinvJt) + cfg.cfm * eye
    Ak = (Ak * actk[:, :, None] * actk[:, None, :]
          + eye * (1.0 - actk)[:, None, :])
    return dict(worst=worst, idx=idx, A=Ak, b=blk["b"], lo=blk["lo"],
                hi=blk["hi"], mu=blk["mu"], act=actk, lam_c=blk["lam_c"],
                sel_slots=blk["sel_slots"], MinvJt=MinvJt)


def escalate_reference(st: _SubStatic, cfg, outs, dq_plus, lam_full,
                       exact1, exact2=None):
    """The plain version of the escalation kernel's fused mode, as torch
    ops: top-K by residual, one gather of `esc`, operator rebuild, warm
    tier-1 (+ optional cold tier-2) exact re-solve by `exact1` / `exact2`,
    keep-best by residual, the refinement tier of cfg.escalate_ref64 /
    cfg.escalate_ref, and DELTA-form `index_add` patches of dq_plus
    and lam_full (envs outside the top K, and escalated envs whose
    re-solve is no better, keep their values bit for bit).  Returns new
    (dq_plus, lam_full), the top-K idx, take (K,) bool and the residual
    of the point kept (K,)."""
    ns, cap = st.ns, st.cap
    g = gather_escalation(st, cfg, outs)
    worst, idx, lamk = g["worst"], g["idx"], g["lam_c"]
    K = idx.shape[0]
    prob = (g["A"], g["b"], g["lo"], g["hi"], g["mu"], g["act"])
    lam_new, take, res_kept = keep_best(prob, st.findex_c, worst, lamk,
                                        cfg.escalate_tol, exact1, exact2,
                                        *st.ref_passes)
    dlam = torch.where(take[:, None], lam_new - lamk,
                       torch.zeros_like(lamk))
    dqp_delta = seq_mv(g["MinvJt"], dlam)
    slots = torch.arange(ns, dtype=dlam.dtype, device=dlam.device)
    Wk = (g["sel_slots"][:, :, None] == slots).to(dlam.dtype)
    dlam_con = dlam[:, : 3 * cap].reshape(K, cap, 3)
    scat = torch.sum(Wk[:, :, :, None] * dlam_con[:, :, None, :],
                     dim=1).reshape(K, 3 * ns)
    lamf_delta = torch.cat([scat, dlam[:, 3 * cap:]], dim=1)
    return (dq_plus.index_add(0, idx, dqp_delta),
            lam_full.index_add(0, idx, lamf_delta), idx, take, res_kept)


def escalation_tiers(st: _SubStatic, cfg):
    """(exact1, exact2) of the escalation's tiers for `cfg` (the solvers of
    bpp.tier_solvers, exact2 None without tier 2), or (None, None)
    when the model does not escalate."""
    if cfg.escalate_frac <= 0.0 or st.m_c == 0:
        return None, None
    return bpp.tier_solvers(st.findex_c, bpp.tier_budgets(
        cfg.escalate_iters, cfg.escalate_refine, cfg.escalate_iters2,
        *st.ref_passes))


def escalation_diag(outs, idx, take, res_kept):
    """The post-escalation residual envelope of the whole batch, the JAX
    package's `with_diag` record: dict(res_pre (B,): every env's substep
    residual, idx (K,): the escalated envs, envelope (B,): res_pre with the
    escalated envs' entries replaced by the residual of the point kept,
    which is their own residual where none was taken)."""
    res = outs["res"][:, 0]
    return dict(res_pre=res, idx=idx,
                envelope=res.index_copy(0, idx, torch.where(
                    take, res_kept, res[idx])))

"""Dynamics core, batch-first: q, dq, tau are (B, n); every per-env
quantity carries the env batch as its leading axis.

Counterpart of the JAX package's dynamics/batched.py (same quantities, same
formulation: joints processed in static type groups, world-frame dof
columns `phi`, M = sum_b J_b I_b^w J_b^T and C = sum_b J_b f_b^w as
mul+reduce contractions).  The kinematic tree recursion is a Python loop
over the topologically ordered bodies, and the S-dot rows that the JAX
package takes by `jax.jvp` are written out analytically.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from benchmark.reference.joints import type_S_rows
from benchmark.reference import spatial as sp
from benchmark.reference.linalg import solve_psd
from benchmark.reference.skel_model import (
    BALL, EULER, FREE, PLANAR, PRISMATIC, REVOLUTE, SCREW, SkelModel,
    TRANSLATIONAL, UNIVERSAL, WELD,
)

_mm, _mv = sp.mm, sp.mv


class BatchedIndex:
    """Precomputed static index sets for one topology."""

    def __init__(self, model: SkelModel):
        self.nb = model.nb
        self.n = model.n
        jt = np.asarray(model.joint_type)
        self.groups: Dict[int, np.ndarray] = {}
        for t in sorted(set(model.joint_type)):
            self.groups[int(t)] = np.nonzero(jt == t)[0]
        self.parent = np.asarray(model.parent, dtype=np.int64)
        self.dof_body = np.asarray(model.dof_body_index(), dtype=np.int64)
        self.q_start = np.asarray(model.q_start, dtype=np.int64)
        self.ndof = np.asarray(model.ndof, dtype=np.int64)


# keyed by the full topology tuple (not its hash)
_INDEX_CACHE: Dict[tuple, BatchedIndex] = {}


def get_index(model: SkelModel) -> BatchedIndex:
    key = (model.nb, model.parent, model.joint_type, model.q_start)
    if key not in _INDEX_CACHE:
        _INDEX_CACHE[key] = BatchedIndex(model)
    return _INDEX_CACHE[key]


def _rod(axes, angles):
    """Batched rodrigues: axes (g, 3), angles (B, g) -> (B, g, 3, 3)."""
    return sp.so3_exp(axes * angles[..., None])


def joint_S(model: SkelModel, q, dq=None):
    """S rows (B, n, 6) in the JOINT frame.  With dq given, also the exact
    time derivative Sdot (B, n, 6) (zero for constant-S joints); returns
    S alone otherwise.  Joints are taken a type group at a time
    (joints.type_S_rows)."""
    idx = get_index(model)
    B, n = q.shape[0], model.n
    S = q.new_zeros((B, n, 6))
    Sd = q.new_zeros((B, n, 6)) if dq is not None else None

    for t, joints in idx.groups.items():
        if len(joints) == 0 or t == WELD:
            continue
        qs = idx.q_start[joints]
        rows, drows = type_S_rows(
            t, model.axes[..., joints, :, :], lambda k: q[:, qs + k],
            None if dq is None else (lambda k: dq[:, qs + k]))
        for k, r in enumerate(rows):
            S[:, qs + k] = r
            if Sd is not None:
                Sd[:, qs + k] = drows[k]
    return S if dq is None else (S, Sd)


def joint_transforms(model: SkelModel, q):
    """(R_rel (B, nb, 3, 3), p_rel (B, nb, 3)): child pose in the parent
    body frame, grouped by joint type.  The joint axes and the joint
    frames may carry a leading env axis (domain randomization)."""
    idx = get_index(model)
    B, nb = q.shape[0], model.nb
    Rj = torch.eye(3, dtype=q.dtype, device=q.device).repeat(B, nb, 1, 1)
    pj = q.new_zeros((B, nb, 3))

    for t, joints in idx.groups.items():
        if len(joints) == 0 or t == WELD:
            continue
        ax = model.axes[..., joints, :, :]     # (g, 3, 3) or (B, g, 3, 3)
        qs = idx.q_start[joints]
        q3 = lambda o: torch.stack(
            [q[:, qs + o], q[:, qs + o + 1], q[:, qs + o + 2]], dim=-1)
        if t == REVOLUTE:
            Rj[:, joints] = _rod(ax[..., 0, :], q[:, qs])
        elif t == PRISMATIC:
            pj[:, joints] = ax[..., 0, :] * q[:, qs, None]
        elif t == SCREW:
            Rj[:, joints] = _rod(ax[..., 0, :], q[:, qs])
            pj[:, joints] = ax[..., 1, :] * q[:, qs, None]
        elif t == UNIVERSAL:
            Rj[:, joints] = _mm(_rod(ax[..., 0, :], q[:, qs]),
                                _rod(ax[..., 1, :], q[:, qs + 1]))
        elif t == EULER:
            Rj[:, joints] = _mm(
                _rod(ax[..., 0, :], q[:, qs]),
                _mm(_rod(ax[..., 1, :], q[:, qs + 1]),
                    _rod(ax[..., 2, :], q[:, qs + 2])))
        elif t == PLANAR:
            Rj[:, joints] = _rod(ax[..., 2, :], q[:, qs + 2])
            pj[:, joints] = (ax[..., 0, :] * q[:, qs, None]
                             + ax[..., 1, :] * q[:, qs + 1, None])
        elif t == BALL:
            Rj[:, joints] = sp.so3_exp(q3(0))
        elif t == TRANSLATIONAL:
            pj[:, joints] = q3(0)
        elif t == FREE:
            Rj[:, joints] = sp.so3_exp(q3(0))
            pj[:, joints] = q3(3)
        else:
            raise NotImplementedError(t)

    # T_rel = T_pj o T_joint o inv(T_cj)
    R1 = _mm(model.pj_rot, Rj)
    p1 = model.pj_pos + _mv(model.pj_rot, pj)
    cj_R_inv = model.cj_rot.transpose(-1, -2)
    cj_p_inv = -_mv(cj_R_inv, model.cj_pos)
    R_rel = _mm(R1, cj_R_inv)
    p_rel = p1 + _mv(R1, cj_p_inv)
    return R_rel, p_rel


def dof_S_child(model: SkelModel, q, dq):
    """S and S-dot rows (B, n, 6) in the CHILD body frame."""
    idx = get_index(model)
    S_j, Sdot_j = joint_S(model, q, dq)
    # the frame leaves may carry a leading env axis (domain randomization)
    cjR = model.cj_rot[..., idx.dof_body, :, :]     # ([B,] n, 3, 3)
    cjp = model.cj_pos[..., idx.dof_body, :]        # ([B,] n, 3)

    def ad(cols):
        w, v = cols[..., :3], cols[..., 3:]
        wb = _mv(cjR, w)
        vb = _mv(cjR, v) + sp.cross(cjp.expand(wb.shape), wb)
        return torch.cat([wb, vb], dim=-1)

    return ad(S_j), ad(Sdot_j)


@dataclasses.dataclass(frozen=True)
class BKin:
    """Kinematics cache of a batch of configurations."""

    R_w: Any     # (B, nb, 3, 3)
    p_w: Any     # (B, nb, 3)
    E: Any       # (B, nb, 3, 3) = R_rel^T
    r: Any       # (B, nb, 3)   = p_rel
    S: Any       # (B, n, 6) child-frame dof columns
    Sdot: Any    # (B, n, 6)
    v: Any       # (B, nb, 6) body spatial velocity (body frame)
    a_bias: Any  # (B, nb, 6) bias acceleration incl. gravity (body frame)
    phi: Any     # (B, n, 6) world-frame dof columns at world origin


def bkin(model: SkelModel, q, dq) -> BKin:
    idx = get_index(model)
    B, nb = q.shape[0], model.nb

    R_rel, p_rel = joint_transforms(model, q)
    S, Sdot = dof_S_child(model, q, dq)

    dof_body = torch.as_tensor(idx.dof_body, device=q.device)
    vJ = q.new_zeros((B, nb, 6)).index_add_(1, dof_body, S * dq[..., None])
    cJ = q.new_zeros((B, nb, 6)).index_add_(1, dof_body,
                                            Sdot * dq[..., None])

    E = R_rel.transpose(-1, -2)
    # gravity may carry a leading env axis (domain randomization)
    g = model.gravity
    a_base = torch.cat([torch.zeros_like(g), -g], dim=-1).expand(B, 6)
    R_l, p_l, v_l, a_l = [], [], [], []
    for i in range(nb):
        par = int(idx.parent[i])
        if par >= 0:
            Ri = _mm(R_l[par], R_rel[:, i])
            pw_i = p_l[par] + _mv(R_l[par], p_rel[:, i])
            v_i = sp.xmotion_apply(E[:, i], p_rel[:, i], v_l[par]) + vJ[:, i]
            a_par = a_l[par]
        else:
            Ri, pw_i, v_i, a_par = R_rel[:, i], p_rel[:, i], vJ[:, i], a_base
        a_i = (sp.xmotion_apply(E[:, i], p_rel[:, i], a_par)
               + sp.crm(v_i, vJ[:, i]) + cJ[:, i])
        R_l.append(Ri)
        p_l.append(pw_i)
        v_l.append(v_i)
        a_l.append(a_i)
    R_w = torch.stack(R_l, dim=1)
    p_w = torch.stack(p_l, dim=1)

    Rb = R_w[:, dof_body]
    pb = p_w[:, dof_body]
    w_cols = _mv(Rb, S[..., :3])
    v_cols = _mv(Rb, S[..., 3:]) + sp.cross(pb, w_cols)
    phi = torch.cat([w_cols, v_cols], dim=-1)

    return BKin(R_w=R_w, p_w=p_w, E=E, r=p_rel, S=S, Sdot=Sdot,
                v=torch.stack(v_l, dim=1), a_bias=torch.stack(a_l, dim=1),
                phi=phi)


def _body_inertias(model: SkelModel):
    """(nb, 6, 6) body-frame spatial inertias, or (B, nb, 6, 6) when any
    of mass / com / inertia carries a leading env axis (domain
    randomization; the others are broadcast over it)."""
    mass, com, inertia = model.mass, model.com, model.inertia
    lead = torch.broadcast_shapes(mass.shape, com.shape[:-1],
                                  inertia.shape[:-2])
    return sp.spatial_inertia(mass.expand(lead), com.expand(*lead, 3),
                              inertia.expand(*lead, 3, 3))


def world_jacobians(model: SkelModel, kin: BKin):
    """(B, nb, n, 6) masked world-frame body Jacobians."""
    return kin.phi[:, None, :, :] * model.ancestor_mask[:, :, None]


def mass_matrix(model: SkelModel, kin: BKin):
    """M (B, n, n) = sum_b J_b I_b^w J_b^T (world-frame assembly), all
    contractions as mul+reduce."""
    I_b = _body_inertias(model)                     # (nb, 6, 6) body frame
    X = sp.xmotion_mat(kin.R_w.transpose(-1, -2), kin.p_w)
    IX = torch.sum(I_b[..., :, :, None] * X[..., None, :, :], dim=-2)
    I_w = torch.sum(X[..., :, :, None] * IX[..., :, None, :], dim=-3)
    J = world_jacobians(model, kin)                 # (B, nb, n, 6)
    JI = torch.sum(J[..., :, :, None] * I_w[..., None, :, :], dim=-2)
    M = torch.sum(JI[..., :, None, :] * J[..., None, :, :], dim=(-4, -1))
    return 0.5 * (M + M.transpose(-1, -2))


def bias_forces(model: SkelModel, kin: BKin, f_ext_world=None):
    """C(q, dq) (B, n): gravity + Coriolis/centrifugal - external, via
    C = sum_b J_b f_b^w with body-frame Newton-Euler f_b.

    f_ext_world: (B, nb, 6) [torque; force] in world coordinates applied
    at each body origin, or None."""
    I_b = _body_inertias(model)
    f_body = (sp.inertia_mul(I_b, kin.a_bias)
              + sp.crf(kin.v, sp.inertia_mul(I_b, kin.v)))
    f_w = sp.xforce_inv_apply(kin.R_w.transpose(-1, -2), kin.p_w, f_body)
    if f_ext_world is not None:
        n_ext, f_ext = f_ext_world[..., :3], f_ext_world[..., 3:]
        # shift to the world origin for the J^T contraction
        n0 = n_ext + sp.cross(kin.p_w, f_ext)
        f_w = f_w - torch.cat([n0, f_ext], dim=-1)
    J = world_jacobians(model, kin)
    return torch.sum(J * f_w[:, :, None, :], dim=(1, 3))


def integrate_positions(model: SkelModel, q, dq, dt):
    """Batched semi-implicit position update; exp-map for ball/free groups."""
    idx = get_index(model)
    q_new = q + dq * dt
    for t in (BALL, FREE):
        joints = idx.groups.get(t, np.zeros(0, np.int64))
        if len(joints) == 0:
            continue
        qs = idx.q_start[joints]
        st3 = lambda x, o: torch.stack(
            [x[:, qs + o], x[:, qs + o + 1], x[:, qs + o + 2]], dim=-1)
        w, dw = st3(q, 0), st3(dq, 0)
        quat = sp.quat_mul(sp.so3_exp_quat(w), sp.so3_exp_quat(dw * dt))
        w_new = sp.so3_log_quat(quat)
        for k in range(3):
            q_new[:, qs + k] = w_new[..., k]
        if t == FREE:
            p_new = st3(q, 3) + _mv(sp.so3_exp(w), st3(dq, 3)) * dt
            for k in range(3):
                q_new[:, qs + 3 + k] = p_new[..., k]
    return q_new


def forward_dynamics(model: SkelModel, kin: BKin, q, dq, tau, dt,
                     f_ext_world=None):
    """(ddq, M) with the implicit spring/damper scheme:
    (M + diag(dt d + dt^2 k)) ddq = tau - d dq - k (q - rest + dt dq) - C,
    C including the external forces `f_ext_world` (see bias_forces).
    d, k and the rest positions may carry a leading env axis (domain
    randomization)."""
    M = mass_matrix(model, kin)
    C = bias_forces(model, kin, f_ext_world)
    d, k = model.damping, model.spring_stiff
    tau_total = tau - d * dq - k * (q - model.rest_pos + dt * dq) - C
    diag = dt * d + dt * dt * k
    Mi = M + (torch.diag(diag) if diag.ndim == 1
              else torch.diag_embed(diag))
    ddq = solve_psd(Mi, tau_total, eps=1e-10)
    return ddq, M

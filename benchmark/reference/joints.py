"""Joint models: transforms, motion subspaces and position integration.

Each joint type is a pure function (axes (3, 3), q (..., nd)) ->
(R (..., 3, 3), p (..., 3)): the pose of the child joint frame in the
parent joint frame; leading axes of q are batch axes.  The motion
subspace rows S and their time derivatives Sdot (written out
analytically where the JAX package takes `jax.jvp` of S) come from
`type_S_rows`, for a group of joints of one type: dynamics/batched.joint_S
calls it per type group, `joint_kinematics` for one joint.  For BALL and
FREE joints the generalized velocities are the body twist, and position
integration composes on the manifold via the exp map.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from benchmark.reference import spatial as sp
from benchmark.reference.skel_model import (
    BALL, EULER, FREE, PLANAR, PRISMATIC, REVOLUTE, SCREW, TRANSLATIONAL,
    UNIVERSAL, WELD,
)


def _rot(axis, angle):
    """Rotation about `axis` (3,) by angle (...,) (Rodrigues)."""
    return sp.so3_exp(axis * angle[..., None])


def _eye(q):
    return torch.eye(3, dtype=q.dtype, device=q.device).expand(
        q.shape[:-1] + (3, 3))


def _z3(q):
    return torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)


def _weld(axes, q):
    return _eye(q), _z3(q)


def _revolute(axes, q):
    return _rot(axes[0], q[..., 0]), _z3(q)


def _prismatic(axes, q):
    return _eye(q), axes[0] * q[..., :1]


def _screw(axes, q):
    # axes[1] = thread_pitch/(2*pi) * axes[0]
    return _rot(axes[0], q[..., 0]), axes[1] * q[..., :1]


def _universal(axes, q):
    return sp.mm(_rot(axes[0], q[..., 0]), _rot(axes[1], q[..., 1])), _z3(q)


def _euler(axes, q):
    R1, R2, R3 = (_rot(axes[0], q[..., 0]), _rot(axes[1], q[..., 1]),
                  _rot(axes[2], q[..., 2]))
    return sp.mm(R1, sp.mm(R2, R3)), _z3(q)


def _ball(axes, q):
    return sp.so3_exp(q[..., :3]), _z3(q)


def _translational(axes, q):
    return _eye(q), q[..., :3]


def _planar(axes, q):
    return (_rot(axes[2], q[..., 2]),
            axes[0] * q[..., 0:1] + axes[1] * q[..., 1:2])


def _free(axes, q):
    return sp.so3_exp(q[..., :3]), q[..., 3:6]


JOINT_FNS: Dict[int, Callable] = {
    WELD: _weld, REVOLUTE: _revolute, PRISMATIC: _prismatic,
    UNIVERSAL: _universal, EULER: _euler, BALL: _ball,
    TRANSLATIONAL: _translational, PLANAR: _planar, FREE: _free,
    SCREW: _screw,
}


def _scross(a, v):
    """a (g, 3) or (..., g, 3) x v (..., g, 3), broadcast."""
    return sp.cross(a.expand(v.shape), v)


def type_S_rows(t: int, ax, qk: Callable, dqk: Optional[Callable] = None
                ) -> Tuple[List, Optional[List]]:
    """Motion-subspace rows of a group of g joints of type t, in the JOINT
    frame.  ax: (g, 3, 3) axes, or (B, g, 3, 3) per env; qk(k) / dqk(k):
    the k-th coordinate of every joint of the group, (..., g).  Returns
    (rows, drows): nd tensors (..., g, 6) of S and, with dqk given, of its
    exact time derivative (zero for the constant-S types); drows is None
    without dqk."""
    q0 = qk(0) if t != WELD else None
    shape = (q0.shape if q0 is not None else ())
    nd = {WELD: 0, REVOLUTE: 1, PRISMATIC: 1, SCREW: 1, UNIVERSAL: 2,
          EULER: 3, PLANAR: 3, BALL: 3, TRANSLATIONAL: 3, FREE: 6}[t]
    if nd == 0:
        return [], ([] if dqk is not None else None)
    z = q0.new_zeros(shape + (3,))
    bc = lambda a: a.expand(shape + (3,))
    rows = [None] * nd
    drows = None
    if dqk is not None:
        drows = [q0.new_zeros(shape + (6,)) for _ in range(nd)]
    if t == REVOLUTE:
        rows[0] = torch.cat([bc(ax[..., 0, :]), z], dim=-1)
    elif t == PRISMATIC:
        rows[0] = torch.cat([z, bc(ax[..., 0, :])], dim=-1)
    elif t == SCREW:
        rows[0] = torch.cat([bc(ax[..., 0, :]), bc(ax[..., 1, :])], dim=-1)
    elif t == UNIVERSAL:
        R2t = _rot(ax[..., 1, :], qk(1)).transpose(-1, -2)
        s1 = sp.mv(R2t, ax[..., 0, :])
        rows[0] = torch.cat([s1, z], dim=-1)
        rows[1] = torch.cat([bc(ax[..., 1, :]), z], dim=-1)
        if drows is not None:
            # d/dt (R2^T a0) = -q1dot * (a1 x R2^T a0)
            d1 = -dqk(1)[..., None] * _scross(ax[..., 1, :], s1)
            drows[0] = torch.cat([d1, z], dim=-1)
    elif t == EULER:
        R2t = _rot(ax[..., 1, :], qk(1)).transpose(-1, -2)
        R3t = _rot(ax[..., 2, :], qk(2)).transpose(-1, -2)
        gv = sp.mv(R2t, ax[..., 0, :])
        s1 = sp.mv(R3t, gv)
        s2 = sp.mv(R3t, ax[..., 1, :])
        rows[0] = torch.cat([s1, z], dim=-1)
        rows[1] = torch.cat([s2, z], dim=-1)
        rows[2] = torch.cat([bc(ax[..., 2, :]), z], dim=-1)
        if drows is not None:
            q1d = dqk(1)[..., None]
            q2d = dqk(2)[..., None]
            gd = -q1d * _scross(ax[..., 1, :], gv)
            d1 = sp.mv(R3t, gd) - q2d * _scross(ax[..., 2, :], s1)
            d2 = -q2d * _scross(ax[..., 2, :], s2)
            drows[0] = torch.cat([d1, z], dim=-1)
            drows[1] = torch.cat([d2, z], dim=-1)
    elif t == PLANAR:
        Rt = _rot(ax[..., 2, :], qk(2)).transpose(-1, -2)
        r0 = sp.mv(Rt, ax[..., 0, :])
        r1 = sp.mv(Rt, ax[..., 1, :])
        rows[0] = torch.cat([z, r0], dim=-1)
        rows[1] = torch.cat([z, r1], dim=-1)
        rows[2] = torch.cat([bc(ax[..., 2, :]), z], dim=-1)
        if drows is not None:
            thd = dqk(2)[..., None]
            a2 = ax[..., 2, :]
            drows[0] = torch.cat([z, -thd * _scross(a2, r0)], dim=-1)
            drows[1] = torch.cat([z, -thd * _scross(a2, r1)], dim=-1)
    elif t in (BALL, TRANSLATIONAL, FREE):
        off = 3 if t == TRANSLATIONAL else 0
        for k in range(nd):
            r = q0.new_zeros(shape + (6,))
            r[..., off + k] = 1.0
            rows[k] = r
    else:
        raise NotImplementedError(t)
    return rows, drows


def joint_kinematics(jtype: int, axes, qj, dqj):
    """(R (3, 3), p (3,), S (6, nd), Sdot (6, nd)) of one joint at
    (qj, dqj) (nd,): the joint transform, the motion subspace in the
    joint frame and its exact time derivative (zero for the ball and free
    joints, whose S is constant)."""
    R, p = JOINT_FNS[jtype](axes, qj)
    rows, drows = type_S_rows(jtype, axes[None], lambda k: qj[k:k + 1],
                              lambda k: dqj[k:k + 1])
    if not rows:
        z = qj.new_zeros((6, 0))
        return R, p, z, z
    return (R, p, torch.stack([r[0] for r in rows], dim=-1),
            torch.stack([d[0] for d in drows], dim=-1))


def integrate_joint_position(jtype: int, qj, dqj, dt):
    """Semi-implicit position update q <- q (+) dq*dt of one joint, on the
    manifold for ball/free joints."""
    if jtype == BALL:
        quat = sp.quat_mul(sp.so3_exp_quat(qj[..., :3]),
                           sp.so3_exp_quat(dqj * dt))
        return sp.so3_log_quat(quat)
    if jtype == FREE:
        w, v = dqj[..., :3], dqj[..., 3:]
        R_old = sp.so3_exp(qj[..., :3])
        quat = sp.quat_mul(sp.so3_exp_quat(qj[..., :3]),
                           sp.so3_exp_quat(w * dt))
        p = qj[..., 3:] + sp.mv(R_old, v) * dt
        return torch.cat([sp.so3_log_quat(quat), p], dim=-1)
    return qj + dqj * dt

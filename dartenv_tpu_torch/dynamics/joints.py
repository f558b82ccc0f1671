"""Joint models: transforms and position integration.

Each joint type is a pure function (axes (3, 3), q (..., nd)) ->
(R (..., 3, 3), p (..., 3)): the pose of the child joint frame in the
parent joint frame; leading axes of q are batch axes.  (The motion
subspaces S and their time derivatives are computed type-grouped in
dynamics/batched.joint_S.)  For BALL and FREE joints the generalized
velocities are the body twist, and position integration composes on the
manifold via the exp map.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from dartenv_tpu_torch.math import spatial as sp
from dartenv_tpu_torch.model.skel_model import (
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

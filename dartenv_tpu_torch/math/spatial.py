"""Spatial (screw) algebra on torch tensors; all functions broadcast over
leading batch axes.

Conventions (Featherstone / RBDA):
  * spatial motion vector v = [omega; v_lin]  (angular on top)
  * spatial force  vector f = [n; f_lin]      (moment on top)
  * a Pluecker transform from frame A to frame B is stored structurally as
    (E, r): E = 3x3 rotation taking A-coordinates to B-coordinates,
    r = origin of B expressed in A coordinates.  Dense form:
        X  (motion) = [[E, 0], [-E r^, E]]
        X* (force)  = [[E, -E r^], [0, E]]
  * quaternions are wxyz, scalar first.
"""
from __future__ import annotations

import torch

_EPS = 1e-9


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def mv(a, v):
    """Matrix-vector product as mul+reduce: a (..., i, j), v (..., j)."""
    return torch.sum(a * v[..., None, :], dim=-1)


def mm(a, b):
    """Batched matmul as mul+reduce (tiny matrices, full-precision sums)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def skew(v):
    """Skew-symmetric matrix v^ such that v^ w = v x w.  v: (..., 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


# ---------------------------------------------------------------------------
# quaternions (wxyz) and the SO(3) exponential / logarithm
# ---------------------------------------------------------------------------

def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def so3_exp_quat(w):
    """exp: so(3) rotation vector -> unit quaternion, Taylor-safe at 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-12
    s_over = torch.where(
        small, 0.5 - theta2 / 48.0, torch.sin(0.5 * theta) / theta
    )
    c = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(0.5 * theta))
    return torch.cat([c[..., None], w * s_over[..., None]], dim=-1)


def so3_exp(w):
    """exp: rotation vector -> 3x3 rotation matrix (Rodrigues, Taylor-safe)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * mm(K, K)


def so3_log_quat(q):
    """log: unit quaternion -> rotation vector, Taylor-safe near identity."""
    q = torch.where(q[..., :1] < 0, -q, q)  # take the short geodesic
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn2 = torch.sum(v * v, dim=-1)
    vn = torch.sqrt(vn2 + _EPS * _EPS)
    angle = 2.0 * torch.atan2(vn, w)
    small = vn2 < 1e-12
    scale = torch.where(small, 2.0 / torch.clamp(w, min=0.5), angle / vn)
    return v * scale[..., None]


# ---------------------------------------------------------------------------
# Pluecker transforms in structural (E, r) form.
#   Given child pose (R, p) in the parent frame, the motion transform taking
#   parent-frame spatial vectors to child-frame ones has E = R^T, r = p.
# ---------------------------------------------------------------------------

def xmotion_apply(E, r, v):
    """[E,0; -E r^, E] v  for motion vector v = [w; vl]."""
    w, vl = v[..., :3], v[..., 3:]
    wE = mv(E, w)
    vE = mv(E, vl - cross(r, w))
    return torch.cat([wE, vE], dim=-1)


def xforce_inv_apply(E, r, f):
    """Inverse force transform (child frame back to parent frame)."""
    n, fl = f[..., :3], f[..., 3:]
    Et = E.transpose(-1, -2)
    fP = mv(Et, fl)
    nP = mv(Et, n) + cross(r, fP)
    return torch.cat([nP, fP], dim=-1)


def xmotion_mat(E, r):
    """Dense 6x6 motion transform [[E,0],[-E r^,E]]."""
    z = torch.zeros_like(E)
    top = torch.cat([E, z], dim=-1)
    bot = torch.cat([-mm(E, skew(r)), E], dim=-1)
    return torch.cat([top, bot], dim=-2)


def crm(v, m):
    """Motion cross product  v x m  (both motion vectors)."""
    w, vl = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, mw), cross(w, ml) + cross(vl, mw)], dim=-1)


def crf(v, f):
    """Force cross product  v x* f  (motion x force)."""
    w, vl = v[..., :3], v[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(vl, fl), cross(w, fl)], dim=-1)


def spatial_inertia(mass, com, inertia_com):
    """Dense 6x6 spatial inertia about the body-frame origin.

    mass: (...,), com: (..., 3) — COM offset in body frame,
    inertia_com: (..., 3, 3) — rotational inertia about the COM.
    I = [[Ic + m c^ c^T, m c^], [m c^T, m 1]]
    """
    c = skew(com)
    ct = c.transpose(-1, -2)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=com.dtype, device=com.device).expand(c.shape)
    top = torch.cat([inertia_com + m * mm(c, ct), m * c], dim=-1)
    bot = torch.cat([m * ct, m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inertia_mul(I, v):
    """I @ v for 6x6 inertia and motion vector."""
    return mv(I, v)

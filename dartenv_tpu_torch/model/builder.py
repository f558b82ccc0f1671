"""Programmatic model construction -> SkelModel.

Host-side (offline) model assembly in numpy float64; the numeric leaves
are cast ONCE to the requested dtype and device in `finalize` (through
model/convert.model_from_numpy).  Used directly by tests/envs and by the
.skel XML parser (`skel_parser.py`).  Mesh geoms are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dartenv_tpu_torch.model.convert import model_from_numpy
from dartenv_tpu_torch.model.skel_model import (
    JOINT_NDOF, SCREW, SkelModel, SolverConfig, ancestor_mask_np,
)


def rpy_to_mat(r, p, y):
    """XYZ-fixed-angle rotation (roll-pitch-yaw), matching the skel-file
    convention for <transform> entries ‡."""
    cr, sr = np.cos(r), np.sin(r)
    cp, sp_ = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp_], [0, 1, 0], [-sp_, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def box_inertia(mass, half_extents):
    x, y, z = [2.0 * h for h in half_extents]
    return np.diag([
        mass / 12.0 * (y * y + z * z),
        mass / 12.0 * (x * x + z * z),
        mass / 12.0 * (x * x + y * y),
    ])


def sphere_inertia(mass, radius):
    i = 0.4 * mass * radius * radius
    return np.diag([i, i, i])


def cylinder_inertia(mass, radius, height):
    """About COM, axis = local z."""
    ixy = mass * (3.0 * radius * radius + height * height) / 12.0
    iz = 0.5 * mass * radius * radius
    return np.diag([ixy, ixy, iz])


def ellipsoid_inertia(mass, radii):
    """About COM, semi-axes `radii` along the local axes."""
    a, b, c = [float(r) for r in radii]
    return np.diag([
        mass / 5.0 * (b * b + c * c),
        mass / 5.0 * (a * a + c * c),
        mass / 5.0 * (a * a + b * b),
    ])


def capsule_inertia(mass, radius, half_length):
    """Capsule about COM, axis = local z (cylinder + two hemispheres)."""
    h = 2.0 * half_length
    r = radius
    vol_cyl = np.pi * r * r * h
    vol_sph = 4.0 / 3.0 * np.pi * r ** 3
    vol = vol_cyl + vol_sph
    m_cyl = mass * vol_cyl / vol
    m_sph = mass * vol_sph / vol
    # cylinder part
    iz = 0.5 * m_cyl * r * r
    ixy = m_cyl * (3 * r * r + h * h) / 12.0
    # hemispheres (two, offset h/2 from center)
    iz_s = 0.4 * m_sph * r * r
    ixy_s = 0.4 * m_sph * r * r + m_sph * (
        0.5 * h * 0.5 * h + 2.0 * (3.0 / 8.0) * r * 0.5 * h
    )
    return np.diag([ixy + ixy_s, ixy + ixy_s, iz + iz_s])


class ModelBuilder:
    def __init__(self, dt: float = 0.002, gravity=(0.0, -9.81, 0.0),
                 name: str = "skel", solver: Optional[SolverConfig] = None):
        self.dt = float(dt)
        self.gravity = np.asarray(gravity, dtype=np.float64)
        self.name = name
        self.solver = solver or SolverConfig()
        self._bodies = []       # dicts
        self._geoms = []
        self._wgeoms = []
        self._self_pairs = []
        self._name_to_idx = {}

    # -- bodies/joints ----------------------------------------------------
    def add_body(
        self,
        name: str,
        parent: Optional[str],
        joint_type: int,
        *,
        axes: Sequence[Sequence[float]] = ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
        pj_pos=(0, 0, 0), pj_rot=None,
        cj_pos=(0, 0, 0), cj_rot=None,
        mass: float = 1.0, com=(0, 0, 0), inertia=None,
        damping=0.0, spring=0.0, rest=0.0, dof_friction=0.0,
        servo_flimit=0.0,
        q_lower=None, q_upper=None,
        q_init=0.0, joint_name: Optional[str] = None,
        pitch: float = 0.0,
    ) -> str:
        nd = JOINT_NDOF[joint_type]

        def _per_dof(x, default=0.0):
            if x is None:
                return [default] * nd
            if np.isscalar(x):
                return [float(x)] * nd
            assert len(x) == nd, (name, x)
            return [float(v) for v in x]

        ax = np.zeros((3, 3))
        axes = np.asarray(axes, dtype=np.float64)
        ax[: axes.shape[0]] = axes
        if joint_type == SCREW:
            # convention (skel_model.SCREW): axes[1] = pitch/(2*pi) * axis,
            # i.e. one full turn advances `pitch` along the axis (reference:
            # dart/dynamics/ScrewJoint.cpp † thread pitch semantics ‡)
            ax[1] = ax[0] * (float(pitch) / (2.0 * np.pi))
        parent_idx = -1 if parent is None else self._name_to_idx[parent]
        body = dict(
            name=name,
            joint_name=joint_name or (name + "_joint"),
            parent=parent_idx,
            joint_type=joint_type,
            axes=ax,
            pj_pos=np.asarray(pj_pos, dtype=np.float64),
            pj_rot=np.eye(3) if pj_rot is None else np.asarray(pj_rot),
            cj_pos=np.asarray(cj_pos, dtype=np.float64),
            cj_rot=np.eye(3) if cj_rot is None else np.asarray(cj_rot),
            mass=float(mass),
            com=np.asarray(com, dtype=np.float64),
            inertia=(np.eye(3) * 1e-3 if inertia is None
                     else np.asarray(inertia, dtype=np.float64)),
            damping=_per_dof(damping),
            spring=_per_dof(spring),
            rest=_per_dof(rest),
            dof_friction=_per_dof(dof_friction),
            servo_flimit=_per_dof(servo_flimit),
            q_lower=_per_dof(q_lower, -1e16),
            q_upper=_per_dof(q_upper, 1e16),
            limited=[
                1.0 if (lo > -1e15 or hi < 1e15) else 0.0
                for lo, hi in zip(_per_dof(q_lower, -1e16),
                                  _per_dof(q_upper, 1e16))
            ],
            q_init=_per_dof(q_init),
        )
        self._name_to_idx[name] = len(self._bodies)
        self._bodies.append(body)
        return name

    # -- geoms ------------------------------------------------------------
    def add_geom(self, body: str, gtype: int, size,
                 pos=(0, 0, 0), rot=None, friction: float = 1.0,
                 restitution: float = 0.0, collide: bool = True) -> int:
        s = np.zeros(3)
        size = np.atleast_1d(np.asarray(size, dtype=np.float64))
        s[: size.shape[0]] = size
        self._geoms.append(dict(
            body=self._name_to_idx[body], type=int(gtype), size=s,
            pos=np.asarray(pos, dtype=np.float64),
            rot=np.eye(3) if rot is None else np.asarray(rot),
            friction=float(friction), restitution=float(restitution),
            collide=bool(collide),
        ))
        return len(self._geoms) - 1

    def add_self_pair(self, geom_a: int, geom_b: int):
        """Register a robot-geom-vs-robot-geom collision pair (reference:
        Skeleton::enableSelfCollisionCheck † — here pairs are explicit so
        adjacent-body exclusion is the caller's choice)."""
        self._self_pairs.append((int(geom_a), int(geom_b)))

    def add_ground(self, normal=(0, 1, 0), offset: float = 0.0,
                   friction: float = 1.0, restitution: float = 0.0):
        n = np.asarray(normal, dtype=np.float64)
        self._wgeoms.append(dict(
            normal=n / np.linalg.norm(n), offset=float(offset),
            friction=float(friction), restitution=float(restitution),
        ))

    # -- finalize ---------------------------------------------------------
    def finalize(self, dtype=torch.float32, device="cuda") -> SkelModel:
        nb = len(self._bodies)
        q_start, ndof = [], []
        n = 0
        for b in self._bodies:
            q_start.append(n)
            nd = JOINT_NDOF[b["joint_type"]]
            ndof.append(nd)
            n += nd

        def stack(key, shape):
            if not self._bodies:
                return np.zeros((0,) + shape)
            return np.stack([np.broadcast_to(b[key], shape)
                             for b in self._bodies])

        def per_dof(key):
            out = []
            for b in self._bodies:
                out += b[key]
            return np.asarray(out, dtype=np.float64)

        parent = tuple(b["parent"] for b in self._bodies)
        for i, p in enumerate(parent):
            assert p < i, "bodies must be topologically ordered"

        ng = len(self._geoms)
        nw = len(self._wgeoms)
        world_pairs = []
        for gi, g in enumerate(self._geoms):
            if not g["collide"]:
                continue
            for wi in range(nw):
                world_pairs.append((gi, wi))

        qs = tuple(q_start)
        nd_t = tuple(ndof)
        static = dict(
            nb=nb, n=n, parent=parent,
            joint_type=tuple(b["joint_type"] for b in self._bodies),
            q_start=qs, ndof=nd_t,
            body_names=tuple(b["name"] for b in self._bodies),
            joint_names=tuple(b["joint_name"] for b in self._bodies),
            world_pairs=tuple(world_pairs),
            self_pairs=tuple(self._self_pairs),
            dt=self.dt, name=self.name, solver=self.solver,
            geom_body=tuple(g["body"] for g in self._geoms),
            geom_type=tuple(g["type"] for g in self._geoms),
        )
        gstack = lambda key, shape: (
            np.stack([g[key] for g in self._geoms]) if ng
            else np.zeros((0,) + shape))
        wlist = lambda key: np.asarray([w[key] for w in self._wgeoms],
                                       dtype=np.float64).reshape(nw)
        arrays = dict(
            pj_rot=stack("pj_rot", (3, 3)), pj_pos=stack("pj_pos", (3,)),
            cj_rot=stack("cj_rot", (3, 3)), cj_pos=stack("cj_pos", (3,)),
            axes=stack("axes", (3, 3)),
            mass=np.asarray([b["mass"] for b in self._bodies]),
            com=stack("com", (3,)),
            inertia=stack("inertia", (3, 3)),
            damping=per_dof("damping"),
            spring_stiff=per_dof("spring"),
            rest_pos=per_dof("rest"),
            dof_friction=per_dof("dof_friction"),
            servo_flimit=per_dof("servo_flimit"),
            q_lower=per_dof("q_lower"), q_upper=per_dof("q_upper"),
            limited=per_dof("limited"),
            q_init=per_dof("q_init"),
            dq_init=np.zeros(n),
            ancestor_mask=ancestor_mask_np(parent, qs, nd_t, n),
            geom_size=gstack("size", (3,)),
            geom_rot=gstack("rot", (3, 3)),
            geom_pos=gstack("pos", (3,)),
            geom_friction=np.asarray(
                [g["friction"] for g in self._geoms]).reshape(ng),
            geom_restitution=np.asarray(
                [g["restitution"] for g in self._geoms]).reshape(ng),
            wg_normal=(np.stack([w["normal"] for w in self._wgeoms])
                       if nw else np.zeros((0, 3))),
            wg_offset=wlist("offset"),
            wg_friction=wlist("friction"),
            wg_restitution=wlist("restitution"),
            gravity=self.gravity,
        )
        return model_from_numpy(static, arrays, device=device, dtype=dtype)

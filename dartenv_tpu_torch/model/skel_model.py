"""SkelModel: the static articulated model as a dataclass of tensors.

Counterpart of the JAX package's `model/skel_model.py`: static topology is
Python data (ints / tuples, hashable), numeric leaves are torch tensors
WITHOUT a batch axis, moved as one unit with `.to(device, dtype)`.
Everything is in the y-up convention of the .skel files.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

# --- joint types ---
WELD = 0
REVOLUTE = 1
PRISMATIC = 2
UNIVERSAL = 3
EULER = 4          # XYZ order; axes rows give the three axes
BALL = 5           # q = so(3) exp coords, dq = body angular velocity
TRANSLATIONAL = 6
PLANAR = 7         # dofs [t1, t2, rot]; axes rows [e1, e2, e_rot]
FREE = 8           # q = [so(3) exp coords, xyz], dq = body twist [w, v]
SCREW = 9          # rotation about axes[0] + coupled translation; convention:
                   # axes[1] = thread_pitch/(2*pi) * axes[0]

JOINT_NDOF = {
    WELD: 0, REVOLUTE: 1, PRISMATIC: 1, UNIVERSAL: 2, EULER: 3, BALL: 3,
    TRANSLATIONAL: 3, PLANAR: 3, FREE: 6, SCREW: 1,
}
JOINT_NAMES = {
    WELD: "WELD", REVOLUTE: "REVOLUTE", PRISMATIC: "PRISMATIC",
    UNIVERSAL: "UNIVERSAL", EULER: "EULER", BALL: "BALL",
    TRANSLATIONAL: "TRANSLATIONAL", PLANAR: "PLANAR", FREE: "FREE",
    SCREW: "SCREW",
}

# geometry types
GEOM_SPHERE = 0
GEOM_CAPSULE = 1    # size = (radius, half_length, 0); axis = local z
GEOM_BOX = 2        # size = half extents (3,)
GEOM_CYLINDER = 3   # size = (radius, half_height, 0); axis = local z
GEOM_ELLIPSOID = 4  # size = semi-axes (3,) along local axes
GEOM_MESH = 5       # convex vertex cloud (not ported yet)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Constraint-solver constants; field-for-field the JAX package's
    SolverConfig (see its comments for the provenance of each default)."""

    erp: float = 0.01
    cfm: float = 1e-5
    max_erv: float = 10.0
    allowance: float = 0.0
    joint_erp: float = 0.01
    pgs_iters: int = 30
    pgs_omega: float = 1.0
    solver: str = "pgs"
    contact_eps: float = 1e-6
    # active-set compaction: solve over the `contact_cap` best contact
    # slots (active first, deepest first); 0 disables
    contact_cap: int = 0
    # hybrid residual escalation: the worst ceil(escalate_frac * B) envs
    # are re-solved exactly and the better point is kept; 0.0 disables
    escalate_frac: float = 0.0
    escalate_tol: float = 1e-6
    escalate_iters: int = 8
    escalate_kmax: int = 128
    escalate_refine: int = -1      # -1 = max(iters // 3, 6)
    escalate_iters2: int = 0       # > 0: cold tier-2 re-solve budget
    escalate_ref64: int = 0        # mixed-precision refinement (not ported)
    escalate_ref: int = 0          # compensated refinement (not ported)


# numeric leaves (float tensors) in declaration order
FLOAT_LEAVES = (
    "pj_rot", "pj_pos", "cj_rot", "cj_pos", "axes", "mass", "com",
    "inertia", "damping", "spring_stiff", "rest_pos", "dof_friction",
    "servo_flimit", "q_lower", "q_upper", "limited", "q_init", "dq_init",
    "ancestor_mask", "geom_size", "geom_rot", "geom_pos", "geom_friction",
    "geom_restitution", "wg_normal", "wg_offset", "wg_friction",
    "wg_restitution", "gravity",
)
# static fields (Python data)
STATIC_FIELDS = (
    "nb", "n", "parent", "joint_type", "q_start", "ndof", "body_names",
    "joint_names", "world_pairs", "self_pairs", "dt", "name", "solver",
    "geom_body", "geom_type",
)


@dataclasses.dataclass(frozen=True)
class SkelModel:
    """One articulated robot + static world geometry, as pure data.

    Bodies are topologically ordered (parent index < body index, root
    parent = -1).  Each body has exactly one inboard joint; `n` generalized
    coordinates with nq == nv == n (exp-map coordinates for ball/free).
    """

    # ---- static topology (python data, hashable) ----
    nb: int = 0
    n: int = 0
    parent: Tuple[int, ...] = ()
    joint_type: Tuple[int, ...] = ()
    q_start: Tuple[int, ...] = ()
    ndof: Tuple[int, ...] = ()
    body_names: Tuple[str, ...] = ()
    joint_names: Tuple[str, ...] = ()
    world_pairs: Tuple[Tuple[int, int], ...] = ()
    self_pairs: Tuple[Tuple[int, int], ...] = ()
    dt: float = 0.002
    name: str = "skel"
    solver: SolverConfig = SolverConfig()
    geom_body: Tuple[int, ...] = ()     # (ng,) body index per geom
    geom_type: Tuple[int, ...] = ()     # (ng,)

    # ---- joint frames: T_rel = T_pj o JointT(q) o inv(T_cj) ----
    pj_rot: Any = None   # (nb, 3, 3)
    pj_pos: Any = None   # (nb, 3)
    cj_rot: Any = None   # (nb, 3, 3)
    cj_pos: Any = None   # (nb, 3)
    axes: Any = None     # (nb, 3, 3) joint axes, rows

    # ---- inertial ----
    mass: Any = None       # (nb,)
    com: Any = None        # (nb, 3)
    inertia: Any = None    # (nb, 3, 3) about COM, body frame

    # ---- per-dof ----
    damping: Any = None
    spring_stiff: Any = None
    rest_pos: Any = None
    dof_friction: Any = None
    servo_flimit: Any = None
    q_lower: Any = None
    q_upper: Any = None
    limited: Any = None        # (n,) float mask {0, 1}
    q_init: Any = None
    dq_init: Any = None
    ancestor_mask: Any = None  # (nb, n) in {0, 1}

    # ---- robot collision geoms ----
    geom_size: Any = None   # (ng, 3)
    geom_rot: Any = None    # (ng, 3, 3) pose in body frame
    geom_pos: Any = None    # (ng, 3)
    geom_friction: Any = None
    geom_restitution: Any = None

    # ---- static world geoms: halfspaces ----
    wg_normal: Any = None   # (nw, 3)
    wg_offset: Any = None   # (nw,) plane: n.x = offset
    wg_friction: Any = None
    wg_restitution: Any = None

    gravity: Any = None     # (3,)

    @property
    def ng(self) -> int:
        return len(self.geom_body)

    @property
    def device(self) -> torch.device:
        return self.q_init.device

    @property
    def dtype(self) -> torch.dtype:
        return self.q_init.dtype

    def dof_body_index(self) -> Tuple[int, ...]:
        """Static map dof -> owning body."""
        out = []
        for b in range(self.nb):
            out += [b] * self.ndof[b]
        return tuple(out)

    def replace(self, **kw) -> "SkelModel":
        return dataclasses.replace(self, **kw)

    def to(self, device=None, dtype=None) -> "SkelModel":
        """Move / cast every numeric leaf at once."""
        kw = {}
        for f in FLOAT_LEAVES:
            v = getattr(self, f)
            if v is not None:
                kw[f] = v.to(device=device, dtype=dtype)
        return dataclasses.replace(self, **kw)

    def host(self, name: str) -> np.ndarray:
        """A numeric leaf as a float64 numpy array (host-side reads at
        construction time: layouts, kernel digests)."""
        return getattr(self, name).detach().cpu().to(torch.float64).numpy()


def ancestor_mask_np(parent: Tuple[int, ...], q_start: Tuple[int, ...],
                     ndof: Tuple[int, ...], n: int) -> np.ndarray:
    """(nb, n) mask: mask[i, d] = 1 iff dof d's joint is on the path
    root..body i (inclusive)."""
    nb = len(parent)
    mask = np.zeros((nb, n), dtype=np.float64)
    for i in range(nb):
        j = i
        while j >= 0:
            mask[i, q_start[j]:q_start[j] + ndof[j]] = 1.0
            j = parent[j]
    return mask

"""Analytic primitive collision (fixed contact slots, masked), batch-first.

Every (geom, world-geom) pair contributes a fixed number of slots
(sphere / ellipsoid: 1, capsule: 2, box / cylinder / mesh: 4), and every
robot-robot pair (self pairs, and the cross-skeleton pairs of a composed
world) a fixed number by its type pair (`_self_pair_slots`); each slot is
permanently tied to one body (two for a robot-robot pair).  Inactive slots
are masked, so shapes never change.  Slot order is the static pair order:
world pairs first, then robot-robot pairs; within a pair, capsule
endpoints are ordered (end0, end1) and box corners, cylinder rim points,
mesh vertices and clipped box-box points are ranked deepest-first with
ties to the lower index.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch

from benchmark.reference.primitives import (
    box_box, capsule_box, cylinder_halfspace, dot, ellipsoid_halfspace,
    sphere_box, take_rows, topk_stable,
)
from benchmark.reference import spatial as sp
from benchmark.reference.skel_model import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_ELLIPSOID, GEOM_MESH,
    GEOM_SPHERE, SkelModel,
)

# contact slots a geom contributes against a halfspace
_WORLD_SLOTS = {GEOM_SPHERE: 1, GEOM_CAPSULE: 2, GEOM_BOX: 4,
                GEOM_CYLINDER: 4, GEOM_ELLIPSOID: 1, GEOM_MESH: 4}

_CORNERS8 = [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
             for sz in (-1.0, 1.0)]


def _self_pair_slots(ta: int, tb: int) -> int:
    """Contact slots of a robot-robot pair, by (unordered) type pair."""
    key = frozenset((ta, tb))
    if key <= {GEOM_SPHERE, GEOM_CAPSULE}:
        return 1                       # sphere / capsule closest points
    if key == {GEOM_BOX}:
        return 4                       # SAT face manifold
    if key == {GEOM_CAPSULE, GEOM_BOX}:
        return 3                       # 2 endpoint spheres + interior
    if key == {GEOM_SPHERE, GEOM_BOX}:
        return 1
    # every other convex pair: the swept-cloud SAT (collision/support.py)
    raise NotImplementedError("the reference has no swept-cloud SAT pairs")


@dataclasses.dataclass(frozen=True)
class Contacts:
    """Fixed-capacity contact sets of a batch of envs.  Slot body indices
    are static (they live on the row layout, not here)."""

    pos: Any          # (B, nc, 3) world contact position
    normal: Any       # (B, nc, 3) world normal, pointing toward body_a
    depth: Any        # (B, nc)   penetration depth (>= 0 when active)
    active: Any       # (B, nc)   {0., 1.}
    friction: Any     # (B, nc)
    restitution: Any  # (B, nc)
    # (B,) active slots beyond SolverConfig.contact_cap this substep (0
    # when the cap is off or fits): the LCP dropped that many contacts
    overflow: Any = 0.0


def slot_layout(
    model: SkelModel,
) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
    """Static slot metadata: (slot_body_a, slot_body_b, slot_geom) per
    contact slot.  body_b == -1 for world (halfspace) slots; robot-robot
    slots carry both bodies, so the constraint layer builds relative
    velocity rows (J_a - J_b)."""
    bodies_a: List[int] = []
    bodies_b: List[int] = []
    geoms: List[int] = []
    for gi, _ in model.world_pairs:
        npts = _WORLD_SLOTS[int(model.geom_type[gi])]
        bodies_a += [int(model.geom_body[gi])] * npts
        bodies_b += [-1] * npts
        geoms += [int(gi)] * npts
    for ga, gb in model.self_pairs:
        npts = _self_pair_slots(int(model.geom_type[ga]),
                                int(model.geom_type[gb]))
        bodies_a += [int(model.geom_body[ga])] * npts
        bodies_b += [int(model.geom_body[gb])] * npts
        geoms += [int(ga)] * npts
    return tuple(bodies_a), tuple(bodies_b), tuple(geoms)


def num_slots(model: SkelModel) -> int:
    return len(slot_layout(model)[0])


def _closest_on_segment(p, a, hl, u):
    """Closest point to p on segment {a + t*u, |t| <= hl} (u unit)."""
    t = torch.minimum(torch.maximum(dot(p - a, u), -hl), hl)
    return a + t[..., None] * u


def _segment_segment(pa, ua, ha, pb, ub, hb):
    """Closest points between two segments (centers p, unit dirs u,
    half-lengths h): the clamped-parameter solve, branch-free."""
    clip = lambda x, h: torch.minimum(torch.maximum(x, -h), h)
    r = pa - pb
    b = dot(ua, ub)
    c = dot(ua, r)
    f = dot(ub, r)
    denom = 1.0 - b * b            # >= 0: unit directions
    s = torch.where(denom > 1e-9,
                    (b * f - c) / torch.clamp(denom, min=1e-9), 0.0)
    s = clip(s, ha)
    t = clip(b * s + f, hb)
    s = clip(b * t - c, ha)
    return pa + s[..., None] * ua, pb + t[..., None] * ub


def _pair_points(model, gi, R, p):
    """(center, radius, axis, half_len) of a sphere / capsule geom in
    world."""
    gt = int(model.geom_type[gi])
    r = model.geom_size[..., gi, 0]
    if gt == GEOM_SPHERE:
        return p, r, None, None
    assert gt == GEOM_CAPSULE
    return p, r, R[..., :, 2], model.geom_size[..., gi, 1]


def _round_pair(model, ga, gb, Ra, pa, Rb, pb):
    """One contact of a sphere / capsule pair; the normal points from geom
    b toward geom a."""
    ca, ra, ua, ha = _pair_points(model, ga, Ra, pa)
    cb, rb, ub, hb = _pair_points(model, gb, Rb, pb)
    if ua is None and ub is None:
        qa, qb = ca, cb
    elif ua is None:
        qb = _closest_on_segment(ca, cb, hb, ub)
        qa = ca
    elif ub is None:
        qa = _closest_on_segment(cb, ca, ha, ua)
        qb = cb
    else:
        qa, qb = _segment_segment(ca, ua, ha, cb, ub, hb)
    d = qa - qb
    dist = torch.linalg.vector_norm(d, dim=-1)
    # safe normal for the coincident case (masked out by depth anyway)
    n = d / torch.clamp(dist, min=1e-9)[..., None]
    depth = (ra + rb) - dist
    pos = 0.5 * ((qa - n * ra[..., None]) + (qb + n * rb[..., None]))
    return pos[..., None, :], n[..., None, :], depth[..., None]


def collide_self_pair(model: SkelModel, ga: int, gb: int, Ra, pa, Rb, pb):
    """Robot-robot pair dispatch: (pos (B, k, 3), normal (B, k, 3), depth
    (B, k)) with the static slot count of `_self_pair_slots`.  Normals
    point from geom b toward geom a."""
    ta, tb = int(model.geom_type[ga]), int(model.geom_type[gb])
    size = lambda g: model.geom_size[..., g, :]

    if {ta, tb} <= {GEOM_SPHERE, GEOM_CAPSULE}:
        return _round_pair(model, ga, gb, Ra, pa, Rb, pb)

    if ta == GEOM_BOX and tb == GEOM_BOX:
        return box_box(Ra, pa, size(ga), Rb, pb, size(gb))

    # mixed round-vs-box: the primitives take (round, box) and return
    # normals box -> round; flip when the BOX is geom a
    if GEOM_BOX in (ta, tb) and {ta, tb} <= {GEOM_BOX, GEOM_SPHERE,
                                             GEOM_CAPSULE}:
        flip = ta == GEOM_BOX
        g_r, p_r = (gb, pb) if flip else (ga, pa)
        g_b, R_b, p_b = (ga, Ra, pa) if flip else (gb, Rb, pb)
        if int(model.geom_type[g_r]) == GEOM_CAPSULE:
            poses = {ga: (Ra, pa), gb: (Rb, pb)}
            return _capsule_box_pairs(model, [(ga, gb)], poses.__getitem__)
        pos, n, dep = sphere_box(p_r, size(g_r)[..., 0], R_b, p_b, size(g_b))
        n = -n if flip else n
        return pos[..., None, :], n[..., None, :], dep[..., None]

    # general convex pair: swept-cloud direction-set SAT
    raise NotImplementedError("the reference has no swept-cloud SAT pairs")


def _halfspace_point(p, r, normal, offset):
    """Sphere of radius r centered at p (..., 3) vs halfspace
    {x: n.x >= offset}."""
    dist = torch.sum(p * normal, dim=-1) - offset
    depth = r - dist
    pos = p - normal * dist[..., None]
    return pos, depth


def _deepest4(pts, dist, n):
    """The 4 deepest of candidate points pts (B, P, 3) at signed plane
    distances dist (B, P), projected onto the plane: (pos, depth)."""
    cdep, top_i = topk_stable(-dist, 4)
    return (take_rows(pts, top_i)
            - torch.gather(dist, 1, top_i)[..., None] * n), cdep


def _geom_pose(model, R_w, p_w, gi):
    """World pose of geom gi; its local frame may carry a leading env axis
    (domain randomization)."""
    bidx = int(model.geom_body[gi])
    Rb = R_w[:, bidx]
    return (sp.mm(Rb, model.geom_rot[..., gi, :, :]),
            p_w[:, bidx] + sp.mv(Rb, model.geom_pos[..., gi, :]))


def _is_capsule_box(model, pair) -> bool:
    return {int(model.geom_type[g]) for g in pair} == {GEOM_CAPSULE,
                                                        GEOM_BOX}


def _self_pair_runs(model):
    """The self pairs in order, as runs: consecutive capsule-box pairs of
    one orientation form one run (collided in one `_capsule_box_pairs`
    call), any other pair a run of its own."""
    runs = []
    kind = lambda pr: (int(model.geom_type[pr[0]]),
                       int(model.geom_type[pr[1]]))
    for pr in model.self_pairs:
        if (runs and _is_capsule_box(model, pr)
                and kind(runs[-1][-1]) == kind(pr)):
            runs[-1].append(pr)
        else:
            runs.append([pr])
    return runs


def _capsule_box_pairs(model, pairs, pose):
    """Capsule-box pairs of one orientation in ONE capsule_box call over a
    pair axis, the only route of a capsule-box pair (a composed world's
    cross pairs: every collidable capsule of a robot against one box).
    pose(g) -> (R, p) of geom g, (B, 3, 3) and (B, 3).  Returns (pos,
    normal (B, 3 P, 3), depth (B, 3 P)) in pair order; normals point from
    geom b toward geom a."""
    flip = int(model.geom_type[pairs[0][0]]) == GEOM_BOX
    caps = [gb if flip else ga for ga, gb in pairs]
    boxes = [ga if flip else gb for ga, gb in pairs]

    def poses(gs):
        Rs, ps = zip(*(pose(g) for g in gs))
        return torch.stack(Rs, dim=-3), torch.stack(ps, dim=-2)

    (Rc, pc), (Rb, pb) = poses(caps), poses(boxes)
    sc, sb = model.geom_size[..., caps, :], model.geom_size[..., boxes, :]
    pos, n, dep = capsule_box(pc, Rc[..., :, 2], sc[..., 1], sc[..., 0], Rb,
                              pb, sb)
    B = pos.shape[0]
    return (pos.reshape(B, -1, 3), (-n if flip else n).reshape(B, -1, 3),
            dep.reshape(B, -1))


def collide(model: SkelModel, R_w, p_w) -> Contacts:
    """All world pairs, then all robot-robot pairs, of a batch.
    R_w: (B, nb, 3, 3), p_w: (B, nb, 3)."""
    B = R_w.shape[0]
    dtype, device = p_w.dtype, p_w.device
    pos_l, nrm_l, dep_l, fr_l, re_l = [], [], [], [], []
    for gi, wi in model.world_pairs:
        gt = int(model.geom_type[gi])
        Rg, pg = _geom_pose(model, R_w, p_w, gi)
        # every leaf may carry a leading env axis (domain randomization):
        # index from the end; n1, off1: the plane against a (B, P) cloud
        n = model.wg_normal[..., wi, :]                     # (3,) or (B, 3)
        off = model.wg_offset[..., wi]                      # () or (B,)
        n1, off1 = n[..., None, :], off[..., None]
        size = model.geom_size[..., gi, :]                  # (3,) or (B, 3)
        fric = torch.minimum(model.geom_friction[..., gi],
                             model.wg_friction[..., wi])
        rest = torch.maximum(model.geom_restitution[..., gi],
                             model.wg_restitution[..., wi])
        if gt == GEOM_SPHERE:
            cpos, cdep = _halfspace_point(pg, size[..., 0], n, off)
            cpos, cdep = cpos[:, None], cdep[:, None]
        elif gt == GEOM_CAPSULE:
            r, hl = size[..., 0:1], size[..., 1:2]
            axis = Rg[..., :, 2]
            ends = torch.stack([pg + axis * hl, pg - axis * hl], dim=1)
            cpos, cdep = _halfspace_point(ends, r, n1, off1)
        elif gt == GEOM_BOX:
            corners = torch.tensor(_CORNERS8, dtype=dtype,
                                   device=device) * size[..., None, :]
            cw = pg[:, None, :] + sp.mv(Rg[:, None], corners)   # (B, 8, 3)
            cpos, cdep = _deepest4(cw, torch.sum(cw * n1, dim=-1) - off1,
                                   n1)
        elif gt == GEOM_CYLINDER:
            cpos8, cdep8 = cylinder_halfspace(pg, Rg, size[..., 0],
                                              size[..., 1], n, off)
            cdep, top_i = topk_stable(cdep8, 4)
            cpos = take_rows(cpos8, top_i)
        elif gt == GEOM_ELLIPSOID:
            cpos, cdep = ellipsoid_halfspace(pg, Rg, size, n, off)
            cpos, cdep = cpos[:, None], cdep[:, None]
        elif gt == GEOM_MESH:
            # convex vertex cloud vs halfspace: the 4 deepest vertices
            # (the box corner rule); padded vertices sit at a finite
            # sentinel depth, so they stay inert downstream
            mi = int(model.geom_mesh[gi])
            vw = pg[:, None, :] + sp.mv(Rg[:, None], model.mesh_verts[mi])
            dist = torch.sum(vw * n1, dim=-1) - off1
            depth = torch.where(model.mesh_vmask[mi] > 0.5, -dist, -1e9)
            cdep, top_i = topk_stable(depth, 4)
            cpos = (take_rows(vw, top_i)
                    - torch.gather(dist, 1, top_i)[..., None] * n1)
        else:
            raise NotImplementedError(f"geom type {gt} vs halfspace")
        k = cdep.shape[1]
        pos_l.append(cpos)
        nrm_l.append(n1.expand(B, k, 3))
        dep_l.append(cdep)
        fr_l.append(fric.reshape(-1, 1).expand(B, k))
        re_l.append(rest.reshape(-1, 1).expand(B, k))
    for run in _self_pair_runs(model):
        if _is_capsule_box(model, run[0]):
            cpos, n, cdep = _capsule_box_pairs(
                model, run, lambda g: _geom_pose(model, R_w, p_w, g))
        else:
            (ga, gb), = run
            Ra, pa = _geom_pose(model, R_w, p_w, ga)
            Rb, pb = _geom_pose(model, R_w, p_w, gb)
            cpos, n, cdep = collide_self_pair(model, ga, gb, Ra, pa, Rb, pb)
        k = cpos.shape[1] // len(run)
        ga, gb = [g for g, _ in run], [g for _, g in run]
        fric = torch.minimum(model.geom_friction[..., ga],
                             model.geom_friction[..., gb])
        rest = torch.maximum(model.geom_restitution[..., ga],
                             model.geom_restitution[..., gb])
        pos_l.append(cpos)
        nrm_l.append(n)
        dep_l.append(cdep)
        fr_l.append(fric.repeat_interleave(k, dim=-1).expand(B, -1))
        re_l.append(rest.repeat_interleave(k, dim=-1).expand(B, -1))
    if not pos_l:
        z3 = torch.zeros((B, 0, 3), dtype=dtype, device=device)
        z = torch.zeros((B, 0), dtype=dtype, device=device)
        return Contacts(pos=z3, normal=z3, depth=z, active=z, friction=z,
                        restitution=z,
                        overflow=torch.zeros(B, dtype=dtype, device=device))
    depth = torch.cat(dep_l, dim=1)
    active = (depth > model.solver.contact_eps).to(dtype)
    cap = int(model.solver.contact_cap)
    if cap and cap < active.shape[1]:
        overflow = torch.clamp(torch.sum(active, dim=1) - cap, min=0.0)
    else:
        overflow = torch.zeros(B, dtype=dtype, device=device)
    return Contacts(
        pos=torch.cat(pos_l, dim=1), normal=torch.cat(nrm_l, dim=1),
        depth=depth, active=active,
        friction=torch.cat(fr_l, dim=1), restitution=torch.cat(re_l, dim=1),
        overflow=overflow,
    )

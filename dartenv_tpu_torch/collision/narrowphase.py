"""Analytic primitive collision (fixed contact slots, masked), batch-first.

Every (geom, world-geom) pair contributes a fixed number of slots
(sphere: 1, capsule: 2, box: 4), each slot permanently tied to one body;
inactive slots are masked, so shapes never change.  Slot order is the
static pair order; within a pair, capsule endpoints are ordered
(end0, end1) and box corners are ranked deepest-first with ties to the
lower corner index.

Ported so far: sphere / capsule / box against a halfspace.  Self pairs
and cylinder / ellipsoid / mesh geoms raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch

from dartenv_tpu_torch.math import spatial as sp
from dartenv_tpu_torch.model.skel_model import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_ELLIPSOID, GEOM_MESH,
    GEOM_SPHERE, SkelModel,
)

# contact slots a geom contributes against a halfspace
_WORLD_SLOTS = {GEOM_SPHERE: 1, GEOM_CAPSULE: 2, GEOM_BOX: 4,
                GEOM_CYLINDER: 4, GEOM_ELLIPSOID: 1, GEOM_MESH: 4}

_CORNERS8 = [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
             for sz in (-1.0, 1.0)]


@dataclasses.dataclass(frozen=True)
class Contacts:
    """Fixed-capacity contact sets of a batch of envs.  Slot body indices
    are static (they live on the row layout, not here)."""

    pos: Any          # (B, nc, 3) world contact position
    normal: Any       # (B, nc, 3) world normal, pointing toward the body
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
    contact slot; body_b == -1 for world (halfspace) slots."""
    if model.self_pairs:
        raise NotImplementedError("self-collision pairs are not ported yet")
    bodies_a: List[int] = []
    bodies_b: List[int] = []
    geoms: List[int] = []
    for gi, _ in model.world_pairs:
        npts = _WORLD_SLOTS[int(model.geom_type[gi])]
        bodies_a += [int(model.geom_body[gi])] * npts
        bodies_b += [-1] * npts
        geoms += [int(gi)] * npts
    return tuple(bodies_a), tuple(bodies_b), tuple(geoms)


def num_slots(model: SkelModel) -> int:
    return len(slot_layout(model)[0])


def topk_stable(x, k: int):
    """(values, indices) of the k largest entries along the last axis,
    value-descending with ties to the LOWER index — the order that the
    reference's top_k promises and torch.topk does not."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _halfspace_point(p, r, normal, offset):
    """Sphere of radius r centered at p (..., 3) vs halfspace
    {x: n.x >= offset}."""
    dist = torch.sum(p * normal, dim=-1) - offset
    depth = r - dist
    pos = p - normal * dist[..., None]
    return pos, depth


def collide(model: SkelModel, R_w, p_w) -> Contacts:
    """All world pairs of a batch.  R_w: (B, nb, 3, 3), p_w: (B, nb, 3)."""
    if model.self_pairs:
        raise NotImplementedError("self-collision pairs are not ported yet")
    B = R_w.shape[0]
    dtype, device = p_w.dtype, p_w.device
    pos_l, nrm_l, dep_l, fr_l, re_l = [], [], [], [], []
    for gi, wi in model.world_pairs:
        gt = int(model.geom_type[gi])
        bidx = int(model.geom_body[gi])
        Rb = R_w[:, bidx]
        Rg = sp.mm(Rb, model.geom_rot[gi])
        pg = p_w[:, bidx] + sp.mv(Rb, model.geom_pos[gi])
        n = model.wg_normal[wi]
        off = model.wg_offset[wi]
        # size, friction and restitution may carry a leading env axis
        # (domain randomization): index from the end
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
            cpos, cdep = _halfspace_point(ends, r, n, off)
        elif gt == GEOM_BOX:
            corners = torch.tensor(_CORNERS8, dtype=dtype,
                                   device=device) * size[..., None, :]
            cw = pg[:, None, :] + sp.mv(Rg[:, None], corners)   # (B, 8, 3)
            dist = torch.sum(cw * n, dim=-1) - off
            cdep, top_i = topk_stable(-dist, 4)
            cpos = (torch.gather(cw, 1, top_i[..., None].expand(B, 4, 3))
                    - torch.gather(dist, 1, top_i)[..., None] * n)
        else:
            raise NotImplementedError(
                f"geom type {gt} vs halfspace is not ported yet")
        k = cdep.shape[1]
        pos_l.append(cpos)
        nrm_l.append(n.expand(B, k, 3))
        dep_l.append(cdep)
        fr_l.append(fric.reshape(-1, 1).expand(B, k))
        re_l.append(rest.reshape(-1, 1).expand(B, k))
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

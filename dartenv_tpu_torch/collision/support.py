"""General convex pairs: sphere-swept point clouds + a direction-set SAT,
batch-first (the JAX package's collision/support.py with a leading env
axis).

  * Every convex geom is a sphere-swept point cloud (points, radius):
    sphere = 1 point + r, capsule = 2 points + r, box = 8 corners,
    cylinder = two 12-gon rims, ellipsoid = its exact supports along the
    26 grid directions, mesh = its stored convex vertex cloud.
  * Candidate axes: the 13-direction antipodal grid, both geoms' frame
    axes, the 9 cross products of the frame axes, the centroid
    difference, and each geom's static polytope features (`feature_dirs`:
    face normals and the cross products of the two geoms' edge
    directions), each in both signs.  With the features the candidate set
    holds every polytope-SAT axis of the two clouds, so the minimum
    translation direction is exact for the cloud geometry.
  * Along each axis d, pen(d) = (max_B d.b + r_B) - (min_A d.a - r_A); the
    contact normal is the axis of least pen, and the manifold is the up to
    SLOTS deepest A-vertices against B's support plane (ties to the lower
    index, `topk_stable`).

The direction tables are static numpy, built on the host once per model.
"""
from __future__ import annotations

import numpy as np
import torch

from dartenv_tpu_torch.collision.primitives import take_rows, topk_stable
from dartenv_tpu_torch.math import spatial as sp
from dartenv_tpu_torch.model.skel_model import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_ELLIPSOID, GEOM_MESH,
    GEOM_SPHERE,
)

SLOTS = 4  # manifold points per SAT pair


def _grid_directions() -> np.ndarray:
    """The 13 antipodal axis classes of the 3x3x3 grid (cube face, edge,
    corner directions), unit-normalized."""
    dirs = []
    for x in (-1, 0, 1):
        for y in (-1, 0, 1):
            for z in (-1, 0, 1):
                v = np.array([x, y, z], dtype=np.float64)
                if not v.any():
                    continue
                v = v / np.linalg.norm(v)
                if any(np.allclose(v, -u) or np.allclose(v, u)
                       for u in dirs):
                    continue
                dirs.append(v)
    return np.stack(dirs)


def _icosphere12() -> np.ndarray:
    """Icosahedron vertices (12), unit-normalized."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = []
    for a in (-1.0, 1.0):
        for b in (-phi, phi):
            v += [(0, a, b), (a, b, 0), (b, 0, a)]
    v = np.asarray(v, dtype=np.float64)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


_GRID13 = _grid_directions()
_GRID26 = np.concatenate([_GRID13, -_GRID13])
_RIM12 = np.stack([np.cos(np.arange(12) * np.pi / 6.0),
                   np.sin(np.arange(12) * np.pi / 6.0)], axis=1)
_CORNERS8 = np.array([[sx, sy, sz] for sx in (-1.0, 1.0)
                      for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)])


def cloud_size(model, gi: int) -> int:
    """Static point count of geom gi's swept-cloud representation."""
    t = int(model.geom_type[gi])
    sizes = {GEOM_SPHERE: 1, GEOM_CAPSULE: 2, GEOM_BOX: 8,
             GEOM_CYLINDER: 24, GEOM_ELLIPSOID: 26}
    if t in sizes:
        return sizes[t]
    if t == GEOM_MESH:
        return int(model.mesh_verts.shape[1])
    raise NotImplementedError(f"geom type {t}")


def _local_cloud(t: int, size):
    """Body-frame points (..., P, 3) of a box / cylinder / ellipsoid of
    size (..., 3)."""
    dev = size.device
    tab = lambda a: torch.as_tensor(a, dtype=size.dtype, device=dev)
    if t == GEOM_BOX:
        return tab(_CORNERS8) * size[..., None, :]
    if t == GEOM_CYLINDER:
        rim = tab(_RIM12) * size[..., None, 0:1]                # (.., 12, 2)
        hz = size[..., None, 1:2].expand(rim.shape[:-1] + (1,))
        return torch.cat([torch.cat([rim, hz], dim=-1),
                          torch.cat([rim, -hz], dim=-1)], dim=-2)
    # ellipsoid: the support of semi-axes e along unit d is
    # (e^2 . d) / |e . d|, so the cloud touches the surface exactly along
    # every grid direction
    d = tab(_GRID26)
    num = size[..., None, :] ** 2 * d
    den = torch.linalg.vector_norm(d * size[..., None, :], dim=-1,
                                   keepdim=True)
    return num / torch.clamp(den, min=1e-12)


def swept_cloud(model, gi: int, Rg, pg):
    """(points (..., P, 3) world, radius, mask (P,) or (..., P)) of geom
    gi at pose Rg (..., 3, 3), pg (..., 3).  P is `cloud_size`; the mask
    flags valid points (mesh padding)."""
    t = int(model.geom_type[gi])
    dtype, dev = pg.dtype, pg.device
    size = model.geom_size[..., gi, :].to(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    if t == GEOM_SPHERE:
        return pg[..., None, :], size[..., 0], torch.ones(1, dtype=dtype,
                                                          device=dev)
    if t == GEOM_CAPSULE:
        axis = Rg[..., :, 2]
        hl = size[..., 1:2]
        pts = torch.stack([pg + axis * hl, pg - axis * hl], dim=-2)
        return pts, size[..., 0], torch.ones(2, dtype=dtype, device=dev)
    if t in (GEOM_BOX, GEOM_CYLINDER, GEOM_ELLIPSOID):
        local = _local_cloud(t, size)
        pts = pg[..., None, :] + sp.mv(Rg[..., None, :, :], local)
        return pts, zero, torch.ones(local.shape[-2], dtype=dtype,
                                     device=dev)
    if t == GEOM_MESH:
        mi = int(model.geom_mesh[gi])
        verts = model.mesh_verts[mi].to(dtype)
        pts = pg[..., None, :] + sp.mv(Rg[..., None, :, :], verts)
        return pts, zero, model.mesh_vmask[mi].to(dtype)
    raise NotImplementedError(f"geom type {t}")


def _dedup_antipodal(dirs, cap):
    out = []
    for d in dirs:
        n = np.linalg.norm(d)
        if n < 1e-12:
            continue
        d = d / n
        if any(abs(d @ u) > 0.9999 for u in out):
            continue
        out.append(d)
        if len(out) >= cap:
            break
    return np.asarray(out).reshape(-1, 3)


def feature_dirs(model, gi: int):
    """Static local (face normals, edge directions) of geom gi's cloud
    polytope, numpy.  Box / capsule / cylinder sets are size-independent;
    an ellipsoid's and a mesh's come from the convex hull of its static
    local cloud (scipy), and are empty where the hull cannot be built or
    the size is per-env."""
    t = int(model.geom_type[gi])
    nothing = (np.zeros((0, 3)), np.zeros((0, 3)))
    if t == GEOM_SPHERE:
        return nothing
    if t == GEOM_CAPSULE:
        return np.zeros((0, 3)), np.array([[0.0, 0.0, 1.0]])
    if t == GEOM_BOX:
        return np.eye(3), np.eye(3)
    if t == GEOM_CYLINDER:
        # the 12-gon prism's side faces bisect the rim vertices (15 + k*30
        # deg, 6 antipodal classes); rim edges run along the in-plane
        # perpendicular, axial edges along z
        ang = np.pi / 12.0 + np.arange(6) * np.pi / 6.0
        radial = np.stack([np.cos(ang), np.sin(ang), np.zeros(6)], 1)
        axis = np.array([[0.0, 0.0, 1.0]])
        tang = np.stack([-np.sin(ang), np.cos(ang), np.zeros(6)], 1)
        return (np.concatenate([radial, axis]),
                np.concatenate([tang, axis]))
    if t == GEOM_ELLIPSOID:
        size = model.geom_size
        if size.dim() != 2:
            return nothing
        e = model.host("geom_size")[gi]
        d = np.asarray(_GRID26)
        pts = (e ** 2) * d / np.maximum(
            np.linalg.norm(d * e, axis=1, keepdims=True), 1e-12)
    elif t == GEOM_MESH:
        mi = int(model.geom_mesh[gi])
        vm = model.host("mesh_vmask")[mi] > 0.5
        pts = model.host("mesh_verts")[mi][vm]
    else:
        return nothing
    try:
        from scipy.spatial import ConvexHull

        hull = ConvexHull(pts)
    except Exception:
        return nothing
    faces = _dedup_antipodal(hull.equations[:, :3], cap=24)
    edges = []
    for simp in hull.simplices:
        for a, b in ((0, 1), (1, 2), (2, 0)):
            edges.append(pts[simp[a]] - pts[simp[b]])
    return faces, _dedup_antipodal(edges, cap=12)


def _unit_or_grid(v, ref):
    """Rows of v normalized; near-zero rows become the first grid
    direction (a harmless duplicate axis)."""
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    g = torch.as_tensor(_GRID13[0], dtype=ref.dtype, device=ref.device)
    return torch.where(n > 1e-6, v / torch.clamp(n, min=1e-9), g)


def sat_pair(ptsA, rA, maskA, ptsB, rB, maskB, Ra, Rb, featA=None,
             featB=None):
    """Direction-set SAT between swept clouds A and B (leading env axes
    broadcast).  Returns (pos (..., SLOTS, 3), normal (..., 3), depth
    (..., SLOTS)): up to SLOTS contact points with per-point depths
    (<= 0 inactive).  The normal points from B toward A.  featA / featB:
    static local (face normals, edge directions) of `feature_dirs`."""
    dtype, dev = ptsA.dtype, ptsA.device
    lead = torch.broadcast_shapes(ptsA.shape[:-2], ptsB.shape[:-2],
                                  Ra.shape[:-2], Rb.shape[:-2])
    tab = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    RaT, RbT = Ra.transpose(-1, -2), Rb.transpose(-1, -2)
    cross = sp.cross(RaT[..., :, None, :], RbT[..., None, :, :]).flatten(
        -3, -2)
    cen = (torch.mean(ptsA, dim=-2) - torch.mean(ptsB, dim=-2))[..., None, :]
    parts = [tab(_GRID13), RaT, RbT, _unit_or_grid(cross, ptsA),
             cen / torch.clamp(torch.linalg.vector_norm(cen, dim=-1,
                                                        keepdim=True),
                               min=1e-9)]
    fA, eA = featA if featA is not None else (np.zeros((0, 3)),) * 2
    fB, eB = featB if featB is not None else (np.zeros((0, 3)),) * 2
    if len(fA):
        parts.append(sp.mv(Ra[..., None, :, :], tab(fA)))
    if len(fB):
        parts.append(sp.mv(Rb[..., None, :, :], tab(fB)))
    if len(eA) and len(eB):
        ea_w = sp.mv(Ra[..., None, :, :], tab(eA))
        eb_w = sp.mv(Rb[..., None, :, :], tab(eB))
        ee = sp.cross(ea_w[..., :, None, :], eb_w[..., None, :, :]).flatten(
            -3, -2)
        parts.append(_unit_or_grid(ee, ptsA))
    dirs = torch.cat([p.expand(lead + p.shape[-2:]) for p in parts], dim=-2)
    dirs = torch.cat([dirs, -dirs], dim=-2)                     # (.., D, 3)

    dA = torch.sum(ptsA[..., :, None, :] * dirs[..., None, :, :], dim=-1)
    dB = torch.sum(ptsB[..., :, None, :] * dirs[..., None, :, :], dim=-1)
    big = 1e9
    minA = torch.amin(torch.where(maskA[..., :, None] > 0.5, dA, big), dim=-2)
    maxB = torch.amax(torch.where(maskB[..., :, None] > 0.5, dB, -big),
                      dim=-2)
    rA_, rB_ = torch.as_tensor(rA), torch.as_tensor(rB)
    pen = (maxB + rB_[..., None]) - (minA - rA_[..., None])      # (.., D)
    i = torch.argmin(pen, dim=-1)
    n = take_rows(dirs, i[..., None])[..., 0, :]

    plane = torch.gather(maxB, -1, i[..., None]) + rB_[..., None]
    depth_v = plane - (torch.gather(dA, -1, i[..., None, None].expand(
        dA.shape[:-1] + (1,)))[..., 0] - rA_[..., None])
    depth_v = torch.where(maskA > 0.5, depth_v, -big)
    pa = ptsA.shape[-2]
    ptsA = ptsA.expand(lead + ptsA.shape[-2:])
    if pa < SLOTS:
        depth_v = torch.cat([depth_v, torch.full(
            depth_v.shape[:-1] + (SLOTS - pa,), -big, dtype=dtype,
            device=dev)], dim=-1)
        ptsA = torch.cat([ptsA, ptsA.new_zeros(lead + (SLOTS - pa, 3))],
                         dim=-2)
    top_d, top_i = topk_stable(depth_v, SLOTS)
    # surface point of A along -n, pushed to the mid-penetration plane
    pos = take_rows(ptsA, top_i) - (rA_[..., None] + 0.5 * top_d)[
        ..., None] * n[..., None, :]
    return pos, n, top_d


def collide_support_pair(model, ga: int, gb: int, Ra, pa, Rb, pb):
    """A convex pair by the swept-cloud SAT; the return contract of
    narrowphase.collide_self_pair (normals point b -> a)."""
    ptsA, rA, mA = swept_cloud(model, ga, Ra, pa)
    ptsB, rB, mB = swept_cloud(model, gb, Rb, pb)
    pos, n, dep = sat_pair(ptsA, rA, mA, ptsB, rB, mB, Ra, Rb,
                           featA=feature_dirs(model, ga),
                           featB=feature_dirs(model, gb))
    return pos, n[..., None, :].expand(pos.shape), dep

"""Closed-form primitive pair tests, batch-first.

Counterparts of the JAX package's collision/primitives.py, with a leading
env axis (any leading axes broadcast): every pose is (..., 3, 3) / (..., 3)
and every result carries the same leading axes.  Each function returns a
static number of candidate contact slots with depths; callers mask by
depth sign.

Conventions (as collision/narrowphase.py):
* normals point FROM the second object TOWARD the first ("toward body_a");
* depth > 0 means penetration; inactive slots carry depth <= 0;
* candidate order is a static function of the pair; ties in a ranking go
  to the lower index (`topk_stable`), as the reference's top_k orders
  them: contact order feeds the LCP row order.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import spatial as sp


def topk_stable(x, k: int):
    """(values, indices) of the k largest entries along the last axis,
    value-descending with ties to the LOWER index — the order that the
    reference's top_k promises and torch.topk does not."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def mtv(R, v):
    """R^T v for R (..., 3, 3), v (..., 3)."""
    return torch.sum(R * v[..., :, None], dim=-2)


def take_rows(x, idx):
    """x (..., P, 3) rows idx (..., k)."""
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + (3,)))


def _col(x):
    """A per-env scalar (0-d or (...,)) as a column against (..., 3)."""
    return torch.as_tensor(x)[..., None]


def _safe_unit(v, fallback):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(n > 1e-9, v / torch.clamp(n, min=1e-9), fallback)


def _onehot3(k, dtype):
    """(..., 3) one-hot of integer indices k (...)."""
    return (torch.arange(3, device=k.device) == k[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# vs-halfspace (plane {x : n.x >= offset}, n the outward/up unit normal)
# ---------------------------------------------------------------------------

def cylinder_halfspace(p, R, radius, half_h, n, offset):
    """Cylinder (axis local z) vs halfspace: 8 rim candidates (4 per cap),
    (..., 8, 3) points on the plane and (..., 8) depths.  On its side the
    two deepest are one per cap along the steepest-descent rim direction;
    on an end cap that cap's 4 candidates span the disc."""
    az = R[..., :, 2]
    u = _safe_unit(n - _col(dot(n, az)) * az, R[..., :, 0])
    w = sp.cross(az, u)
    hh = _col(half_h)
    caps = torch.stack([p + hh * az, p - hh * az], dim=-2)     # (.., 2, 3)
    dirs = torch.stack([-u, u, w, -w], dim=-2) * _col(_col(radius))
    pts = (caps[..., :, None, :] + dirs[..., None, :, :]).flatten(-3, -2)
    # the plane (n (..., 3), offset (...) or a number) against the 8 points
    n8 = n[..., None, :]
    off8 = offset[..., None] if torch.is_tensor(offset) else offset
    dist = torch.sum(pts * n8, dim=-1) - off8
    return pts - dist[..., None] * n8, -dist


def ellipsoid_halfspace(p, R, radii, n, offset):
    """Ellipsoid (semi-axes `radii` along local axes) vs halfspace: the
    support point in -n, closed form.  Returns (..., 3), (...)."""
    nl = mtv(R, n.expand_as(p))
    er = radii * nl
    r_eff = torch.clamp(torch.linalg.vector_norm(er, dim=-1), min=1e-12)
    pt = p - sp.mv(R, radii * er) / r_eff[..., None]
    dist = torch.sum(pt * n, dim=-1) - offset
    return pt - dist[..., None] * n, -dist


# ---------------------------------------------------------------------------
# sphere / capsule vs box
# ---------------------------------------------------------------------------

def _closest_on_box(c_local, h):
    """Closest point on an origin-centered AABB (half extents h) to c,
    with the interior case pushed out through the nearest face.  Returns
    (point_local, normal_local, depth): depth > 0 iff c is inside; for an
    exterior point depth is the negative gap and the normal points from
    the box surface toward c."""
    dtype = c_local.dtype
    h = h.expand_as(c_local)
    clamped = torch.minimum(torch.maximum(c_local, -h), h)
    delta = c_local - clamped
    gap = torch.linalg.vector_norm(delta, dim=-1)
    inside = gap < 1e-12
    face_d = h - torch.abs(c_local)
    k = torch.argmin(face_d, dim=-1)
    oh = _onehot3(k, dtype)
    ck = torch.gather(c_local, -1, k[..., None])[..., 0]
    sgn = torch.where(ck >= 0.0, 1.0, -1.0).to(dtype)
    n_in = oh * sgn[..., None]
    hk = torch.gather(h, -1, k[..., None])[..., 0]
    p_in = torch.where(oh > 0.5, (sgn * hk)[..., None], c_local)
    n_out = _safe_unit(delta, n_in)
    point = torch.where(inside[..., None], p_in, clamped)
    normal = torch.where(inside[..., None], n_in, n_out)
    fk = torch.gather(face_d, -1, k[..., None])[..., 0]
    depth = torch.where(inside, fk, -gap)
    return point, normal, depth


def sphere_box(c, r, Rb, pb, hb):
    """Sphere (center c, radius r) vs OBB: 1 candidate (pos, normal
    (..., 3), depth (...)).  Normal points from the box toward the
    sphere."""
    cl = mtv(Rb, c - pb)
    pt_l, n_l, depth_c = _closest_on_box(cl, hb)
    pos = sp.mv(Rb, pt_l) + pb
    normal = sp.mv(Rb, n_l)
    return pos, normal, depth_c + r


def capsule_box(pc, uc, hc, r, Rb, pb, hb, iters: int = 32):
    """Capsule (center pc, unit axis uc, half length hc, radius r) vs OBB:
    3 candidates — both endpoint spheres + the interior closest point,
    found by a fixed-trip-count ternary search on the convex distance
    t -> dist(segment(t), box), the same arithmetic per iteration as the
    reference.  The interior candidate is masked (depth -1e9) when it
    coincides with an endpoint.  Returns (..., 3, 3) pos and normals,
    (..., 3) depths."""
    hb = hb.expand_as(pc)
    hc = torch.as_tensor(hc, dtype=pc.dtype, device=pc.device)

    def box_dist2(t):
        cl = mtv(Rb, (pc + _col(t) * uc) - pb)
        d = cl - torch.minimum(torch.maximum(cl, -hb), hb)
        return torch.sum(d * d, dim=-1)

    a = (-hc).expand(pc.shape[:-1])
    b = hc.expand(pc.shape[:-1])
    for _ in range(iters):
        m1 = a + (b - a) / 3.0
        m2 = b - (b - a) / 3.0
        go_right = box_dist2(m1) > box_dist2(m2)
        a, b = torch.where(go_right, m1, a), torch.where(go_right, b, m2)
    t_star = 0.5 * (a + b)
    ends = torch.stack([pc + _col(hc) * uc, pc - _col(hc) * uc,
                        pc + _col(t_star) * uc], dim=-2)
    pos, normal, depth = sphere_box(ends, _col(r), Rb[..., None, :, :],
                                    pb[..., None, :], hb[..., None, :])
    near_end = (torch.minimum(torch.abs(t_star - hc), torch.abs(t_star + hc))
                < 1e-4 * torch.clamp(hc, min=1e-9))
    depth = torch.cat([depth[..., :2],
                       torch.where(near_end, -1e9, depth[..., 2])[..., None]],
                      dim=-1)
    return pos, normal, depth


# ---------------------------------------------------------------------------
# box vs box: SAT + reference-face clipping (a deterministic 4-point
# manifold)
# ---------------------------------------------------------------------------

_EDGE_PAIRS = np.array([(i, j) for i in range(3) for j in range(3)])
_NEG_INF = float("-inf")


def _face_clip(ref_R, ref_p, ref_h, ref_axis_k: int, ref_sign,
               inc_R, inc_p, inc_h):
    """Clip the incident box face against the reference face's 4 side
    planes (Sutherland-Hodgman on fixed-size vertex rings of 8, valid
    vertices compacted to the front in ring order).  Returns (points
    (..., 8, 3) world, depth (..., 8)) measured along the reference face
    normal; invalid slots carry depth -inf."""
    dtype = ref_p.dtype
    n_ref = ref_sign[..., None] * ref_R[..., :, ref_axis_k]
    i1 = (ref_axis_k + 1) % 3
    i2 = (ref_axis_k + 2) % 3
    t1, t2 = ref_R[..., :, i1], ref_R[..., :, i2]
    face_c = ref_p + n_ref * ref_h[..., ref_axis_k, None]

    # incident face: outward normal most anti-parallel to n_ref
    dots = mtv(inc_R, n_ref)
    k_inc = torch.argmax(torch.abs(dots), dim=-1)
    dk = torch.gather(dots, -1, k_inc[..., None])[..., 0]
    s_inc = -torch.sign(dk + 1e-30)
    n_inc_l = _onehot3(k_inc, dtype)
    e1 = _onehot3((k_inc + 1) % 3, dtype)
    e2 = _onehot3((k_inc + 2) % 3, dtype)
    h1 = torch.sum(inc_h * e1, dim=-1)[..., None]
    h2 = torch.sum(inc_h * e2, dim=-1)[..., None]
    base = n_inc_l * (s_inc * torch.sum(inc_h * n_inc_l, dim=-1))[..., None]
    quad_l = torch.stack([
        base + h1 * e1 + h2 * e2,
        base - h1 * e1 + h2 * e2,
        base - h1 * e1 - h2 * e2,
        base + h1 * e1 - h2 * e2,
    ], dim=-2)
    verts = sp.mv(inc_R[..., None, :, :], quad_l) + inc_p[..., None, :]

    lead = verts.shape[:-2]
    pts = torch.cat([verts, verts.new_zeros(lead + (4, 3))], dim=-2)
    valid = torch.cat([torch.ones(lead + (4,), dtype=torch.bool,
                                  device=verts.device),
                       torch.zeros(lead + (4,), dtype=torch.bool,
                                   device=verts.device)], dim=-1)
    nv = 8
    ar = torch.arange(nv, device=verts.device)

    def clip(pts, valid, t_axis, h_t, sgn):
        # clip to sgn * (x - face_c).t <= h_t; d > 0 is outside
        d = sgn * torch.sum((pts - face_c[..., None, :])
                            * t_axis[..., None, :], dim=-1) - h_t[..., None]
        k_valid = torch.sum(valid, dim=-1, keepdim=True)
        # ring successor: the LAST valid vertex wraps to slot 0; past the
        # end an index clamps to the last slot, as the reference's gather
        nxt = torch.where(ar == k_valid - 1, 0,
                          torch.clamp(ar + 1, max=nv - 1))
        valid_next = torch.gather(valid, -1, nxt)
        p_next = take_rows(pts, nxt)
        d_next = torch.gather(d, -1, nxt)
        inside = d <= 0.0
        inside_next = d_next <= 0.0
        denom = d - d_next
        tpar = d / torch.where(torch.abs(denom) > 1e-12, denom,
                               torch.full_like(denom, 1e-12))
        cross_pt = pts + (p_next - pts) * tpar[..., None]
        crossing = valid & valid_next & (inside != inside_next)
        keep = valid & inside
        # interleave kept verts and crossings (ring order), then compact
        # the valid ones to the front with a stable sort
        out_pts = torch.stack([pts, cross_pt], dim=-2).flatten(-3, -2)
        out_valid = torch.stack([keep, crossing], dim=-1).flatten(-2)
        order = torch.argsort(torch.where(out_valid, 0, 1), dim=-1,
                              stable=True)[..., :nv]
        return take_rows(out_pts, order), torch.gather(out_valid, -1, order)

    one = torch.ones((), dtype=dtype, device=verts.device)
    for t_axis, h_t, sgn in ((t1, ref_h[..., i1], one),
                             (t1, ref_h[..., i1], -one),
                             (t2, ref_h[..., i2], one),
                             (t2, ref_h[..., i2], -one)):
        pts, valid = clip(pts, valid, t_axis, h_t, sgn)

    depth = -torch.sum((pts - face_c[..., None, :]) * n_ref[..., None, :],
                       dim=-1)
    return pts, torch.where(valid, depth, _NEG_INF)


def box_box(Ra, pa, ha, Rb, pb, hb):
    """OBB vs OBB: SAT over 15 axes + face clipping.  4 candidates:
    (pos (..., 4, 3), normal (..., 4, 3), depth (..., 4)).

    Normal points from box b toward box a.  Face contacts give up to 4
    clipped points; an edge-edge contact gives 1 (the other slots carry
    depth -1).  Edge axes need 5 % more penetration to win (manifold
    stability, as in the reference)."""
    dtype, device = pa.dtype, pa.device
    lead = pa.shape[:-1]
    ha = ha.expand(lead + (3,))
    hb = hb.expand(lead + (3,))
    R = torch.sum(Ra[..., :, :, None] * Rb[..., :, None, :], dim=-3)
    t = mtv(Ra, pb - pa)
    absR = torch.abs(R) + 1e-9

    dep_a = (ha + sp.mv(absR, hb)) - torch.abs(t)
    dep_b = (hb + mtv(absR, ha)) - torch.abs(mtv(R, t))

    ei = torch.as_tensor(_EDGE_PAIRS[:, 0], device=device)
    ej = torch.as_tensor(_EDGE_PAIRS[:, 1], device=device)
    eye = torch.eye(3, dtype=dtype, device=device)
    RT = R.transpose(-1, -2)
    axes_e = sp.cross(eye[ei].expand(lead + (9, 3)), RT[..., ej, :])
    norm_e = torch.linalg.vector_norm(axes_e, dim=-1)
    unit_e = axes_e / torch.clamp(norm_e, min=1e-9)[..., None]
    ra_e = torch.sum(torch.abs(unit_e) * ha[..., None, :], dim=-1)
    rb_e = torch.sum(torch.abs(sp.mm(unit_e, R)) * hb[..., None, :], dim=-1)
    dep_e = (ra_e + rb_e) - torch.abs(torch.sum(unit_e * t[..., None, :],
                                                dim=-1))
    dep_e = torch.where(norm_e > 1e-6, dep_e, float("inf"))

    deps = torch.cat([dep_a, dep_b, dep_e * 1.05 + 1e-9], dim=-1)
    separated = torch.amin(deps, dim=-1) < 0.0
    code = torch.argmin(deps, dim=-1)    # 0-2 face a, 3-5 face b, 6-14 edge

    def face_manifold(use_a: bool):
        k = code if use_a else code - 3
        onehot = _onehot3(k, dtype)
        refR, incR = (Ra, Rb) if use_a else (Rb, Ra)
        refp, incp = (pa, pb) if use_a else (pb, pa)
        refh, inch = (ha, hb) if use_a else (hb, ha)
        axis_w = sp.mv(refR, onehot)
        sgn = torch.sign(dot(axis_w, incp - refp) + 1e-30)
        outs = [_face_clip(refR, refp, refh, kk, sgn, incR, incp, inch)
                for kk in range(3)]
        pts = torch.stack([o[0] for o in outs], dim=-3)     # (.., 3, 8, 3)
        dep = torch.stack([o[1] for o in outs], dim=-2)     # (.., 3, 8)
        sel = onehot > 0.5
        pts = torch.where(sel[..., None, None], pts, 0.0).sum(-3)
        dep = torch.amax(torch.where(sel[..., None], dep, _NEG_INF), dim=-2)
        return pts, dep, sgn[..., None] * axis_w

    pts_fa, dep_fa, n_fa = face_manifold(True)
    pts_fb, dep_fb, n_fb = face_manifold(False)

    # ---- edge-edge single contact ----------------------------------------
    ecode = torch.clamp(code - 6, 0, 8)
    onehot_e = (torch.arange(9, device=device) == ecode[..., None]).to(dtype)
    ui_l = eye[ei]
    l_a = torch.sum(onehot_e[..., None] * unit_e, dim=-2)
    sgn_e = torch.sign(dot(l_a, t) + 1e-30)[..., None]
    n_edge_a = -sgn_e * l_a
    ca = torch.sign(l_a * sgn_e) * ha
    ua = torch.sum(onehot_e[..., None] * ui_l, dim=-2)
    ca = ca - ca * torch.abs(ua)
    l_b = mtv(R, l_a)
    ub_onehot = (torch.arange(3, device=device)[None, :]
                 == ej[:, None]).to(dtype)
    ub_sel = torch.sum(onehot_e[..., None] * ub_onehot, dim=-2)
    cb_l = -torch.sign(l_b * sgn_e) * hb
    cb_l = cb_l - cb_l * ub_sel
    cb = t + sp.mv(R, cb_l)
    ub = sp.mv(R, ub_sel)
    r_ab = ca - cb
    d1 = dot(ua, ub)
    denom = torch.clamp(1.0 - d1 * d1, min=1e-9)
    s_par = (d1 * dot(ub, r_ab) - dot(ua, r_ab)) / denom
    t_par = (dot(ub, r_ab) - d1 * dot(ua, r_ab)) / denom
    p_edge_a = ca + s_par[..., None] * ua
    p_edge_b = cb + t_par[..., None] * ub
    pt_edge = sp.mv(Ra, 0.5 * (p_edge_a + p_edge_b)) + pa
    dep_edge = torch.amax(torch.where(
        torch.arange(9, device=device) == ecode[..., None], dep_e,
        _NEG_INF), dim=-1)
    n_edge = sp.mv(Ra, n_edge_a)

    # ---- select ----------------------------------------------------------
    is_fa = (code < 3)[..., None]
    is_fb = ((code >= 3) & (code < 6))[..., None]
    pts_edge8 = torch.cat([pt_edge[..., None, :],
                           pt_edge.new_zeros(lead + (7, 3))], dim=-2)
    dep_edge8 = torch.cat([dep_edge[..., None],
                           torch.full(lead + (7,), _NEG_INF, dtype=dtype,
                                      device=device)], dim=-1)
    pts = torch.where(is_fa[..., None], pts_fa,
                      torch.where(is_fb[..., None], pts_fb, pts_edge8))
    dep = torch.where(is_fa, dep_fa, torch.where(is_fb, dep_fb, dep_edge8))
    normal = torch.where(is_fa, -n_fa, torch.where(is_fb, n_fb, n_edge))

    top_d, top_i = topk_stable(dep, 4)
    top_d = torch.where(separated[..., None], _NEG_INF, top_d)
    top_d = torch.where(torch.isfinite(top_d), top_d, -1.0)
    return (take_rows(pts, top_i), normal[..., None, :].expand(lead + (4, 3)),
            top_d)

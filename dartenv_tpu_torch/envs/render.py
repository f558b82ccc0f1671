"""Software renderer for `rgb_array` frames: perspective, COM-tracked.

The reference renders through GLUT/OpenGL with a trackball camera whose
translation tracks `skeletons[track_skeleton_id].com()`.  This is a
pure-numpy rasterizer with the same camera model: pinhole perspective,
azimuth/elevation orbit about a tracked look-at point (the robot COM),
checkerboard ground plane, painter's-order primitives.  The body poses
come from dynamics/algorithms.fk_positions of the env's (1, n) state, on
the model's device; everything after is host numpy.  A primitive with a
point behind the camera (depth below _NEAR) is skipped.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dartenv_tpu_torch.dynamics.algorithms import fk_positions
from dartenv_tpu_torch.model.skel_model import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_ELLIPSOID, GEOM_MESH,
    GEOM_SPHERE,
    SkelModel,
)

_COLORS = np.array([
    [66, 133, 244], [219, 68, 55], [244, 180, 0], [15, 157, 88],
    [171, 71, 188], [0, 172, 193], [255, 112, 67], [158, 157, 36],
], dtype=np.uint8)

_SKY = np.array([235, 241, 250], dtype=np.uint8)
_CHECK_A = np.array([205, 205, 205], dtype=np.uint8)
_CHECK_B = np.array([175, 175, 175], dtype=np.uint8)
# nearest depth (m) in front of the camera a drawn primitive may reach
_NEAR = 1e-3


@dataclasses.dataclass
class Camera:
    """Orbit camera (reference: pydart2 Trackball semantics).

    The look-at point tracks the robot COM each frame (reference:
    `StaticGLUTWindow` translating by `skeletons[id].com()`); azimuth is
    measured in the x-z plane from +z toward +x, elevation upward.
    """

    azimuth: float = 0.0          # deg; 0 looks along -z (side view)
    elevation: float = -12.0      # deg; negative looks slightly down
    distance: float = 4.0         # m from the look-at point
    fov_y: float = 45.0           # deg vertical field of view
    lookat_offset: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    track: bool = True            # follow the skeleton COM

    def pose(self, lookat):
        az = np.deg2rad(self.azimuth)
        el = np.deg2rad(self.elevation)
        # camera forward direction (from eye toward lookat)
        fwd = np.array([
            -np.sin(az) * np.cos(el), np.sin(el), -np.cos(az) * np.cos(el)
        ])
        fwd = fwd / np.linalg.norm(fwd)
        eye = lookat - fwd * self.distance
        up0 = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up0)
        right /= max(np.linalg.norm(right), 1e-9)
        up = np.cross(right, fwd)
        # world -> camera rotation (rows: right, up, -fwd)
        R = np.stack([right, up, -fwd])
        return R, eye


def _skeleton_com(model: SkelModel, R_w, p_w) -> np.ndarray:
    mass = model.host("mass")
    coms = p_w + np.einsum("bij,bj->bi", R_w, model.host("com"))
    return (mass[:, None] * coms).sum(0) / max(mass.sum(), 1e-9)


def render_frame(model: SkelModel, sim_state, width: int = 320,
                 height: int = 240, track_body: Optional[int] = None,
                 camera: Optional[Camera] = None, scale: float = None):
    """Perspective frame (H, W, 3) uint8 of one env's state (sim_state.q
    of shape (1, n) or (n,))."""
    cam = camera or Camera()
    R_w, p_w = fk_positions(model, sim_state.q.reshape(1, -1))
    R_w = R_w[0].detach().to("cpu", torch.float64).numpy()
    p_w = p_w[0].detach().to("cpu", torch.float64).numpy()

    if cam.track:
        if track_body is not None and track_body < model.nb:
            look = p_w[track_body].copy()
        else:
            look = _skeleton_com(model, R_w, p_w)
    else:
        look = np.zeros(3)
    look = look + cam.lookat_offset
    R_c, eye = cam.pose(look)

    f = (height / 2.0) / np.tan(np.deg2rad(cam.fov_y) / 2.0)
    cx_px, cy_px = width / 2.0, height / 2.0

    def project(pts):
        """world (N,3) -> (u, v, depth) pixel coords; depth = cam -z (a
        point behind the camera keeps its depth <= 0, and its u, v are
        not used)."""
        pc = (pts - eye) @ R_c.T
        z = -pc[..., 2]
        zs = np.where(z < _NEAR, 1.0, z)
        u = cx_px + f * pc[..., 0] / zs
        v = cy_px - f * pc[..., 1] / zs
        return u, v, z

    def front(z):
        return bool(np.all(z >= _NEAR))

    img = np.empty((height, width, 3), dtype=np.uint8)
    img[:] = _SKY

    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)

    # ---- ground: per-pixel ray / plane intersection with checkerboard ----
    if model.wg_offset is not None and model.wg_offset.shape[0]:
        n = model.host("wg_normal")[0]
        off = float(model.host("wg_offset")[0])
        # ray dirs in world: R_c^T @ [x_n, y_n, -1]
        dirs_c = np.stack([
            (xx - cx_px) / f, (cy_px - yy) / f, -np.ones_like(xx)
        ], axis=-1)
        dirs_w = dirs_c @ R_c           # (H, W, 3), rows^T applied
        denom = dirs_w @ n
        t = (off - eye @ n) / np.where(np.abs(denom) > 1e-9, denom, 1e-9)
        hit = (t > 0) & (denom < 0)
        pts = eye + dirs_w * t[..., None]
        checker = ((np.floor(pts[..., 0]) + np.floor(pts[..., 2]))
                   % 2).astype(bool)
        img[hit & checker] = _CHECK_A
        img[hit & ~checker] = _CHECK_B

    # ---- geom-less models: stick-figure fallback -------------------------
    # Some tasks are authored without shapes (cartpole / reacher-class pure
    # dynamics: collision never runs, inertia is explicit in the .skel).
    # The reference still draws them from their visualization shapes;
    # here a viewer-only stick figure: a disk per body and a link capsule
    # along each tree edge.
    com_b = model.host("com")
    if model.ng == 0:
        none = np.zeros_like(xx, dtype=bool)

        def disk(center, r_m):
            u, v, z = project(center[None])
            if not front(z):
                return none
            rp = f * r_m / z[0]
            return (xx - u[0]) ** 2 + (yy - v[0]) ** 2 <= rp * rp

        def segment(a, b, r_m):
            u, v, z = project(np.stack([a, b]))
            if not front(z):
                return none
            rp = f * r_m / z.mean()
            dx, dy = u[1] - u[0], v[1] - v[0]
            den = max(dx * dx + dy * dy, 1e-9)
            t = np.clip(((xx - u[0]) * dx + (yy - v[0]) * dy) / den, 0, 1)
            return ((xx - (u[0] + t * dx)) ** 2
                    + (yy - (v[0] + t * dy)) ** 2) <= rp * rp
        for b in range(model.nb):
            pb = int(model.parent[b])
            if pb >= 0:
                img[segment(p_w[pb], p_w[b], 0.03)] = _COLORS[
                    pb % len(_COLORS)]
            # extend the last link through the body COM so a single
            # offset-COM child (cartpole's pole) reads as a rod
            com_w = p_w[b] + R_w[b] @ com_b[b]
            if np.linalg.norm(com_w - p_w[b]) > 1e-6:
                img[segment(p_w[b], p_w[b] + 2.0 * (com_w - p_w[b]),
                            0.03)] = _COLORS[b % len(_COLORS)]
            img[disk(p_w[b], 0.05)] = _COLORS[b % len(_COLORS)]
        return img

    # ---- geoms, painter's order (far first) ------------------------------
    ng = model.ng
    geom_pos, geom_rot = model.host("geom_pos"), model.host("geom_rot")
    geom_size = model.host("geom_size")
    order = []
    for gi in range(ng):
        b = int(model.geom_body[gi])
        pg = p_w[b] + R_w[b] @ geom_pos[gi]
        depth = np.linalg.norm(pg - eye)
        order.append((depth, gi))
    order.sort(reverse=True)

    for _, gi in order:
        b = int(model.geom_body[gi])
        Rg = R_w[b] @ geom_rot[gi]
        pg = p_w[b] + R_w[b] @ geom_pos[gi]
        gt = int(model.geom_type[gi])
        size = geom_size[gi]
        color = _COLORS[b % len(_COLORS)]

        if gt in (GEOM_SPHERE, GEOM_ELLIPSOID):
            r = float(size[0] if gt == GEOM_SPHERE else size.max())
            u, v, z = project(pg[None])
            if not front(z):
                continue
            rp = f * r / z[0]
            mask = (xx - u[0]) ** 2 + (yy - v[0]) ** 2 <= rp * rp
        elif gt in (GEOM_CAPSULE, GEOM_CYLINDER):
            axis = Rg[:, 2]
            ends = np.stack([pg + axis * size[1], pg - axis * size[1]])
            u, v, z = project(ends)
            if not front(z):
                continue
            rp = f * float(size[0]) / z.mean()
            dx, dy = u[1] - u[0], v[1] - v[0]
            den = max(dx * dx + dy * dy, 1e-9)
            t = np.clip(((xx - u[0]) * dx + (yy - v[0]) * dy) / den, 0, 1)
            px = u[0] + t * dx
            py = v[0] + t * dy
            mask = (xx - px) ** 2 + (yy - py) ** 2 <= rp * rp
        elif gt == GEOM_BOX:
            corners = np.array([[sx, sy, sz]
                                for sx in (-1.0, 1.0)
                                for sy in (-1.0, 1.0)
                                for sz in (-1.0, 1.0)]) * size
            cw = pg + corners @ Rg.T
            u, v, z = project(cw)
            if not front(z):
                continue
            mask = _convex_hull_mask(u, v, xx, yy)
        elif gt == GEOM_MESH and model.mesh_verts is not None:
            mi = model.geom_mesh[gi]
            verts = model.host("mesh_verts")[mi]
            vmask = model.host("mesh_vmask")[mi] > 0.5
            cw = pg + verts[vmask] @ Rg.T
            u, v, z = project(cw)
            if not front(z):
                continue
            mask = _convex_hull_mask(u, v, xx, yy)
        else:                           # pragma: no cover
            continue
        # simple depth cue: darken with distance
        img[mask] = color
    return img


def _convex_hull_mask(u, v, xx, yy):
    """Filled convex hull of projected points (Andrew's monotone chain +
    half-plane tests, fully vectorized over pixels)."""
    pts = np.stack([u, v], axis=1)
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross2(a, b):
        # scalar 2-D cross product (np.cross on 2-D vectors is removed in
        # NumPy 2.0)
        return a[0] * b[1] - a[1] * b[0]

    def half(points):
        out = []
        for p in points:
            while len(out) >= 2 and cross2(
                    out[-1] - out[-2], p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    hull = np.asarray(lower[:-1] + upper[:-1])
    if hull.shape[0] < 3:
        return np.zeros_like(xx, dtype=bool)
    mask = np.ones_like(xx, dtype=bool)
    for i in range(hull.shape[0]):
        a = hull[i]
        b = hull[(i + 1) % hull.shape[0]]
        # inside = left of every edge (hull is CCW in pixel coords)
        mask &= (b[0] - a[0]) * (yy - a[1]) - (b[1] - a[1]) * (xx - a[0]) \
            >= 0
    return mask

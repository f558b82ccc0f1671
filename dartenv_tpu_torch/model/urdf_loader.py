"""URDF robot parser -> SkelModel (stdlib xml.etree), producing the same
SkelModel the .skel parser emits, on an explicit device and dtype.

URDF conventions honored:
* `<joint><origin>` is the joint (== child link) frame in the PARENT link
  frame -> T_pj = origin, T_cj = identity;
* `<inertial><origin>` gives the COM offset and inertia frame in the link
  frame (inertia rotated into the link frame);
* joint types: fixed -> WELD, revolute/continuous -> REVOLUTE (continuous
  unlimited), prismatic -> PRISMATIC, floating -> FREE, planar -> PLANAR;
  any other type raises NotImplementedError;
* `<limit lower upper>` / `<dynamics damping friction>` map to per-dof
  arrays (effort and velocity limits are not enforced, as in DART);
* geometry: sphere and box map exactly; a cylinder becomes a capsule of
  equal radius and half-length (the capsule is conservative at the caps);
  a `<mesh>` (OBJ or STL; `package://` stripped, relative paths taken
  from the URDF file's directory) becomes a convex vertex-cloud geom
  with its vertex-based inertia (model/mesh_loader, builder.mesh_inertia);
  other mesh formats raise NotImplementedError.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np
import torch

from dartenv_tpu_torch.model import skel_model as sm
from dartenv_tpu_torch.model.builder import (
    ModelBuilder, box_inertia, cylinder_inertia, mesh_inertia, rpy_to_mat,
    sphere_inertia,
)
from dartenv_tpu_torch.model.mesh_loader import load_mesh

_JOINT_TYPES = {
    "fixed": sm.WELD,
    "revolute": sm.REVOLUTE,
    "continuous": sm.REVOLUTE,
    "prismatic": sm.PRISMATIC,
    "floating": sm.FREE,
    "planar": sm.PLANAR,
}


def _floats(text, default=None):
    if text is None:
        return default
    return np.asarray([float(x) for x in text.split()], dtype=np.float64)


def _origin(elem):
    """(R, p) of an <origin xyz rpy> child (identity if absent)."""
    o = elem.find("origin") if elem is not None else None
    if o is None:
        return np.eye(3), np.zeros(3)
    xyz = _floats(o.get("xyz"), np.zeros(3))
    rpy = _floats(o.get("rpy"), np.zeros(3))
    return rpy_to_mat(*rpy), xyz


def _geometry(geom_elem, base_dir=None):
    """(gtype or "mesh", size (3,) or the mesh's vertices, inertia_fn)."""
    box = geom_elem.find("box")
    if box is not None:
        half = _floats(box.get("size")) / 2.0
        return sm.GEOM_BOX, half, lambda m: box_inertia(m, half)
    sph = geom_elem.find("sphere")
    if sph is not None:
        r = float(sph.get("radius"))
        return (sm.GEOM_SPHERE, np.array([r, 0.0, 0.0]),
                lambda m: sphere_inertia(m, r))
    cyl = geom_elem.find("cylinder")
    if cyl is not None:
        r = float(cyl.get("radius"))
        ln = float(cyl.get("length"))
        return (sm.GEOM_CAPSULE, np.array([r, ln / 2.0, 0.0]),
                lambda m: cylinder_inertia(m, r, ln))
    mesh = geom_elem.find("mesh")
    if mesh is not None:
        fn = mesh.get("filename")
        if fn is None:
            raise ValueError("URDF <mesh> without filename")
        if fn.startswith("package://"):
            fn = fn[len("package://"):]
        if base_dir is not None and not os.path.isabs(fn):
            fn = os.path.join(base_dir, fn)
        verts = load_mesh(fn, scale=_floats(mesh.get("scale"), np.ones(3)))
        return "mesh", verts, lambda m: mesh_inertia(m, verts)
    raise ValueError("URDF geometry element with no known shape")


def parse_urdf(path_or_string: str, dtype=torch.float32,
               root_joint: Optional[int] = None,
               solver: Optional[sm.SolverConfig] = None,
               dt: float = 0.002,
               gravity=(0.0, -9.81, 0.0),
               ground: bool = False, device="cuda") -> sm.SkelModel:
    """Parse a URDF file (or its XML text) into a SkelModel on `device`.

    root_joint: joint type of the root link, which URDF does not give
    (default FREE, as DART's loader); pass sm.WELD to pin it.
    ground: add a y = 0 halfspace for the collision geoms to meet.
    """
    if os.path.exists(path_or_string):
        robot = ET.parse(path_or_string).getroot()
        base_dir = os.path.dirname(os.path.abspath(path_or_string))
    else:
        robot = ET.fromstring(path_or_string)
        base_dir = None
    if robot.tag != "robot":
        raise ValueError(f"expected <robot>, got <{robot.tag}>")
    name = robot.get("name", "urdf_robot")

    links: Dict[str, ET.Element] = {}
    link_order: List[str] = []
    for link in robot.findall("link"):
        links[link.get("name")] = link
        link_order.append(link.get("name"))

    child_joint: Dict[str, ET.Element] = {}
    for joint in robot.findall("joint"):
        child_joint[joint.find("child").get("link")] = joint

    roots = [ln for ln in link_order if ln not in child_joint]
    if len(roots) != 1:
        raise ValueError(f"URDF must have exactly one root link, got {roots}")

    # topological order
    ordered: List[str] = []
    remaining = list(link_order)
    while remaining:
        progressed = False
        for ln in list(remaining):
            j = child_joint.get(ln)
            p = None if j is None else j.find("parent").get("link")
            if p is None or p in ordered:
                ordered.append(ln)
                remaining.remove(ln)
                progressed = True
        if not progressed:
            raise ValueError("cycle in URDF kinematic tree")

    b = ModelBuilder(dt=dt, gravity=gravity, name=name, solver=solver)
    rj = sm.FREE if root_joint is None else root_joint
    for ln in ordered:
        link = links[ln]
        joint = child_joint.get(ln)
        lo = hi = None
        damping = friction = 0.0
        if joint is None:
            jtype, axes = rj, ((1, 0, 0), (0, 1, 0), (0, 0, 1))
            R_pj, p_pj = np.eye(3), np.zeros(3)
            jname, parent = ln + "_root", None
        else:
            jt = joint.get("type")
            if jt not in _JOINT_TYPES:
                raise NotImplementedError(f"URDF joint type {jt}")
            jtype = _JOINT_TYPES[jt]
            R_pj, p_pj = _origin(joint)
            ax_el = joint.find("axis")
            axis = (_floats(ax_el.get("xyz")) if ax_el is not None
                    else np.array([1.0, 0.0, 0.0]))
            nrm = np.linalg.norm(axis)
            axis = axis / nrm if nrm > 0 else np.array([1.0, 0.0, 0.0])
            if jtype == sm.PLANAR:
                # motion in the plane normal to the axis: an orthonormal
                # (e1, e2, axis) triad
                ref = (np.array([1.0, 0, 0]) if abs(axis[0]) < 0.9
                       else np.array([0.0, 0, 1.0]))
                e1 = np.cross(axis, ref)
                e1 /= np.linalg.norm(e1)
                axes = (e1, np.cross(axis, e1), axis)
            else:
                axes = (axis, (0, 1, 0), (0, 0, 1))
            lim = joint.find("limit")
            if lim is not None and jt not in ("continuous", "fixed"):
                if lim.get("lower") is not None:
                    lo = float(lim.get("lower"))
                if lim.get("upper") is not None:
                    hi = float(lim.get("upper"))
            dyn = joint.find("dynamics")
            if dyn is not None:
                damping = float(dyn.get("damping", 0.0))
                friction = float(dyn.get("friction", 0.0))
            jname = joint.get("name", ln + "_joint")
            parent = joint.find("parent").get("link")

        mass, com, moi = 1e-6, np.zeros(3), np.eye(3) * 1e-9
        inertial = link.find("inertial")
        if inertial is not None:
            m_el = inertial.find("mass")
            if m_el is not None:
                mass = float(m_el.get("value"))
            R_i, com = _origin(inertial)
            i_el = inertial.find("inertia")
            if i_el is not None:
                g = lambda k: float(i_el.get(k, 0.0))
                I_local = np.array([
                    [g("ixx"), g("ixy"), g("ixz")],
                    [g("ixy"), g("iyy"), g("iyz")],
                    [g("ixz"), g("iyz"), g("izz")],
                ])
                moi = R_i @ I_local @ R_i.T

        nd = sm.JOINT_NDOF[jtype]
        b.add_body(
            ln, parent, jtype, axes=np.asarray(axes, dtype=np.float64),
            pj_rot=R_pj, pj_pos=p_pj, mass=mass, com=com, inertia=moi,
            damping=damping, dof_friction=friction,
            q_lower=None if lo is None else [lo] * nd,
            q_upper=None if hi is None else [hi] * nd,
            joint_name=jname)
        for col in link.findall("collision"):
            geom_el = col.find("geometry")
            if geom_el is None:
                continue
            gtype, size, _ = _geometry(geom_el, base_dir=base_dir)
            R_g, p_g = _origin(col)
            if gtype == "mesh":
                b.add_mesh_geom(ln, size, pos=p_g, rot=R_g)
            else:
                b.add_geom(ln, gtype, size, pos=p_g, rot=R_g)

    if ground:
        b.add_ground(normal=(0, 1, 0), offset=0.0)
    return b.finalize(dtype=dtype, device=device)

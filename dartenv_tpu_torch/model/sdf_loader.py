"""SDF world loader, the subset DART's SdfParser reads that matters to an
env: one world of models, links, joints and primitive collision shapes.

  <sdf><world>
    <physics><max_step_size/><gravity/></physics>
    <model name=...>
      <static>true|false</static>
      <pose>x y z r p y</pose>
      <link name=...>
        <pose/> <inertial><mass/><inertia><ixx/>...</inertia></inertial>
        <collision><geometry><box|sphere|cylinder|capsule/></geometry>
          <surface><friction><ode><mu/></ode></friction></surface>
        </collision>
      </link>
      <joint name=... type="revolute|prismatic|ball|fixed|universal">
        <pose/> <parent>link</parent> <child>link</child>
        <axis><xyz/><limit><lower/><upper/></limit>
              <dynamics><damping/></dynamics></axis>
        <axis2><xyz/></axis2>
      </joint>
    </model>
  </world></sdf>

Semantics mapped to the engine's SkelModel conventions:
  * link / joint <pose> values are local to their parent element (SDF
    1.5+: link pose in the model frame, joint pose in the CHILD link
    frame); joint axes are in the joint frame;
  * a floating link (no joint naming it as child) gets a FREE joint at
    the world origin, its pose carried by q_init (so3_log of the link's
    rotation, then its position);
  * static models' boxes become world halfspaces through their top face
    (as the .skel parser treats a static ground), attached to every
    mobile skeleton;
  * SDF <cylinder> / <capsule> <length> is the full length, <box><size>
    the full extents (halved here); SDF axes default to local z.

Returns the same ParsedWorld as model/skel_parser.parse_skel.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np
import torch

from dartenv_tpu_torch.math import spatial as sp
from dartenv_tpu_torch.model import skel_model as sm
from dartenv_tpu_torch.model.builder import ModelBuilder
from dartenv_tpu_torch.model.skel_parser import ParsedWorld, euler_zyx_to_mat

_JOINT_TYPES = {
    "revolute": sm.REVOLUTE,
    "prismatic": sm.PRISMATIC,
    "ball": sm.BALL,
    "fixed": sm.WELD,
    "universal": sm.UNIVERSAL,
    "screw": sm.SCREW,
    "free": sm.FREE,
}


def _floats(text) -> np.ndarray:
    return np.asarray([float(x) for x in text.split()], dtype=np.float64)


def _pose(el) -> tuple:
    """(R, p) of an element's <pose> child (identity if absent).  SDF rpy
    is FIXED-axis roll-pitch-yaw, R = Rz(yaw) Ry(pitch) Rx(roll), not the
    .skel XYZ order."""
    p = el.find("pose") if el is not None else None
    if p is None or p.text is None:
        return np.eye(3), np.zeros(3)
    v = _floats(p.text)
    return euler_zyx_to_mat(v[3], v[4], v[5]), v[:3]


def _t_mul(a, b):
    Ra, pa = a
    Rb, pb = b
    return Ra @ Rb, pa + Ra @ pb


def _t_inv(t):
    R, p = t
    return R.T, -(R.T @ p)


def _parse_geometry(geom):
    """(gtype, size) from an SDF <geometry> element, or None."""
    b = geom.find("box")
    if b is not None:
        return sm.GEOM_BOX, _floats(b.find("size").text) / 2.0
    s = geom.find("sphere")
    if s is not None:
        return sm.GEOM_SPHERE, np.array(
            [float(s.find("radius").text), 0.0, 0.0])
    for tag, gtype in (("cylinder", sm.GEOM_CYLINDER),
                       ("capsule", sm.GEOM_CAPSULE)):
        c = geom.find(tag)
        if c is not None:
            return gtype, np.array([float(c.find("radius").text),
                                    float(c.find("length").text) / 2.0, 0.0])
    return None


def _surface_friction(coll) -> float:
    mu = coll.find("surface/friction/ode/mu")
    return float(mu.text) if mu is not None else 1.0


def _inertial(link):
    """(mass, com, inertia or None) of a link's <inertial>."""
    mass, com, inertia = 1.0, (0, 0, 0), None
    inert = link.find("inertial")
    if inert is not None:
        m_el = inert.find("mass")
        if m_el is not None:
            mass = float(m_el.text)
        Rc, pc = _pose(inert)
        com = tuple(pc)
        I = inert.find("inertia")
        if I is not None:
            def gv(tag):
                el = I.find(tag)
                return float(el.text) if el is not None else 0.0
            inertia = np.array(
                [[gv("ixx"), gv("ixy"), gv("ixz")],
                 [gv("ixy"), gv("iyy"), gv("iyz")],
                 [gv("ixz"), gv("iyz"), gv("izz")]])
            inertia = Rc @ inertia @ Rc.T
    return mass, com, inertia


def _joint_axes(j):
    """(axes, lower, upper, damping) of a joint's <axis> / <axis2>."""
    axes, lower, upper, damping = [], None, None, 0.0
    for ax_tag in ("axis", "axis2"):
        ax = j.find(ax_tag)
        if ax is None:
            continue
        xyz = ax.find("xyz")
        axes.append(_floats(xyz.text) if xyz is not None
                    else np.array([0.0, 0.0, 1.0]))
        if ax_tag != "axis":
            continue
        lim = ax.find("limit")
        if lim is not None:
            lo, hi = lim.find("lower"), lim.find("upper")
            if lo is not None and hi is not None:
                lower, upper = float(lo.text), float(hi.text)
        dyn = ax.find("dynamics")
        if dyn is not None and dyn.find("damping") is not None:
            damping = float(dyn.find("damping").text)
    return axes, lower, upper, damping


def _mobile_model(model, link_T, dt, gravity, dtype, device):
    """One mobile SDF <model> -> SkelModel: its joints define the tree."""
    links = model.findall("link")
    child_joint: Dict[str, ET.Element] = {
        j.find("child").text.strip(): j for j in model.findall("joint")}
    b = ModelBuilder(dt=dt, gravity=tuple(gravity))
    placed = set()

    def _ready(link) -> bool:
        j = child_joint.get(link.get("name"))
        return j is None or j.find("parent").text.strip() in (
            "world", *placed)

    remaining = list(links)
    while remaining:
        progress = False
        for link in list(remaining):
            if not _ready(link):
                continue
            name = link.get("name")
            T_child = link_T[name]
            j = child_joint.get(name)
            if j is None:
                jt, parent_name, axes = sm.FREE, None, []
                lower = upper = None
                damping = 0.0
                Rw, pw = T_child
                rotvec = sp.so3_log(torch.as_tensor(Rw, dtype=torch.float64))
                q_init = list(rotvec.numpy()) + list(pw)
                # free-link convention: joint at the world origin, the pose
                # carried by q_init (exp coordinates zero at the reference
                # orientation)
                pjR, pjp, cjR, cjp = np.eye(3), np.zeros(3), np.eye(3), \
                    np.zeros(3)
            else:
                jt = _JOINT_TYPES[j.get("type", "revolute")]
                parent_name = j.find("parent").text.strip()
                if parent_name == "world":
                    parent_name = None
                # SDF: the joint pose is relative to the CHILD link
                T_joint = _t_mul(T_child, _pose(j))
                axes, lower, upper, damping = _joint_axes(j)
                q_init = 0.0
                # frames: pj = joint in parent body, cj = joint in child
                T_parent = (link_T.get(parent_name, (np.eye(3), np.zeros(3)))
                            if parent_name else (np.eye(3), np.zeros(3)))
                pjR, pjp = _t_mul(_t_inv(T_parent), T_joint)
                cjR, cjp = _t_mul(_t_inv(T_child), T_joint)

            mass, com, inertia = _inertial(link)
            kw = dict(mass=mass, com=com, inertia=inertia,
                      pj_pos=tuple(pjp), pj_rot=pjR,
                      cj_pos=tuple(cjp), cj_rot=cjR,
                      damping=damping, q_init=q_init)
            if axes:
                ax3 = np.zeros((3, 3))
                for k, a in enumerate(axes[:3]):
                    ax3[k] = a / max(np.linalg.norm(a), 1e-12)
                kw["axes"] = ax3[: max(1, len(axes))]
            if lower is not None:
                kw["q_lower"], kw["q_upper"] = lower, upper
            b.add_body(name, parent_name, jt, **kw)
            placed.add(name)
            remaining.remove(link)
            progress = True

            for coll in link.findall("collision"):
                g = _parse_geometry(coll.find("geometry"))
                if g is None:
                    continue
                Rg, pg = _pose(coll)
                b.add_geom(name, g[0], tuple(g[1]), pos=tuple(pg), rot=Rg,
                           friction=_surface_friction(coll))
        if not progress:
            raise ValueError(
                f"SDF joint graph has a cycle or dangling parent among "
                f"{[ln.get('name') for ln in remaining]}")
    return b.finalize(dtype=dtype, device=device)


def parse_sdf(path: str, dtype=torch.float32, device="cuda") -> ParsedWorld:
    """Parse an SDF world file into a ParsedWorld of its mobile models on
    `device` (raises ValueError if it has none)."""
    root = ET.parse(path).getroot()
    world = root.find("world") if root.tag != "world" else root
    if world is None:                      # a bare <sdf><model> file
        world = root

    dt = 0.002
    gravity = np.array([0.0, -9.81, 0.0])
    phys = world.find("physics")
    if phys is not None:
        ts = phys.find("max_step_size")
        if ts is not None:
            dt = float(ts.text)
        gr = phys.find("gravity")
        if gr is not None and gr.text:
            gravity = _floats(gr.text)
    up = -gravity / max(np.linalg.norm(gravity), 1e-9)

    halfspaces: List[tuple] = []
    skeletons: List[sm.SkelModel] = []
    for model in world.findall("model"):
        static_el = model.find("static")
        # an empty <static/> falls back to sdformat's default (false):
        # only an explicit true / 1 is static
        is_static = (static_el is not None
                     and (static_el.text or "").strip().lower()
                     in ("true", "1"))
        T_model = _pose(model)
        link_T = {link.get("name"): _t_mul(T_model, _pose(link))
                  for link in model.findall("link")}
        if not is_static:
            skeletons.append(_mobile_model(model, link_T, dt, gravity,
                                           dtype, device))
            continue
        # world geometry: the top face of each box as a halfspace
        for link in model.findall("link"):
            for coll in link.findall("collision"):
                g = _parse_geometry(coll.find("geometry"))
                if g is None or g[0] != sm.GEOM_BOX:
                    continue
                Rg, pg = _t_mul(link_T[link.get("name")], _pose(coll))
                off = float(up @ pg + np.abs(up @ Rg) @ g[1])
                halfspaces.append((up.copy(), off, _surface_friction(coll)))

    if not skeletons:
        raise ValueError(f"SDF world {path!r} has no mobile models")
    if halfspaces:
        t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64),
                                      dtype=dtype, device=device)
        nw = len(halfspaces)
        skeletons = [mdl.replace(
            wg_normal=t(np.stack([h[0] for h in halfspaces])),
            wg_offset=t([h[1] for h in halfspaces]),
            wg_friction=t([h[2] for h in halfspaces]),
            wg_restitution=t(np.zeros(nw)),
            world_pairs=tuple((g, w) for g in range(mdl.ng)
                              for w in range(nw)))
            for mdl in skeletons]
    return ParsedWorld(dt, gravity, skeletons)

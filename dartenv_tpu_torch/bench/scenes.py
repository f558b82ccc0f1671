"""The collision-matrix scenes: one geom dropped on a halfspace, or on a
fixed geom through a self pair, for every pair family of the narrowphase
(the JAX package's tests/test_collision_matrix.py scenes).

`scene_builder(name, builder_cls)` returns the un-finalized builder of a
scene, so that any builder with the port's ModelBuilder interface (the
port's, or another implementation's for a parity test) builds the same
model; `REST` gives each scene's analytic rest height of the dropped
body's y translation (dof 1) and the bound it is held to after settling.
"""
from __future__ import annotations

import numpy as np

from dartenv_tpu_torch.model import skel_model as sm
from dartenv_tpu_torch.model.builder import (
    ModelBuilder, box_inertia, capsule_inertia, cylinder_inertia,
    ellipsoid_inertia, sphere_inertia,
)

_BOTTOM = (0.5, 0.2, 0.5)        # the fixed box of the two-body scenes
_Z_TO_Y = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
_Z_TO_X = np.array([[0.0, 0, 1.0], [0, 1.0, 0], [-1.0, 0, 0]])


def _rx(th):
    return np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                     [0, np.sin(th), np.cos(th)]])


def _ry(th):
    return np.array([[np.cos(th), 0, np.sin(th)], [0, 1.0, 0],
                     [-np.sin(th), 0, np.cos(th)]])


def mesh_box_verts(half):
    hx, hy, hz = half
    return np.array([[sx * hx, sy * hy, sz * hz]
                     for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])


# name -> (rest height of dof 1, bound)
REST = {
    "cylinder_side": (0.3, 5e-3), "cylinder_end": (0.5, 5e-3),
    "ellipsoid": (0.3, 5e-3), "box_box": (0.3, 5e-3),
    "box_box_offset": (0.3, 5e-3),
    "box_box_edge": (0.2 + 0.15 * np.sqrt(2.0), 5e-3),
    "capsule_box": (0.3, 5e-3), "sphere_box": (0.32, 5e-3),
    "capsule_box_edge": (0.3, 5e-3), "cylinder_cylinder": (0.35, 1.5e-2),
    "ellipsoid_box": (0.45, 2.5e-2), "mesh_box": (0.3, 5e-3),
    "mesh_mesh": (0.3, 5e-3), "capsule_mesh": (0.3, 5e-3),
    "mesh_box_rotated": (0.3, 5e-3),
}
SCENES = tuple(REST)


def scene_builder(name: str, builder_cls=ModelBuilder):
    """The builder of scene `name` (not finalized)."""
    b = builder_cls(dt=0.002)
    drops = {"cylinder_side": (sm.GEOM_CYLINDER, (0.3, 0.5), None, 0.6,
                               cylinder_inertia(1.0, 0.3, 1.0)),
             "cylinder_end": (sm.GEOM_CYLINDER, (0.3, 0.5), _Z_TO_Y, 0.7,
                              cylinder_inertia(1.0, 0.3, 1.0)),
             "ellipsoid": (sm.GEOM_ELLIPSOID, (0.1, 0.3, 0.2), None, 0.5,
                           ellipsoid_inertia(1.0, (0.1, 0.3, 0.2)))}
    if name in drops:
        gtype, size, rot, y0, inertia = drops[name]
        b.add_body("b", None, sm.TRANSLATIONAL, mass=1.0, inertia=inertia,
                   q_init=[0.0, y0, 0.0])
        b.add_geom("b", gtype, size, rot=rot, friction=1.0)
        b.add_ground()
        return b
    bottom_mesh = name in ("mesh_mesh", "capsule_mesh")
    bottom_rot = None
    half = (0.15, 0.1, 0.15)
    top = {
        "box_box": (sm.GEOM_BOX, half, None, (0.0, 0.5),
                    box_inertia(1.0, half)),
        "box_box_offset": (sm.GEOM_BOX, half, None, (0.4, 0.5),
                           box_inertia(1.0, half)),
        "box_box_edge": (sm.GEOM_BOX, (0.15, 0.15, 0.15), _rx(np.pi / 4),
                         (0.0, 0.6), box_inertia(1.0, (0.15, 0.15, 0.15))),
        "capsule_box": (sm.GEOM_CAPSULE, (0.1, 0.25), None, (0.0, 0.5),
                        capsule_inertia(1.0, 0.1, 0.25)),
        "sphere_box": (sm.GEOM_SPHERE, (0.12,), None, (0.0, 0.5),
                       sphere_inertia(1.0, 0.12)),
        "capsule_box_edge": (sm.GEOM_CAPSULE, (0.1, 0.25), _Z_TO_X,
                             (0.5, 0.5), capsule_inertia(1.0, 0.1, 0.25)),
        "cylinder_cylinder": (sm.GEOM_CYLINDER, (0.15, 0.5), None,
                              (0.0, 0.6), cylinder_inertia(1.0, 0.15, 1.0)),
        "ellipsoid_box": (sm.GEOM_ELLIPSOID, (0.15, 0.25, 0.2), None,
                          (0.0, 0.7),
                          ellipsoid_inertia(1.0, (0.15, 0.25, 0.2))),
        "mesh_box": (sm.GEOM_MESH, mesh_box_verts(half), None, (0.0, 0.5),
                     box_inertia(1.0, half)),
        "mesh_mesh": (sm.GEOM_MESH, mesh_box_verts(half), None, (0.0, 0.5),
                      box_inertia(1.0, half)),
        "capsule_mesh": (sm.GEOM_CAPSULE, (0.1, 0.15), None, (0.0, 0.6),
                         capsule_inertia(1.0, 0.1, 0.3)),
        "mesh_box_rotated": (sm.GEOM_MESH,
                             mesh_box_verts(half) @ _ry(np.pi / 4).T, None,
                             (0.0, 0.5), box_inertia(1.0, half)),
    }[name]
    gtype, size, rot, (x0, y0), inertia = top
    if name == "cylinder_cylinder":
        b.add_body("bottom", None, sm.WELD, mass=10.0,
                   inertia=cylinder_inertia(10.0, 0.2, 1.0))
        g0 = b.add_geom("bottom", sm.GEOM_CYLINDER, (0.2, 0.5), rot=_Z_TO_X)
    else:
        b.add_body("bottom", None, sm.WELD, mass=10.0,
                   inertia=box_inertia(10.0, _BOTTOM))
        g0 = (b.add_mesh_geom("bottom", mesh_box_verts(_BOTTOM))
              if bottom_mesh else
              b.add_geom("bottom", sm.GEOM_BOX, _BOTTOM, rot=bottom_rot))
    b.add_body("top", "bottom", sm.TRANSLATIONAL, mass=1.0, inertia=inertia,
               q_init=[x0, y0, 0.0])
    g1 = (b.add_mesh_geom("top", size, friction=1.0) if gtype == sm.GEOM_MESH
          else b.add_geom("top", gtype, size, rot=rot, friction=1.0))
    b.add_self_pair(g1, g0)
    return b


def box_skeleton_builder(builder_cls=ModelBuilder, x: float = 0.5,
                         half: float = 0.1):
    """A free box skeleton resting on the ground at x, in front of the
    walker2d's feet (the object of the walker-and-box world)."""
    b = builder_cls(dt=0.002)
    h = (half, half, half)
    b.add_body("box", None, sm.FREE, mass=1.0, inertia=box_inertia(1.0, h),
               q_init=[0.0, 0.0, 0.0, x, half + 0.001, 0.0])
    b.add_geom("box", sm.GEOM_BOX, h, friction=0.8)
    b.add_ground()
    b.name = "box"
    return b


def walker_box_world(device="cuda", dtype=None, contact_cap: int = 10):
    """The multi-skeleton world of the port's GPU check: DartWalker2d's
    shipped model (walker2d.skel, its task's solver settings) composed
    with one free box skeleton (n 9 + 6, nb 7 + 1; 14 + 4 halfspace slots
    and 7 capsule-box cross pairs of 3 slots: 39 slots, 123 rows), with
    `contact_cap` kept slots (10: 36 solver rows)."""
    import torch

    from dartenv_tpu_torch.envs.base import with_solver
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.model.compose import compose_models

    dtype = dtype or torch.float32
    walker = make_task("walker2d", device=device, dtype=dtype).model
    box = box_skeleton_builder().finalize(dtype=dtype, device=device)
    return with_solver(compose_models([walker, box]),
                       contact_cap=contact_cap)


def servo_walker(device="cuda", dtype=None, flimit: float = 50.0):
    """DartWalker2d with servo motors of force limit `flimit` on its 6
    actuated dofs (the task's solver settings): 6 servo rows after its
    contact and limit rows, boxed to +-flimit * dt with findex -1."""
    import torch

    from dartenv_tpu_torch.envs.tasks import make_task

    dtype = dtype or torch.float32
    model = make_task("walker2d", device=device, dtype=dtype).model
    fl = torch.zeros_like(model.q_init)
    fl[3:] = flimit
    return model.replace(servo_flimit=fl)


# The loaders' worlds: the JAX package's tests/test_urdf.py double pendulum
# (a welded base, a continuous shoulder, a limited elbow) and its floating
# block (a cylinder, loaded as a capsule), and tests/test_sdf.py's world (a
# static ground box, a welded pendulum, a free crate resting on the ground).
URDF_PENDULUM = """
<robot name="double_pendulum">
  <link name="base">
    <inertial><mass value="1.0"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <link name="upper">
    <inertial><origin xyz="0 -0.5 0"/><mass value="2.0"/>
      <inertia ixx="0.1" iyy="0.01" izz="0.1" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><origin xyz="0 -0.5 0"/>
      <geometry><sphere radius="0.05"/></geometry>
    </collision>
  </link>
  <link name="lower">
    <inertial><origin xyz="0 -0.4 0"/><mass value="1.0"/>
      <inertia ixx="0.05" iyy="0.01" izz="0.05" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <joint name="shoulder" type="continuous">
    <origin xyz="0 2.0 0"/>
    <parent link="base"/><child link="upper"/>
    <axis xyz="0 0 1"/>
    <dynamics damping="0.1"/>
  </joint>
  <joint name="elbow" type="revolute">
    <origin xyz="0 -1.0 0"/>
    <parent link="upper"/><child link="lower"/>
    <axis xyz="0 0 1"/>
    <limit lower="-2.0" upper="2.0" effort="10" velocity="5"/>
  </joint>
</robot>
"""

URDF_BOX = """
<robot name="block">
  <link name="body">
    <inertial><mass value="3.0"/>
      <inertia ixx="0.1" iyy="0.1" izz="0.1" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><geometry><cylinder radius="0.1" length="0.6"/></geometry>
    </collision>
  </link>
</robot>
"""

SDF_PENDULUM_CRATE = """<?xml version="1.0" ?>
<sdf version="1.6">
  <world name="default">
    <physics><max_step_size>0.002</max_step_size>
      <gravity>0 -9.81 0</gravity></physics>
    <model name="ground_plane">
      <static>true</static>
      <link name="ground">
        <pose>0 -0.05 0 0 0 0</pose>
        <collision name="c">
          <geometry><box><size>10 0.1 10</size></box></geometry>
          <surface><friction><ode><mu>0.9</mu></ode></friction></surface>
        </collision>
      </link>
    </model>
    <model name="pendulum">
      <link name="base">
        <pose>0 1.0 0 0 0 0</pose>
        <inertial><mass>2.0</mass>
          <inertia><ixx>0.02</ixx><iyy>0.02</iyy><izz>0.02</izz></inertia>
        </inertial>
        <collision name="c">
          <geometry><sphere><radius>0.05</radius></sphere></geometry>
        </collision>
      </link>
      <link name="bob">
        <pose>0 0.6 0 0 0 0</pose>
        <inertial><mass>1.0</mass>
          <inertia><ixx>0.01</ixx><iyy>0.01</iyy><izz>0.01</izz></inertia>
        </inertial>
        <collision name="c">
          <geometry><sphere><radius>0.08</radius></sphere></geometry>
        </collision>
      </link>
      <joint name="anchor" type="fixed">
        <parent>world</parent><child>base</child>
      </joint>
      <joint name="swing" type="revolute">
        <pose>0 0.4 0 0 0 0</pose>
        <parent>base</parent><child>bob</child>
        <axis><xyz>0 0 1</xyz>
          <limit><lower>-2.5</lower><upper>2.5</upper></limit>
          <dynamics><damping>0.05</damping></dynamics>
        </axis>
      </joint>
    </model>
    <model name="crate">
      <link name="box">
        <pose>0.6 0.101 0 0 0 0</pose>
        <inertial><mass>0.5</mass>
          <inertia><ixx>0.003</ixx><iyy>0.003</iyy><izz>0.003</izz></inertia>
        </inertial>
        <collision name="c">
          <geometry><box><size>0.2 0.2 0.2</size></box></geometry>
        </collision>
      </link>
    </model>
  </world>
</sdf>
"""

"""PyTorch port, mesh geoms vs the JAX package (float64, CPU): the OBJ and
STL readers (files written to tmp_path), mesh_inertia, a mesh geom through
the builder (a cube mesh steps exactly like the same cube as a box, and
interior vertices are inert) and through the .skel parser (a <mesh>
shape with a scale), each against the JAX package's model arrays."""
import struct

import jax.numpy as jnp
import numpy as np
import torch

from dartenv_tpu.model import mesh_loader as jml
from dartenv_tpu.model.builder import ModelBuilder as JBuilder
from dartenv_tpu.model.builder import mesh_inertia as jax_mesh_inertia
from dartenv_tpu.model.skel_parser import parse_skel as jax_parse_skel
from dartenv_tpu_torch.engine.world import init_state, make_sim_step
from dartenv_tpu_torch.model import mesh_loader as tml
from dartenv_tpu_torch.model.builder import (
    ModelBuilder, box_inertia, mesh_inertia,
)
from dartenv_tpu_torch.model.skel_model import FREE, GEOM_BOX, GEOM_MESH
from dartenv_tpu_torch.model.skel_parser import parse_skel
from test_torch_compose import _assert_same_model
from torch_port_util import N, port_model

HALF = 0.1


def _cube_verts(half=HALF):
    return np.array([[sx, sy, sz] for sx in (-1.0, 1.0)
                     for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]) * half


def test_obj_and_stl_loaders(tmp_path):
    verts = _cube_verts()
    p_obj = tmp_path / "cube.obj"
    p_obj.write_text("\n".join("v {} {} {}".format(*v) for v in verts)
                     + "\nf 1 2 3\n")
    blob = b"\0" * 80 + struct.pack("<I", 1) + struct.pack("<3f", 0, 0, 1)
    for v in verts[:3]:
        blob += struct.pack("<3f", *v)
    p_stl = tmp_path / "tri.stl"
    p_stl.write_bytes(blob + struct.pack("<H", 0))
    p_ascii = tmp_path / "tri_ascii.stl"
    p_ascii.write_text("solid t\nfacet normal 0 0 1\nouter loop\n"
                       + "".join("vertex {} {} {}\n".format(*v)
                                 for v in verts[:3])
                       + "endloop\nendfacet\nendsolid t\n")
    for p, scale in ((p_obj, 1.0), (p_obj, (2.0, 1.0, 0.5)), (p_stl, 1.0),
                     (p_ascii, 3.0)):
        got = tml.load_mesh(p, scale=scale)
        np.testing.assert_array_equal(got, jml.load_mesh(p, scale=scale))
    np.testing.assert_array_equal(tml.load_obj(p_obj.read_text()),
                                  jml.load_obj(p_obj.read_text()))
    np.testing.assert_allclose(np.sort(tml.load_mesh(p_obj), axis=0),
                               np.sort(verts, axis=0), atol=0)


def test_mesh_inertia():
    rng = np.random.default_rng(0)
    for verts in (_cube_verts(), rng.normal(size=(13, 3))):
        np.testing.assert_array_equal(mesh_inertia(2.0, verts),
                                      jax_mesh_inertia(2.0, verts))
    np.testing.assert_allclose(mesh_inertia(2.0, _cube_verts()),
                               box_inertia(2.0, np.full(3, HALF)),
                               atol=1e-15)


def _falling(builder_cls, use_mesh, extra_vert=False, **fin):
    b = builder_cls(dt=0.002)
    b.add_body("cube", None, FREE, mass=1.0,
               inertia=box_inertia(1.0, np.full(3, HALF)),
               q_init=[0.2, 0.1, 0, 0, 0.105, 0])
    if use_mesh:
        verts = _cube_verts()
        if extra_vert:
            verts = np.concatenate([verts, np.zeros((1, 3))])
        b.add_mesh_geom("cube", verts)
    else:
        b.add_geom("cube", GEOM_BOX, np.full(3, HALF))
    b.add_ground()
    return b.finalize(**fin)


def _drop(model, substeps=40):
    step = make_sim_step(model)
    st = init_state(model, 2)
    tau = torch.zeros((2, model.n), dtype=torch.float64)
    qs = []
    for _ in range(substeps):
        st, _ = step(st, tau)
        qs.append(N(st.q))
    return np.stack(qs)


def test_mesh_geom_through_the_builder():
    for extra in (False, True):
        ref = port_model(_falling(JBuilder, True, extra,
                                  dtype=jnp.float64))
        got = _falling(ModelBuilder, True, extra, dtype=torch.float64,
                       device="cpu")
        _assert_same_model(got, ref)
        assert got.geom_mesh == (0,)
        assert got.mesh_verts.shape == (1, 9 if extra else 8, 3)
    box = _drop(_falling(ModelBuilder, False, dtype=torch.float64,
                         device="cpu"))
    mesh = _drop(_falling(ModelBuilder, True, dtype=torch.float64,
                          device="cpu"))
    mesh9 = _drop(_falling(ModelBuilder, True, True, dtype=torch.float64,
                           device="cpu"))
    np.testing.assert_allclose(mesh, box, atol=1e-12)
    np.testing.assert_allclose(mesh9, mesh, atol=1e-12)


def test_skel_mesh_shape(tmp_path):
    (tmp_path / "cube.obj").write_text("\n".join(
        "v {} {} {}".format(*v) for v in _cube_verts()))
    skel = """<skel><world name="w">
      <physics><time_step>0.002</time_step>
        <gravity>0 -9.81 0</gravity></physics>
      <skeleton name="robot">
        <body name="b1"><inertia><mass>1.0</mass></inertia>
          <collision_shape><geometry><mesh><file_name>cube.obj</file_name>
            <scale>1 2 1</scale></mesh></geometry></collision_shape>
        </body>
        <joint type="free" name="root"><parent>world</parent>
          <child>b1</child></joint>
      </skeleton></world></skel>"""
    p = tmp_path / "mesh.skel"
    p.write_text(skel)
    ref = port_model(jax_parse_skel(str(p), dtype=jnp.float64).robot)
    got = parse_skel(str(p), dtype=torch.float64, device="cpu").robot
    _assert_same_model(got, ref)
    assert got.geom_type == (GEOM_MESH,)
    np.testing.assert_allclose(N(got.mesh_verts[0]).max(0),
                               [HALF, 2 * HALF, HALF])

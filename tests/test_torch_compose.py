"""PyTorch port, multi-skeleton worlds vs the JAX package (float64, CPU):
compose_models of two and of three skeletons against the JAX package's
composed arrays (exactly), ParsedWorld.combined of a two-skeleton .skel,
a few phase-wise substeps of the ram-and-box world and of the
walker-and-box world (bench/scenes.walker_box_world) against JAX's
vmapped step, and kernel 3's host build on that forest (PLANAR and FREE
roots in one model)."""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.bench.throughput import make_task as jax_make_task
from dartenv_tpu.engine.constraints import build_layout as jbl
from dartenv_tpu.engine.world import SimState as JSimState
from dartenv_tpu.engine.world import make_sim_step as jax_make_sim_step
from dartenv_tpu.model import skel_model as jsm
from dartenv_tpu.model.builder import ModelBuilder as JBuilder
from dartenv_tpu.model.builder import box_inertia, capsule_inertia
from dartenv_tpu.model.compose import compose_models as jax_compose
from dartenv_tpu.model.skel_parser import parse_skel as jax_parse_skel
from dartenv_tpu_torch.bench import scenes
from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
from dartenv_tpu_torch.engine.world import SimState, make_sim_step
from dartenv_tpu_torch.model.compose import compose_models
from dartenv_tpu_torch.model.skel_model import (
    FLOAT_LEAVES, MESH_LEAVES, STATIC_FIELDS,
)
from dartenv_tpu_torch.model.skel_parser import parse_skel
from torch_port_util import N, T, port_model, rel_err

TOL = 1e-12


def _ram(builder=JBuilder):
    b = builder(dt=0.002)
    b.add_body("ram", None, jsm.PRISMATIC, mass=2.0,
               inertia=capsule_inertia(2.0, 0.05, 0.3),
               pj_pos=(0.0, 0.1, 0.0), axes=[(1.0, 0.0, 0.0)], q_init=[0.0])
    b.add_geom("ram", jsm.GEOM_CAPSULE, (0.05, 0.15), friction=0.3)
    b.add_ground()
    return b


def _small_box(x, y, name, builder=JBuilder):
    b = builder(dt=0.002)
    half = (0.08, 0.08, 0.08)
    b.add_body(name, None, jsm.FREE, mass=0.2, inertia=box_inertia(0.2, half),
               q_init=[0.0, 0.0, 0.0, x, y, 0.0])
    b.add_geom(name, jsm.GEOM_BOX, half, friction=0.4)
    b.add_mesh_geom(name, scenes.mesh_box_verts(half) * 0.5,
                    collide=False)
    b.add_ground()
    return b


def _assert_same_model(got, ref):
    for f in STATIC_FIELDS:
        assert getattr(got, f) == getattr(ref, f), f
    for f in FLOAT_LEAVES + MESH_LEAVES:
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.shape == b.shape, f
            assert torch.equal(a, b), f


@pytest.mark.parametrize("count", [2, 3])
def test_compose_models_matches_jax(count):
    parts = [_ram(), _small_box(0.35, 0.081, "b1")]
    if count == 3:
        parts.append(_small_box(0.35, 0.243, "b2"))
    jparts = [b.finalize(dtype=jnp.float64) for b in parts]
    ref = port_model(jax_compose(jparts))
    got = compose_models([port_model(m) for m in jparts])
    _assert_same_model(got, ref)
    assert len(got.skel_ranges) == count
    assert got.mesh_verts.shape[0] == count - 1


_TWO_SKEL = """<?xml version="1.0" ?>
<skel version="1.0"><world name="w">
  <physics><time_step>0.002</time_step><gravity>0 -9.81 0</gravity>
  </physics>
  <skeleton name="ground skeleton"><mobile>false</mobile>
    <body name="ground"><transformation>0 -0.05 0 0 0 0</transformation>
      <collision_shape><geometry><box><size>4.0 0.1 4.0</size></box>
      </geometry></collision_shape></body></skeleton>
  <skeleton name="object skeleton">
    <body name="obj"><transformation>0.3 0.1 0 0 0 0</transformation>
      <inertia><mass>0.5</mass></inertia>
      <collision_shape><geometry><box><size>0.2 0.2 0.2</size></box>
      </geometry></collision_shape></body>
    <joint type="free" name="obj_joint"><parent>world</parent>
      <child>obj</child></joint></skeleton>
  <skeleton name="robot skeleton">
    <body name="link1"><transformation>0 0.5 0 0 0 0</transformation>
      <inertia><mass>1.0</mass></inertia>
      <collision_shape><geometry><capsule><height>0.4</height>
        <radius>0.05</radius></capsule></geometry></collision_shape></body>
    <joint type="revolute" name="j1"><parent>world</parent>
      <child>link1</child><axis><xyz>0 0 1</xyz></axis></joint></skeleton>
</world></skel>
"""


def test_parsed_world_combined(tmp_path):
    p = tmp_path / "two.skel"
    p.write_text(_TWO_SKEL)
    ref = port_model(jax_parse_skel(str(p), dtype=jnp.float64).combined)
    world = parse_skel(str(p), dtype=torch.float64, device="cpu")
    assert world.robot is world.skeletons[-1]
    got = world.combined
    _assert_same_model(got, ref)
    assert got.nb == 2 and len(got.skel_ranges) == 2


def _step_pair(jm, tm, q, dq, tau, substeps):
    jstep = jax.jit(jax.vmap(jax_make_sim_step(jm)))
    tstep = make_sim_step(tm)
    lam = np.zeros((q.shape[0], jbl(jm).m))
    js = JSimState(q=jnp.asarray(q), dq=jnp.asarray(dq),
                   time=jnp.zeros(q.shape[0]), lam=jnp.asarray(lam))
    ts = SimState(q=T(q), dq=T(dq), time=T(np.zeros(q.shape[0])),
                  lam=T(lam))
    for _ in range(substeps):
        js, jc = jstep(js, jnp.asarray(tau))
        ts, tc = tstep(ts, T(tau))
    return js, jc, ts, tc


def test_ram_box_world_steps_like_jax():
    """The JAX multi-skeleton test's world: a driven ram against a free
    box; three substeps of B = 4 jittered states (PGS, f64)."""
    jm = jax_compose([_ram().finalize(dtype=jnp.float64),
                      _small_box(0.2, 0.081, "b1").finalize(
                          dtype=jnp.float64)])
    tm = port_model(jm)
    rng = np.random.default_rng(0)
    B = 4
    q = np.asarray(jm.q_init)[None] + rng.uniform(-0.02, 0.02, (B, jm.n))
    q[:, 0] += 0.06                        # the ram on the box
    dq = rng.normal(size=(B, jm.n)) * 0.1
    tau = np.zeros((B, jm.n))
    tau[:, 0] = 8.0
    js, jc, ts, tc = _step_pair(jm, tm, q, dq, tau, 3)
    assert float(N(tc.active)[:, -3:].sum()) > 0      # the cross pair hits
    for a, r in ((ts.q, js.q), (ts.dq, js.dq), (ts.lam, js.lam),
                 (tc.depth, jc.depth)):
        assert rel_err(a, r) <= TOL, rel_err(a, r)


def _walker_box_jax():
    walker = jax_make_task("walker2d", dtype=jnp.float64).model
    box = scenes.box_skeleton_builder(JBuilder).finalize(dtype=jnp.float64)
    jm = jax_compose([walker, box])
    # plain PGS and 4 kept slots: the JAX side's vmapped trace stays short
    return jm.replace(solver=dataclasses.replace(
        jm.solver, contact_cap=4, escalate_frac=0.0))


def test_walker_box_world_matches_jax():
    """bench/scenes.walker_box_world against the JAX composition of the
    JAX walker2d task model and the same box, then two substeps (B = 3)
    with the walker's foot pushed into the box."""
    jm = _walker_box_jax()
    ref = port_model(jm.replace(solver=dataclasses.replace(
        jm.solver, contact_cap=10, escalate_frac=1.0 / 32)))
    got = scenes.walker_box_world("cpu", torch.float64)
    _assert_same_model(got, ref)
    tm = port_model(jm)
    rng = np.random.default_rng(1)
    B = 3
    q = np.asarray(jm.q_init)[None] + rng.uniform(-0.05, 0.05, (B, jm.n))
    q[:, 12] = 0.2                         # box onto the right foot
    dq = rng.normal(size=(B, jm.n)) * 0.2
    tau = rng.uniform(-50, 50, (B, jm.n)) * (np.arange(jm.n) >= 3)
    tau[:, 9:] = 0.0
    js, jc, ts, tc = _step_pair(jm, tm, q, dq, tau, 2)
    assert float(N(tc.active)[:, 18:].sum()) > 0      # cross pairs live
    for a, r in ((ts.q, js.q), (ts.dq, js.dq), (ts.lam, js.lam)):
        assert rel_err(a, r) <= TOL, rel_err(a, r)


def test_dynamics_kernel_host_build_on_the_forest():
    """Kernel 3's per-env code (g++ host build) on the walker-and-box
    forest, PLANAR and FREE roots in one model (n 15, nb 8), against its
    plain version evaluated in float64, at the bounds of the kernel's own
    tests.  Above n = 12 the float32 plain version inverts M through
    inv_psd with a 1e-6 jitter that the kernel does not add: its dq_star
    is some 6e-4 from float64 here, the kernel's 1e-6 (so on the card,
    too, kernel 3 is held to the float64 plain version above n = 12)."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    from test_torch_dynamics_kernel import TOL32, _OUTS

    model = scenes.walker_box_world("cpu", torch.float32)
    rng = np.random.default_rng(2)
    B = 24
    q = T(np.asarray(model.q_init.double())[None]
          + rng.uniform(-0.3, 0.3, (B, model.n)), torch.float32)
    dq = T(rng.normal(size=(B, model.n)), torch.float32)
    tau = T(rng.normal(size=(B, model.n)) * 20, torch.float32)
    kern = hd.get_dynamics_kernel(model)
    got = kern.run_host(q, dq, tau)
    ref = hd.dynamics_reference(model.to(dtype=torch.float64), q.double(),
                                dq.double(), tau.double())
    for k, a, r in zip(_OUTS, got, ref):
        assert torch.isfinite(a).all(), k
        assert rel_err(a, r) <= TOL32[k], (k, rel_err(a, r))

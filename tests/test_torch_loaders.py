"""PyTorch port, the URDF and SDF loaders against the JAX package's on the
CPU in float64: the models of tests/test_urdf.py's and tests/test_sdf.py's
strings equal to the JAX package's (every field), one make_sim_step
substep of each at 1e-12, DartEnv(model_paths) with a .urdf and a .sdf
beside the JAX env, and the humanwalker generator's output equal to the
asset byte for byte."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu.engine.world import (
    SimState as JSimState, make_sim_step as jax_sim_step,
)
from dartenv_tpu.model.sdf_loader import parse_sdf as jax_parse_sdf
from dartenv_tpu.model.urdf_loader import parse_urdf as jax_parse_urdf
from dartenv_tpu_torch.bench import scenes
from dartenv_tpu_torch.engine.world import SimState, make_sim_step
from dartenv_tpu_torch.envs import DartEnv
from dartenv_tpu_torch.model import skel_model as sm
from dartenv_tpu_torch.model.sdf_loader import parse_sdf
from dartenv_tpu_torch.model.urdf_loader import parse_urdf
from test_sdf import _SDF
from test_torch_compose import _assert_same_model
from test_urdf import PENDULUM, PENDULUM_OK
from torch_port_util import port_model

STEP_TOL = 1e-12     # one substep's q, dq, lam: relative to max(1, |ref|)
ENV_TOL = 1e-10      # DartEnv state after a few control steps, absolute

BOX_URDF = scenes.URDF_BOX

TILTED_SDF = """<?xml version="1.0" ?>
<sdf version="1.6">
  <model name="tilted">
    <link name="box">
      <pose>0.1 0.8 -0.2 0.4 0 0.3</pose>
      <inertial><mass>0.5</mass>
        <inertia><ixx>0.003</ixx><iyy>0.003</iyy><izz>0.003</izz></inertia>
      </inertial>
      <collision name="c">
        <geometry><box><size>0.2 0.2 0.2</size></box></geometry>
      </collision>
    </link>
  </model>
</sdf>
"""


def _urdf_pair(text, **kw):
    return (parse_urdf(text, dtype=torch.float64, device="cpu", **kw),
            jax_parse_urdf(text, dtype=jnp.float64, **kw))


def _sdf_pair(tmp_path, text, name="world.sdf"):
    p = tmp_path / name
    p.write_text(text)
    return (parse_sdf(str(p), dtype=torch.float64, device="cpu"),
            jax_parse_sdf(str(p), dtype=jnp.float64))


def test_scene_strings_are_the_jax_tests():
    assert scenes.URDF_PENDULUM == PENDULUM_OK
    assert scenes.SDF_PENDULUM_CRATE == _SDF
    assert '<cylinder radius="0.1" length="0.6"/>' in BOX_URDF


def test_urdf_models_equal_jax():
    for text, kw in ((PENDULUM_OK, dict(root_joint=sm.WELD)),
                     (BOX_URDF, dict(ground=True)),
                     (PENDULUM_OK, dict(ground=True, dt=0.001))):
        got, ref = _urdf_pair(text, **kw)
        _assert_same_model(got, port_model(ref))
    got = parse_urdf(BOX_URDF, dtype=torch.float64, device="cpu",
                     ground=True)
    assert got.joint_type == (sm.FREE,)
    assert got.geom_type[0] == sm.GEOM_CAPSULE       # cylinder -> capsule


def test_urdf_rejects_as_the_reference_does():
    with pytest.raises(ValueError):                  # a dangling parent
        parse_urdf(PENDULUM, root_joint=sm.WELD, device="cpu")
    with pytest.raises(NotImplementedError):         # no .dae loader
        parse_urdf("""
        <robot name="meshy"><link name="l">
          <collision><geometry><mesh filename="x.dae"/></geometry></collision>
        </link></robot>""", root_joint=sm.WELD, device="cpu")


def test_urdf_mesh_geometry(tmp_path):
    """A <mesh> loads through mesh_loader, relative to the URDF's
    directory, as the JAX loader's code does."""
    (tmp_path / "m").mkdir()
    (tmp_path / "m" / "tet.obj").write_text(
        "v 0 0 0\nv 0.2 0 0\nv 0 0.2 0\nv 0 0 0.2\n")
    p = tmp_path / "r.urdf"
    p.write_text("""<robot name="r"><link name="l">
      <inertial><mass value="1.0"/>
        <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/>
      </inertial>
      <collision><geometry><mesh filename="package://m/tet.obj"/>
      </geometry></collision></link></robot>""")
    got, ref = _urdf_pair(str(p), ground=True)
    _assert_same_model(got, port_model(ref))
    assert got.mesh_verts.shape[1] == 4


def test_sdf_worlds_equal_jax(tmp_path):
    for name, text in (("world.sdf", _SDF), ("tilted.sdf", TILTED_SDF),
                       ("static.sdf", TILTED_SDF.replace(
                           '<model name="tilted">',
                           '<model name="tilted"><static/>'))):
        got, ref = _sdf_pair(tmp_path, text, name)
        assert got.dt == ref.dt
        np.testing.assert_array_equal(got.gravity, ref.gravity)
        assert len(got.skeletons) == len(ref.skeletons)
        for g, r in zip(got.skeletons, ref.skeletons):
            _assert_same_model(g, port_model(r))
    # the free crate's pose through so3_log, the ground's halfspace
    got, _ = _sdf_pair(tmp_path, _SDF)
    crate = got.skeletons[1]
    np.testing.assert_allclose(crate.q_init[3:].numpy(), [0.6, 0.101, 0.0])
    assert float(crate.wg_friction[0]) == 0.9


def _one_substep(model, jmodel, q, dq):
    """One substep of the port (B = 1) and of the JAX package (single
    env, jitted), from (q, dq) with zero warm-start impulses."""
    m = len(jax_step_layout(jmodel))
    st = SimState(q=torch.tensor(q)[None], dq=torch.tensor(dq)[None],
                  time=torch.zeros(1, dtype=torch.float64),
                  lam=torch.zeros((1, m), dtype=torch.float64))
    got, (contacts, _) = make_sim_step(model, return_impulses=True)(
        st, torch.zeros((1, model.n), dtype=torch.float64))
    jst = JSimState(q=jnp.asarray(q), dq=jnp.asarray(dq),
                    time=jnp.zeros(()), lam=jnp.zeros((m,)))
    ref, _ = jax.jit(jax_sim_step(jmodel))(jst, jnp.zeros(jmodel.n))
    for f in ("q", "dq", "lam"):
        r = np.asarray(getattr(ref, f))
        np.testing.assert_allclose(
            getattr(got, f)[0].numpy(), r, rtol=0,
            atol=STEP_TOL * max(1.0, np.abs(r).max(initial=0.0)), err_msg=f)
    return int(contacts.active.sum())


def jax_step_layout(jmodel):
    from dartenv_tpu.engine.constraints import build_layout

    return range(build_layout(jmodel).m)


def test_urdf_substep_equal_jax():
    pend, jpend = _urdf_pair(PENDULUM_OK, root_joint=sm.WELD)
    _one_substep(pend, jpend, np.array([0.7, -0.4]), np.array([1.0, -2.0]))
    box, jbox = _urdf_pair(BOX_URDF, ground=True)
    # the capsule (along z) lying on the ground, 2 mm into it, a little
    # tipped about x
    q = np.array([0.01, 0.0, 0.0, 0.0, 0.098, 0.0])
    active = _one_substep(box, jbox, q, np.array([0, 0, 0.5, 0.2, -1.0, 0]))
    assert active >= 1


def test_sdf_substep_equal_jax(tmp_path):
    got, ref = _sdf_pair(tmp_path, _SDF)
    (pend, crate), (jpend, jcrate) = got.skeletons, ref.skeletons
    _one_substep(pend, jpend, np.array([1.0]), np.array([-0.5]))
    q = np.asarray(jcrate.q_init).copy()
    q[4] = 0.098                                 # 2 mm into the ground
    active = _one_substep(crate, jcrate, q, np.array([0, 0, 0, 0.1, -0.3,
                                                      0]))
    assert active >= 1


@pytest.mark.parametrize("kind", ["urdf", "sdf"])
def test_dart_env_model_paths(tmp_path, kind):
    """DartEnv(model_paths) with a .urdf or a .sdf path: the models of
    the file, stepped beside the JAX env on the same model in float64."""
    from dartenv_tpu.envs.base import DartEnv as JDartEnv, _CustomTask
    from dartenv_tpu.model.compose import compose_models

    if kind == "urdf":
        p = tmp_path / "box.urdf"
        p.write_text(BOX_URDF)
        jmodel = jax_parse_urdf(str(p), dtype=jnp.float64)
        obs, n_act = 12, 1
    else:
        p = tmp_path / "world.sdf"
        p.write_text(_SDF)
        jmodel = compose_models(jax_parse_sdf(str(p),
                                              dtype=jnp.float64).skeletons)
        obs, n_act = 14, 1
    bounds = np.array([[1.0] * n_act, [-1.0] * n_act])
    env = DartEnv([str(p)], frame_skip=4, observation_size=obs,
                  action_bounds=bounds, dt=0.002, device="cpu",
                  dtype=torch.float64)
    jenv = JDartEnv(_CustomTask(jmodel, 4, obs, bounds))
    _assert_same_model(env.model, port_model(jmodel))
    for e in (env, jenv):
        e.seed(1)
        e.reset()
    tau = np.zeros(jmodel.n)
    for _ in range(5):
        env.do_simulation(tau, 4)
        jenv.do_simulation(tau, 4)
    np.testing.assert_allclose(env.state_vector(), jenv.state_vector(),
                               rtol=0, atol=ENV_TOL)
    assert np.isfinite(env.state_vector()).all()


def test_gen_humanwalker_reproduces_the_asset():
    from dartenv_tpu_torch.model.skel_parser import asset_path

    path = os.path.join(os.path.dirname(asset_path("walker2d.skel")),
                        "gen_humanwalker.py")
    spec = importlib.util.spec_from_file_location("gen_humanwalker", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)        # defines, writes nothing
    with open(asset_path("kima_humanwalker.skel"), "rb") as f:
        assert gen.generate().encode() == f.read()

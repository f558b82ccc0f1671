"""PyTorch port, the single-env `DartEnv` against the JAX package's, on the
CPU in float64: seeded resets and 20 seeded steps of hopper, cartpole and
reacher; the reference-signature construction (custom env subclasses, a
composed two-skeleton world, a missing model file); image observations."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dartenv_tpu_torch as gym
import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu.envs.base import DartEnv as JDartEnv
from dartenv_tpu.envs.cart_pole import make_cartpole_task as jax_cartpole
from dartenv_tpu.envs.hopper import make_hopper_task as jax_hopper
from dartenv_tpu.envs.reacher import make_reacher_task as jax_reacher
from dartenv_tpu_torch.envs import DartEnv
from dartenv_tpu_torch.envs.hopper import make_hopper_task

# obs and reward of the port's DartEnv within STEP_TOL of the JAX env's
# (absolute, over 20 control steps; measured about 1e-12), done exact
STEP_TOL = 1e-9

CASES = {"hopper": ("DartHopper-v1", jax_hopper),
         "cartpole": ("DartCartPole-v1", jax_cartpole),
         "reacher": ("DartReacher-v1", jax_reacher)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dart_env_steps_like_jax_f64(name):
    """seed(s) + reset give the JAX env's obs to 1e-12; then 20 steps of a
    seeded action sequence (some beyond the control bounds) match its
    obs and reward within STEP_TOL and its done exactly."""
    env_id, jax_task = CASES[name]
    jenv = JDartEnv(jax_task(dtype=jnp.float64))
    env = gym.make(env_id, device="cpu", dtype=torch.float64).unwrapped
    for s in (0, 11):
        jenv.seed(s)
        env.seed(s)
        np.testing.assert_allclose(env.reset(), jenv.reset(), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(env.state_vector(), jenv.state_vector(),
                               rtol=0, atol=1e-12)
    rng = np.random.default_rng(7)
    dones = []
    for _ in range(20):
        a = rng.uniform(-0.6, 0.6, env.action_space.shape)
        a[0] = rng.uniform(-1.3, 1.3)
        o, r, d, info = env.step(a)
        jo, jr, jd, jinfo = jenv.step(a)
        np.testing.assert_allclose(o, jo, rtol=0, atol=STEP_TOL)
        assert abs(r - jr) <= STEP_TOL
        assert d == jd
        assert info == jinfo
        dones.append(d)
    assert isinstance(o, np.ndarray) and o.dtype == np.float64
    np.testing.assert_allclose(env.state_vector(), jenv.state_vector(),
                               rtol=0, atol=STEP_TOL)


class MyHopper(DartEnv):
    """A user-written env in the reference idiom (tests/test_custom_env.py's
    subclass, with the port's device and dtype)."""

    def __init__(self):
        DartEnv.__init__(self, "hopper_capsule.skel", 4, 11,
                         np.array([[1.0] * 3, [-1.0] * 3]),
                         disableViewer=True, device="cpu",
                         dtype=torch.float64)

    def _step(self, a):
        a = np.clip(a, -1.0, 1.0)
        posbefore = self.robot_skeleton.q[0]
        tau = np.zeros(self.robot_skeleton.ndofs)
        tau[3:] = a * 200.0
        self.do_simulation(tau, self.frame_skip)
        posafter = self.robot_skeleton.q[0]
        reward = (posafter - posbefore) / self.dt + 1.0
        reward -= 1e-3 * np.square(a).sum()
        s = self.state_vector()
        height = self.robot_skeleton.bodynodes[0].com()[1]
        done = not (np.isfinite(s).all() and (np.abs(s[2:]) < 100).all()
                    and height > -0.3)
        return self._get_obs(), reward, done, {}

    def _get_obs(self):
        skel = self.robot_skeleton
        return np.concatenate([skel.q[1:], np.clip(skel.dq, -10, 10)])

    def reset_model(self):
        qpos = self.model.host("q_init") + self.np_random.uniform(
            low=-0.005, high=0.005, size=self.robot_skeleton.ndofs)
        qvel = self.np_random.uniform(low=-0.005, high=0.005,
                                      size=self.robot_skeleton.ndofs)
        self.set_state(qpos, qvel)
        return self._get_obs()


def test_custom_env_reference_signature():
    """The reference signature parses the .skel, keeps the constructor's
    sizes, and the subclass's do_simulation steps equal the built-in
    hopper task's do_simulation on the same state (the same model)."""
    env = MyHopper()
    assert env.frame_skip == 4 and env.dt == pytest.approx(4 * 0.002)
    assert env.observation_space.shape == (11,)
    assert env.action_space.shape == (3,)
    env.seed(123)
    o1 = env.reset()
    env.seed(123)
    np.testing.assert_array_equal(env.reset(), o1)
    ref = DartEnv(make_hopper_task(dtype=torch.float64, device="cpu",
                                   contact_cap=0, escalate_frac=0.0,
                                   pgs_iters=30))
    ref.reset()
    ref.set_state(*np.split(env.state_vector(), 2))
    a = np.array([0.3, -0.2, 0.5])
    for _ in range(5):
        o, r, d, _ = env.step(a)
        tau = np.zeros(6)
        tau[3:] = a * 200.0
        ref.do_simulation(tau, 4)
        assert np.isfinite(r) and not d
    np.testing.assert_allclose(env.state_vector(), ref.state_vector(),
                               rtol=0, atol=1e-12)

    class Tiny(DartEnv):
        def __init__(self):
            DartEnv.__init__(self, "hopper_capsule.skel", 2, 4,
                             np.array([[1.0], [-1.0]]), dt=0.001,
                             device="cpu")

    e = Tiny()
    assert float(e.model.dt) == 0.001 and e.dt == pytest.approx(0.002)


def test_custom_env_urdf_and_sdf_raise():
    """.urdf and .sdf paths load (tests/test_torch_loaders.py); a path
    that is neither a file nor an asset raises, as does the reference
    signature without its sizes."""
    for path in ("robot.urdf", "world.sdf", "robot.skel"):
        with pytest.raises(FileNotFoundError, match=path):
            DartEnv(path, 4, 11, np.array([[1.0], [-1.0]]), device="cpu")
    with pytest.raises(gym.error.Error):
        DartEnv("hopper_capsule.skel", device="cpu")


def test_custom_env_composes_two_skeletons(tmp_path):
    """A file with two mobile skeletons (tests/test_multiskeleton.py's ram
    and box): both survive, the robot is the last, a robot-sized tau
    drives only the ram, and the first do_simulation steps equal the JAX
    env's in float64 (1e-10)."""
    from dartenv_tpu.envs.base import _CustomTask as JCustomTask
    from dartenv_tpu.model.compose import compose_models
    from dartenv_tpu.model.skel_parser import parse_skel as jparse
    from test_multiskeleton import _RAM_BOX_XML

    p = tmp_path / "ram_box.skel"
    p.write_text(_RAM_BOX_XML)
    bounds = np.array([[1.0], [-1.0]])
    env = DartEnv([str(p)], frame_skip=5, observation_size=14,
                  action_bounds=bounds, device="cpu", dtype=torch.float64)
    jmodel = compose_models(jparse(str(p), dtype=jnp.float64).skeletons)
    jenv = JDartEnv(JCustomTask(jmodel, 5, 14, bounds))
    for e in (env, jenv):
        e.seed(4)
        e.reset()
    assert len(env.world.skeletons) == 2
    obj, ram = env.world.skeletons
    assert env.robot_skeleton is ram
    assert (obj.ndofs, ram.ndofs) == (6, 1)
    assert env.model.skel_ranges == jmodel.skel_ranges
    for _ in range(8):
        env.do_simulation(np.array([8.0]), 5)
        jenv.do_simulation(np.array([8.0]), 5)
    np.testing.assert_allclose(env.state_vector(), jenv.state_vector(),
                               rtol=0, atol=1e-10)
    assert ram.dq[0] > 0.0
    with pytest.raises(gym.error.Error):
        env.do_simulation(np.zeros(3), 1)


def test_image_observations_match_jax():
    """obs_type="image": reset and step return the frame at the
    constructor's screen size, equal to the JAX env's frame (every
    pixel)."""
    kw = dict(obs_type="image", screen_width=80, screen_height=45)
    jenv = JDartEnv(jax_hopper(dtype=jnp.float64), **kw)
    env = DartEnv(make_hopper_task(dtype=torch.float64, device="cpu"), **kw)
    for e in (env, jenv):
        e.seed(2)
    f, jf = env.reset(), jenv.reset()
    assert f.shape == (45, 80, 3) and f.dtype == np.uint8
    np.testing.assert_array_equal(f, jf)
    a = np.array([0.2, -0.1, 0.3])
    f, r, d, _ = env.step(a)
    jf, jr, jd, _ = jenv.step(a)
    np.testing.assert_array_equal(f, jf)
    assert abs(r - jr) <= STEP_TOL and d == jd


def test_step_copies_once_and_reports_time():
    """A control step returns numpy, the state keeps its (1, n) batch of
    one, and the env's time advances by frame_skip substeps."""
    env = gym.make("DartWalker2d-v1", device="cpu",
                   dtype=torch.float64).unwrapped
    env.seed(0)
    env.reset()
    t0 = time.perf_counter()
    o, r, d, info = env.step(np.zeros(6))
    assert time.perf_counter() - t0 < 10.0
    assert env._state.sim.q.shape == (1, env.model.n)
    assert env._state.sim.lam.shape[0] == 1
    assert env.world.time == pytest.approx(4 * 0.002)
    assert set(info) == {"contact_overflow"}
    assert o.shape == (17,) and isinstance(r, float) and isinstance(d, bool)

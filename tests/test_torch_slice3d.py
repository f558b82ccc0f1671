"""PyTorch port, the 3D fused-substep slice: DartReacher, DartWalker3d and
DartHumanWalker against the JAX package on the same numpy inputs, float64:
  (a) the port's parsed models equal the JAX parser's on every field;
  (b) each task's obs, reward and done on the same states (and the same
      reacher target) within 1e-12, done exact;
  (c) three VecEnv.step calls at B = 4 with the escalation off: q, dq, lam,
      obs and reward within 1e-9, done exact.  The JAX side is its env step
      (what its VecEnv.step vmaps when auto_reset is off) jitted once per
      test and called env by env: a vmapped humanwalker step takes 14 s to
      trace and compile on the CPU, the single-env step 9 s; with the
      escalation on it takes 35-64 s, so the escalation is held on its own
      in tests/test_torch_refine.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.engine.world import SimState as JSimState
from dartenv_tpu.envs.base import EnvState as JEnvState
from dartenv_tpu.envs.base import make_env_step as jax_env_step
from dartenv_tpu.envs.human_walker import make_humanwalker_task as jax_hw
from dartenv_tpu.envs.reacher import make_reacher_task as jax_reacher
from dartenv_tpu.envs.walker3d import make_walker3d_task as jax_w3d
from dartenv_tpu.model import skel_parser as jparser
from dartenv_tpu_torch.engine import hopper_substep as ths
from dartenv_tpu_torch.engine.world import SimState
from dartenv_tpu_torch.envs.human_walker import HumanWalkerTask
from dartenv_tpu_torch.envs.reacher import ReacherTask
from dartenv_tpu_torch.envs.walker3d import Walker3dTask
from dartenv_tpu_torch.model import skel_parser as tparser
from dartenv_tpu_torch.model.convert import env_state_from_numpy
from dartenv_tpu_torch.model.skel_model import FLOAT_LEAVES, STATIC_FIELDS
from dartenv_tpu_torch.parallel.vec_env import VecEnv
from torch_port_util import N, T, port_model

# env -> (asset, JAX task factory, port task class)
ENVS = {
    "reacher": ("reacher.skel", jax_reacher, ReacherTask),
    "walker3d": ("walker3d.skel", jax_w3d, Walker3dTask),
    "humanwalker": ("kima_humanwalker.skel", jax_hw, HumanWalkerTask),
}


@pytest.mark.parametrize("env", sorted(ENVS))
def test_port_parser_matches_jax_parser(env):
    asset = ENVS[env][0]
    jm = jparser.parse_skel(jparser.asset_path(asset),
                            dtype=jnp.float64).robot
    ref = port_model(jm)
    got = tparser.parse_skel(tparser.asset_path(asset), dtype=torch.float64,
                             device="cpu").robot
    for f in STATIC_FIELDS:
        assert getattr(got, f) == getattr(ref, f), f
    for f in FLOAT_LEAVES:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.shape == b.shape, f
        if a.numel():
            assert float((a - b).abs().max()) <= 1e-12, f
    # the whole fused path takes these models, kernel 1's gate included
    assert ths.substep_supported(got)


def _tasks(env, **kw):
    """(JAX task, port task) in float64 on the same model, the port's
    model carried across from the JAX one."""
    _, jfac, tcls = ENVS[env]
    jtask = jfac(dtype=jnp.float64, **kw)
    return jtask, tcls(port_model(jtask.model))


def _states(jtask, B, seed):
    """Seeded (q, dq, target) around the model's initial pose, some envs
    far enough out to end their episode."""
    rng = np.random.default_rng(seed)
    n = jtask.model.n
    q = np.asarray(jtask.model.q_init)[None] + rng.uniform(-0.3, 0.3, (B, n))
    dq = rng.uniform(-3.0, 3.0, (B, n))
    q[0] += 1.5            # far from upright: done for the walkers
    target = rng.uniform(-0.5, 0.5, (B, 3))
    return q, dq, target


@pytest.mark.parametrize("env", sorted(ENVS))
def test_task_obs_reward_done_match_jax(env):
    jtask, ttask = _tasks(env)
    B = 6
    q, dq, target = _states(jtask, B, 7)
    q0, dq0, _ = _states(jtask, B, 8)
    a = np.random.default_rng(9).uniform(-1, 1, (B, ttask.action_size))
    jaux = {"target": jnp.asarray(target)} if env == "reacher" else ()
    taux = {"target": T(target)} if env == "reacher" else ()
    zero = np.zeros(B)
    jsim = JSimState(q=jnp.asarray(q), dq=jnp.asarray(dq),
                     time=jnp.asarray(zero), lam=None)
    jprev = JSimState(q=jnp.asarray(q0), dq=jnp.asarray(dq0),
                      time=jnp.asarray(zero), lam=None)
    tsim = SimState(q=T(q), dq=T(dq), time=T(zero), lam=None)
    tprev = SimState(q=T(q0), dq=T(dq0), time=T(zero), lam=None)
    ax = 0 if env == "reacher" else None
    jobs = jax.vmap(jtask.obs, (0, ax))(jsim, jaux)
    jrew = jax.vmap(jtask.reward, (0, 0, 0, None, ax))(
        jprev, jsim, jnp.asarray(a), None, jaux)
    jdone = jax.vmap(jtask.done, (0, ax))(jsim, jaux)
    tobs = ttask.obs(tsim, taux)
    assert tobs.shape == (B, ttask.obs_size)
    np.testing.assert_allclose(N(tobs), np.asarray(jobs), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(N(ttask.reward(tprev, tsim, T(a), None,
                                              taux)),
                               np.asarray(jrew), rtol=0, atol=1e-12)
    tdone = ttask.done(tsim, taux).numpy()
    np.testing.assert_array_equal(tdone, np.asarray(jdone))
    if env != "reacher":
        assert tdone.any() and not tdone.all()
    np.testing.assert_allclose(
        N(ttask.action_to_tau(T(a), taux)),
        np.asarray(jax.vmap(jtask.action_to_tau, (0, ax))(jnp.asarray(a),
                                                          jaux)),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize("env", sorted(ENVS))
def test_vec_env_steps_match_jax_f64(env):
    """Three VecEnv.step calls (auto_reset=False), B = 4, float64, the
    escalation off: q, dq, lam, obs, reward <= 1e-9; done exact."""
    jtask, ttask = _tasks(env, escalate_frac=0.0)
    B, n = 4, jtask.model.n
    m = jtask.lam_init(jnp.float64).shape[0]
    rng = np.random.default_rng(31)
    q = np.asarray(jtask.model.q_init)[None] + rng.uniform(-0.02, 0.02,
                                                           (B, n))
    dq = rng.uniform(-0.3, 0.3, (B, n))
    if env != "reacher":
        q[:, 4] -= 0.01 * np.arange(B)     # feet pressed into the ground
    target = rng.uniform(-0.5, 0.5, (B, 3))
    taux = {"target": T(target)} if env == "reacher" else ()
    jstates = [JEnvState(
        sim=JSimState(q=jnp.asarray(q[e]), dq=jnp.asarray(dq[e]),
                      time=jnp.zeros(()), lam=jnp.zeros((m,))),
        aux={"target": jnp.asarray(target[e])} if env == "reacher" else (),
        key=jax.random.PRNGKey(e), steps=jnp.zeros((), jnp.int32))
        for e in range(B)]
    tstate = env_state_from_numpy(q, dq, lam=np.zeros((B, m)), aux=taux,
                                  device="cpu", dtype=torch.float64)
    jstep = jax.jit(jax_env_step(jtask))
    tvec = VecEnv(ttask, B, auto_reset=False)
    plain = ths.PLAIN_CALLS
    for _ in range(3):
        a = rng.uniform(-1.3, 1.3, (B, ttask.action_size))
        outs = [jstep(jstates[e], jnp.asarray(a[e])) for e in range(B)]
        jstates = [o[0] for o in outs]
        stack = lambda k: np.stack([np.asarray(o[k]) for o in outs])
        tstate, tobs, trew, tdone, _ = tvec.step(tstate, T(a))
        for name, got, ref in (
                ("q", tstate.sim.q, [s.sim.q for s in jstates]),
                ("dq", tstate.sim.dq, [s.sim.dq for s in jstates]),
                ("lam", tstate.sim.lam, [s.sim.lam for s in jstates]),
                ("obs", tobs, stack(1)), ("reward", trew, stack(2))):
            np.testing.assert_allclose(N(got), np.stack(ref), rtol=0,
                                       atol=1e-9, err_msg=name)
        np.testing.assert_array_equal(tdone.numpy(), stack(3))
    # the fused substep path ran (its plain version, on the CPU), and the
    # constraint rows carried impulses
    assert ths.PLAIN_CALLS > plain and ths.SUBSTEP_LAUNCHES == 0
    if env != "reacher":
        assert np.abs(N(tstate.sim.lam)).max() > 0


def test_reacher_reset_draws_targets_in_the_shell():
    """The reacher's target is drawn on reset from the VecEnv's generator,
    in the shell 0.25 <= r <= 0.75, and auto-reset draws new ones."""
    _, ttask = _tasks("reacher")
    gen = torch.Generator()
    gen.manual_seed(4)
    vec = VecEnv(ttask, 64, max_episode_steps=1, generator=gen)
    state, obs = vec.reset()
    r = torch.linalg.vector_norm(state.aux["target"], dim=-1)
    assert bool(((r >= 0.25 - 1e-12) & (r <= 0.75 + 1e-12)).all())
    assert float(r.std()) > 0.05
    assert torch.equal(obs[:, 10:13], state.aux["target"])
    state2, *_ = vec.step(state, torch.zeros((64, 5), dtype=torch.float64))
    assert not torch.equal(state2.aux["target"], state.aux["target"])

"""PyTorch port, the last three env ids: DartDog, DartReacher2d and
DartSnake7Link against the JAX package on the same numpy inputs, float64:
  (a) the port's parsed models equal the JAX parser's on every field;
  (b) each task's obs, reward, done and action_to_tau on the same states
      (and the same reacher2d target) within 1e-12, done exact;
  (c) three VecEnv.step calls at B = 4 with the escalation off: q, dq,
      lam, obs and reward within 1e-9, done exact, the JAX side its
      single-env step jitted once per test (as tests/test_torch_slice3d.py
      does).  The snake's PLANAR zx root holds its capsules at zero depth,
      so no contact row of the shipped model is ever active; it is also
      stepped on the model with the ground raised by 1 cm ("snake7link_
      sunk"), where all 14 contact slots are active, in both packages;
  (d) reacher2d's reset targets lie in their annulus."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.engine.world import SimState as JSimState
from dartenv_tpu.envs.base import EnvState as JEnvState
from dartenv_tpu.envs.base import make_env_step as jax_env_step
from dartenv_tpu.envs.dog import make_dog_task as jax_dog
from dartenv_tpu.envs.reacher2d import make_reacher2d_task as jax_reacher2d
from dartenv_tpu.envs.snake_7link import make_snake7link_task as jax_snake
from dartenv_tpu.model import skel_parser as jparser
from dartenv_tpu_torch.engine import hopper_substep as ths
from dartenv_tpu_torch.engine.world import SimState
from dartenv_tpu_torch.envs.dog import DogTask
from dartenv_tpu_torch.envs.reacher2d import Reacher2dTask
from dartenv_tpu_torch.envs.snake_7link import Snake7LinkTask
from dartenv_tpu_torch.envs.tasks import _TASKS
from dartenv_tpu_torch.model import skel_parser as tparser
from dartenv_tpu_torch.model.convert import env_state_from_numpy
from dartenv_tpu_torch.model.skel_model import FLOAT_LEAVES, STATIC_FIELDS
from dartenv_tpu_torch.parallel.vec_env import VecEnv
from torch_port_util import N, T, port_model

# env -> (asset, JAX task factory, port task class)
ENVS = {
    "dog": ("dog.skel", jax_dog, DogTask),
    "reacher2d": ("reacher2d.skel", jax_reacher2d, Reacher2dTask),
    "snake7link": ("snake_7link.skel", jax_snake, Snake7LinkTask),
}
SUNK = 0.01      # the raised ground of the "snake7link_sunk" case, m


def test_bench_lists_every_task_of_the_jax_bench():
    from dartenv_tpu.bench.throughput import _TASKS as JAX_TASKS

    assert set(_TASKS) == set(JAX_TASKS)


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


def _tasks(env, sunk=False, **kw):
    """(JAX task, port task) in float64 on the same model, the port's
    model carried across from the JAX one; sunk: the ground raised by
    SUNK in both."""
    _, jfac, tcls = ENVS[env]
    jtask = jfac(dtype=jnp.float64, **kw)
    if sunk:
        jtask.model = jtask.model.replace(
            wg_offset=jtask.model.wg_offset + SUNK)
    return jtask, tcls(port_model(jtask.model))


def _aux(env, target):
    """(JAX aux, port aux) of a batch of targets (reacher2d only)."""
    if env != "reacher2d":
        return (), ()
    return {"target": jnp.asarray(target)}, {"target": T(target)}


@pytest.mark.parametrize("env", sorted(ENVS))
def test_task_obs_reward_done_match_jax(env):
    jtask, ttask = _tasks(env)
    B = 6
    rng = np.random.default_rng(7)
    n = jtask.model.n
    q0 = np.asarray(jtask.model.q_init)[None]
    q = q0 + rng.uniform(-0.3, 0.3, (B, n))
    qp = q0 + rng.uniform(-0.3, 0.3, (B, n))
    dq, dqp = rng.uniform(-3.0, 3.0, (2, B, n))
    if env == "dog":
        q[0, 4] -= 1.0     # torso on the ground: done
        q[1, 0] += 2.0     # tipped over: done
    if env == "snake7link":
        dq[0, 5] = 150.0   # beyond the state bound: done
    target = rng.uniform(-0.5, 0.5, (B, 2))
    a = rng.uniform(-1, 1, (B, ttask.action_size))
    jaux, taux = _aux(env, target)
    zero = np.zeros(B)
    jsim = JSimState(q=jnp.asarray(q), dq=jnp.asarray(dq),
                     time=jnp.asarray(zero), lam=None)
    jprev = JSimState(q=jnp.asarray(qp), dq=jnp.asarray(dqp),
                      time=jnp.asarray(zero), lam=None)
    tsim = SimState(q=T(q), dq=T(dq), time=T(zero), lam=None)
    tprev = SimState(q=T(qp), dq=T(dqp), time=T(zero), lam=None)
    ax = 0 if env == "reacher2d" else None
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
    if env != "reacher2d":
        assert tdone.any() and not tdone.all()
    np.testing.assert_allclose(
        N(ttask.action_to_tau(T(a), taux)),
        np.asarray(jax.vmap(jtask.action_to_tau, (0, ax))(jnp.asarray(a),
                                                          jaux)),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", ["dog", "reacher2d", "snake7link",
                                  "snake7link_sunk"])
def test_vec_env_steps_match_jax_f64(case):
    """Three VecEnv.step calls (auto_reset=False), B = 4, float64, the
    escalation off: q, dq, lam, obs, reward <= 1e-9; done exact."""
    env = case.split("_")[0]
    jtask, ttask = _tasks(env, sunk=case.endswith("sunk"),
                          escalate_frac=0.0)
    B, n = 4, jtask.model.n
    m = jtask.lam_init(jnp.float64).shape[0]
    rng = np.random.default_rng(31)
    q = np.asarray(jtask.model.q_init)[None] + rng.uniform(-0.02, 0.02,
                                                           (B, n))
    dq = rng.uniform(-0.3, 0.3, (B, n))
    if env == "dog":
        q[:, 4] -= 0.01 * np.arange(B)     # feet pressed into the ground
    target = rng.uniform(-0.5, 0.5, (B, 2))
    jaux = [_aux(env, target[e])[0] for e in range(B)]
    taux = _aux(env, target)[1]
    jstates = [JEnvState(
        sim=JSimState(q=jnp.asarray(q[e]), dq=jnp.asarray(dq[e]),
                      time=jnp.zeros(()), lam=jnp.zeros((m,))),
        aux=jaux[e], key=jax.random.PRNGKey(e),
        steps=jnp.zeros((), jnp.int32)) for e in range(B)]
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
    # the fused substep path ran (its plain version, on the CPU)
    assert ths.PLAIN_CALLS > plain and ths.SUBSTEP_LAUNCHES == 0
    st = ths._SubStatic(ttask.model)
    assert st.compact == (env == "dog")
    if case in ("dog", "snake7link_sunk"):
        # contact rows carried impulses
        assert np.abs(N(tstate.sim.lam[:, :3 * st.ns])).max() > 0
    if case == "snake7link":
        assert not np.abs(N(tstate.sim.lam[:, :3 * st.ns])).any()


def test_reacher2d_reset_draws_targets_in_the_annulus():
    """The target is drawn on reset from the VecEnv's generator, in the
    annulus 0.25 <= r <= 0.75 at every angle, and auto-reset draws new
    ones."""
    _, ttask = _tasks("reacher2d")
    gen = torch.Generator()
    gen.manual_seed(4)
    vec = VecEnv(ttask, 256, max_episode_steps=1, generator=gen)
    state, obs = vec.reset()
    t = state.aux["target"]
    assert t.shape == (256, 2)
    r = torch.linalg.vector_norm(t, dim=-1)
    assert bool(((r >= 0.25 - 1e-12) & (r <= 0.75 + 1e-12)).all())
    assert float(r.std()) > 0.1
    angle = torch.atan2(t[:, 1], t[:, 0])
    assert int(torch.histc(angle, bins=4, min=-np.pi, max=np.pi).min()) > 30
    assert torch.equal(obs[:, 4:6], t)
    state2, *_ = vec.step(state, torch.zeros((256, 2), dtype=torch.float64))
    assert not torch.equal(state2.aux["target"], t)

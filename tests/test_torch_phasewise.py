"""PyTorch port, the phase-wise path as a whole, against the JAX package on
the same numpy inputs (float64, CPU):

* a walker2d batch pushed by external forces takes the phase-wise path
  with PGS and exact escalation of the worst envs (escalate_frac 1/32),
  as JAX's make_sim_step with f_ext_world does: 1e-9 over two substeps;
* cartpole, its swing-up variant and the double pendulum (no constraint
  rows: the dynamics phase) step like the JAX tasks: obs, reward and done
  over a few control steps with the same actions and reset noise;
* the perturbation dice of the env step against a numpy transcription of
  the reference's logic, and the vec env's auto-reset of that state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.engine.world import SimState as JSimState
from dartenv_tpu.engine.world import make_sim_step as jax_make_sim_step
from dartenv_tpu.envs.base import EnvState as JEnvState
from dartenv_tpu.envs.base import make_env_step as jax_make_env_step
from dartenv_tpu.envs.cart_pole import (
    make_cartpole_swingup_task as jax_swingup, make_cartpole_task as jax_cp,
)
from dartenv_tpu.envs.double_pendulum import (
    make_double_pendulum_task as jax_dp,
)
from dartenv_tpu.envs.walker2d import make_walker2d_task as jax_walker2d
from dartenv_tpu_torch.engine.world import SimState, make_sim_step
from dartenv_tpu_torch.envs.base import (
    make_env_reset, make_env_step, with_solver,
)
from dartenv_tpu_torch.envs.cart_pole import (
    CartPoleSwingUpTask, CartPoleTask, make_cartpole_task,
)
from dartenv_tpu_torch.envs.double_pendulum import DoubleInvertedPendulumTask
from dartenv_tpu_torch.lcp import hopper_pgs as hp
from dartenv_tpu_torch.parallel.vec_env import VecEnv
from torch_port_util import N, T, port_model


def _pushes(rng, B, nb, body=0, mag=30.0):
    """(B, nb, 6) world forces at `body`'s origin: +-mag along x or y on
    about half of the envs."""
    f = np.zeros((B, nb, 6))
    on = rng.uniform(size=B) < 0.5
    axis = rng.integers(0, 2, B)
    sign = rng.integers(0, 2, B) * 2.0 - 1.0
    f[np.arange(B), body, 3 + axis] = sign * mag * on
    return f


def test_phasewise_escalation_matches_jax_f64():
    """Two substeps of a pushed walker2d batch, B = 8, escalate_frac 1/32
    (K = 1): q, dq and the impulses equal JAX's to 1e-9.  Plain PGS (the
    port's phase-wise solve before escalation was routed there) is farther
    than that from JAX on the same inputs.  contact_cap 1 (m_c = 9 rows
    instead of 24) keeps the JAX side's trace short: its exact solver
    unrolls a factorization of the m_c x m_c operator in every pivot
    body, which at 24 rows alone takes most of the 20 s a test may."""
    jm = jax_walker2d(dtype=jnp.float64, contact_cap=1).model
    assert jm.solver.escalate_frac == 1.0 / 32
    tm = port_model(jm)
    B, n, nb = 8, jm.n, jm.nb
    rng = np.random.default_rng(31)
    q = np.asarray(jm.q_init)[None] + rng.uniform(-0.05, 0.05, (B, n))
    q[:, 1] -= rng.uniform(0.0, 0.03, B)        # press the feet in
    dq = rng.uniform(-0.5, 0.5, (B, n))
    tau = np.concatenate([np.zeros((B, 3)),
                          rng.uniform(-100, 100, (B, n - 3))], 1)
    f_ext = _pushes(rng, B, nb)
    m = 48
    jstep = jax.jit(jax.vmap(jax_make_sim_step(jm)))
    js = JSimState(q=jnp.asarray(q), dq=jnp.asarray(dq), time=jnp.zeros(B),
                   lam=jnp.zeros((B, m)))
    ts = SimState(q=T(q), dq=T(dq), time=T(np.zeros(B)),
                  lam=T(np.zeros((B, m))))
    tstep = make_sim_step(tm)
    pgs_before = hp.PLAIN_CALLS
    for _ in range(2):
        js, _ = jstep(js, jnp.asarray(tau), jnp.asarray(f_ext))
        ts, c = tstep(ts, T(tau), T(f_ext))
    assert hp.PLAIN_CALLS == pgs_before + 2
    for name, got, ref in (("q", ts.q, js.q), ("dq", ts.dq, js.dq),
                           ("lam", ts.lam, js.lam)):
        np.testing.assert_allclose(N(got), np.asarray(ref), rtol=0,
                                   atol=1e-9, err_msg=name)
    assert float(c.active.sum()) > 0
    # the escalation changed the answer: plain PGS is > 1e-6 away
    tm0 = with_solver(tm, escalate_frac=0.0)
    s0 = SimState(q=T(q), dq=T(dq), time=T(np.zeros(B)),
                  lam=T(np.zeros((B, m))))
    step0 = make_sim_step(tm0)
    for _ in range(2):
        s0, _ = step0(s0, T(tau), T(f_ext))
    assert float((s0.dq - ts.dq).abs().max()) > 1e-6


_TASKS = {
    "cartpole": (jax_cp, CartPoleTask),
    "swingup": (jax_swingup, CartPoleSwingUpTask),
    "doublependulum": (jax_dp, DoubleInvertedPendulumTask),
}


@pytest.mark.parametrize("name", sorted(_TASKS))
def test_cartpole_family_matches_jax_f64(name):
    """Reset with the same noise, then 6 control steps with the same
    actions (some beyond the bounds): obs, reward <= 1e-9, done exact; the
    port's steps go through the dynamics phase (plain on a CPU batch)."""
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd

    jfac, tcls = _TASKS[name]
    jtask = jfac(dtype=jnp.float64)
    ttask = tcls(port_model(jtask.model))
    B, n = 6, jtask.model.n
    rng = np.random.default_rng(40)
    noise = rng.uniform(-0.05, 0.05, (2, B, n))
    # two envs start just inside the termination threshold, moving out
    noise[0, :2, 1] = {"cartpole": 0.195, "doublependulum": 1.04,
                       "swingup": 0.0}[name]
    noise[1, :2, 1] = 2.0
    tstate, tobs = make_env_reset(ttask)(B, noise=T(noise))
    jq = np.asarray(jtask.model.q_init)[None] + noise[0]
    if name == "swingup":
        jq[:, 1] += np.pi
    jsim = JSimState(q=jnp.asarray(jq),
                     dq=jnp.asarray(np.asarray(jtask.model.dq_init)[None]
                                    + noise[1]),
                     time=jnp.zeros(B), lam=None)
    jstate = JEnvState(sim=jsim, aux=(),
                       key=jax.random.split(jax.random.PRNGKey(0), B),
                       steps=jnp.zeros(B, jnp.int32))
    np.testing.assert_allclose(N(tobs), np.asarray(jax.vmap(
        lambda s: jtask.obs(s, ()))(jsim)), rtol=0, atol=1e-12)
    jstep = jax.jit(jax.vmap(jax_make_env_step(jtask)))
    tstep = make_env_step(ttask)
    plain_before = hd.PLAIN_CALLS
    dones = []
    for _ in range(6):
        a = rng.uniform(-1.3, 1.3, (B, 1))
        jstate, jobs, jrew, jdone, _ = jstep(jstate, jnp.asarray(a))
        tstate, tobs, trew, tdone, _ = tstep(tstate, T(a))
        np.testing.assert_allclose(N(tobs), np.asarray(jobs), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(N(trew), np.asarray(jrew), rtol=0,
                                   atol=1e-9)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        dones.append(tdone.numpy())
    assert hd.PLAIN_CALLS == plain_before + 6 * ttask.frame_skip
    if name != "swingup":
        assert np.any(dones) and not np.all(dones[-1])


def _numpy_dice(force, ttl, noise, params):
    """The perturbation logic of the reference env step, per substep and
    env, written out in numpy."""
    prob, mag, _, duration = params
    u, axis, sign = noise
    out = []
    for k in range(u.shape[0]):
        start = (ttl <= 0) & (u[k] < prob)
        fresh = np.zeros_like(force)
        fresh[np.arange(len(ttl)), axis[k]] = sign[k] * mag
        live = ttl > 0
        force = np.where(start[:, None], fresh,
                         np.where(live[:, None], force, 0.0))
        ttl = np.where(start, duration, np.maximum(ttl - 1, 0))
        out.append((force.copy(), ttl.copy()))
    return out


def test_perturbation_dice_match_numpy():
    """Cartpole with pushes on the cart, B = 16, 3 control steps with
    handed-in dice: the force and ttl after every control step equal the
    numpy transcription; the per-substep pushed share is reported."""
    task = make_cartpole_task(dtype=torch.float64, device="cpu")
    task.add_perturbation = True
    task.perturbation_parameters = (0.3, 30.0, 0, 3)
    B = 16
    state, _ = make_env_reset(task)(B)
    assert state.aux["perturb_ttl"].dtype == torch.int32
    step = make_env_step(task)
    rng = np.random.default_rng(9)
    force, ttl = np.zeros((B, 3)), np.zeros(B, np.int64)
    for _ in range(3):
        noise = (rng.uniform(size=(2, B)), rng.integers(0, 2, (2, B)),
                 rng.integers(0, 2, (2, B)) * 2.0 - 1.0)
        per_sub = _numpy_dice(force, ttl, noise, task.perturbation_parameters)
        force, ttl = per_sub[-1]
        tnoise = (T(noise[0]), torch.as_tensor(noise[1]), T(noise[2]))
        state, _, _, _, info = step(state, T(np.zeros((B, 1))),
                                    perturb_noise=tnoise)
        np.testing.assert_array_equal(N(state.aux["perturb_force"]), force)
        np.testing.assert_array_equal(state.aux["perturb_ttl"].numpy(), ttl)
        np.testing.assert_allclose(
            N(info["perturb_env_share"]),
            [np.mean(np.abs(f).sum(1) > 0) for f, _ in per_sub])
    assert ttl.max() > 0 and np.abs(force).max() == 30.0


def test_vec_env_auto_reset_resets_the_perturbation_state():
    task = make_cartpole_task(dtype=torch.float64, device="cpu")
    task.add_perturbation = True
    task.perturbation_parameters = (1.0, 30.0, 0, 40)    # always push
    gen = torch.Generator()
    gen.manual_seed(0)
    vec = VecEnv(task, 4, max_episode_steps=2, generator=gen)
    state, _ = vec.reset()
    state, _, _, done, _ = vec.step(state, T(np.zeros((4, 1))))
    assert not done.any()
    assert (state.aux["perturb_ttl"] > 0).all()
    state, _, _, done, _ = vec.step(state, T(np.zeros((4, 1))))
    assert done.all()                     # the time limit ends every env
    assert (state.aux["perturb_ttl"] == 0).all()
    assert (state.aux["perturb_force"] == 0).all()

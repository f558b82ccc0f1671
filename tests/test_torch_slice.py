"""PyTorch port, the slice as a whole: batched env stepping against the
JAX package on the same numpy inputs, the kernel-path sequence of stages,
auto-reset, and a finite rollout with recounted episode statistics."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.engine.world import SimState as JSimState
from dartenv_tpu.envs.base import EnvState as JEnvState
from dartenv_tpu.envs.walker2d import make_walker2d_task as jax_walker2d
from dartenv_tpu.parallel.vec_env import VecEnv as JVecEnv
from dartenv_tpu_torch.bench.throughput import (
    bench_env, make_task, random_policy,
)
from dartenv_tpu_torch.engine import hopper_substep as ths
from dartenv_tpu_torch.engine.world import make_sim_step
from dartenv_tpu_torch.envs.walker2d import Walker2dTask
from dartenv_tpu_torch.model.convert import (
    env_state_from_numpy, sim_state_from_numpy,
)
from dartenv_tpu_torch.parallel.rollout import EpisodeStats, make_rollout
from dartenv_tpu_torch.parallel.vec_env import VecEnv
from test_pallas_interpret import _states, _tiny_model
from torch_port_util import N, T, port_model


def test_vec_env_steps_match_jax_f64():
    """(a) escalation off: three VecEnv.step calls (auto_reset=False) on
    walker2d, B = 4, float64 — q, dq, lam, obs, reward <= 1e-9, done
    exact."""
    jtask = jax_walker2d(dtype=jnp.float64, escalate_frac=0.0)
    ttask = Walker2dTask(port_model(jtask.model))
    B, n = 4, jtask.model.n
    m = jtask.lam_init(jnp.float64).shape[0]
    rng = np.random.default_rng(21)
    q = np.asarray(jtask.model.q_init)[None] + rng.uniform(-0.02, 0.02,
                                                           (B, n))
    q[2, 2] = 0.97                  # pitch near the termination threshold
    dq = rng.uniform(-0.3, 0.3, (B, n))
    dq[2, 2] = 8.0                  # ... and crossing it within the run
    jstate = JEnvState(
        sim=JSimState(q=jnp.asarray(q), dq=jnp.asarray(dq),
                      time=jnp.zeros(B), lam=jnp.zeros((B, m))),
        aux=(), key=jax.random.split(jax.random.PRNGKey(0), B),
        steps=jnp.zeros(B, jnp.int32))
    tstate = env_state_from_numpy(q, dq, lam=np.zeros((B, m)), device="cpu",
                                  dtype=torch.float64)
    jvec = JVecEnv(jtask, B, auto_reset=False)
    tvec = VecEnv(ttask, B, auto_reset=False)
    jstep = jax.jit(jvec.step)
    dones = []
    for _ in range(3):
        a = rng.uniform(-1.3, 1.3, (B, 6))       # some beyond the bounds
        jstate, jobs, jrew, jdone, jinfo = jstep(jstate, jnp.asarray(a))
        tstate, tobs, trew, tdone, tinfo = tvec.step(tstate, T(a))
        for name, got, ref in (
                ("q", tstate.sim.q, jstate.sim.q),
                ("dq", tstate.sim.dq, jstate.sim.dq),
                ("lam", tstate.sim.lam, jstate.sim.lam),
                ("time", tstate.sim.time, jstate.sim.time),
                ("obs", tobs, jobs), ("reward", trew, jrew),
                ("overflow", tinfo["contact_overflow"],
                 jinfo["contact_overflow"])):
            np.testing.assert_allclose(N(got), np.asarray(ref), rtol=0,
                                       atol=1e-9, err_msg=name)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tstate.steps.numpy(),
                                      np.asarray(jstate.steps))
        dones.append(tdone.numpy())
    assert np.any(dones) and not np.all(dones)
    assert np.abs(N(tstate.sim.lam)).max() > 0
    assert ths.PLAIN_CALLS > 0 and ths.SUBSTEP_LAUNCHES == 0


# The JAX side of case (b), run in a child process: the eager interpret-mode
# kernel path compiles thousands of small XLA:CPU programs, after which a
# compile-heavy test later in the same process can crash inside XLA
# (seen with tests/test_pallas_interpret.py followed by
# tests/test_refine_mixed.py).  The child writes its outputs as numpy.
_INTERPRET_CHILD = """
import sys
import conftest  # noqa: F401  (CPU platform, x64, as the suite runs)
import jax
import numpy as np
from dartenv_tpu.engine.pallas_substep import make_substep_phase
from test_pallas_interpret import _states, _tiny_model

jm = _tiny_model(escalate_frac=1.0, escalate_tol=1e-9, pgs_iters=2)
sub = make_substep_phase(jm, interpret=True)
q, dq, tau, lam = _states(jm, 8, seed=3)
q_new, dq_plus, lam_full, c = jax.vmap(sub)(q, dq, lam, tau)
np.savez(sys.argv[1], q_new=q_new, dq_plus=dq_plus, lam_full=lam_full,
         active=c.active, pos=c.pos, normal=c.normal, depth=c.depth,
         friction=c.friction, restitution=c.restitution)
"""


def test_cpu_path_matches_interpret_kernel_path_f32(tmp_path):
    """(b) the shipped sequence of stages with escalation ON: the port's CPU
    path (plain substep -> escalate_batch -> integrate) vs the JAX
    kernel path in interpret mode (un-jitted) on the tiny model, float32,
    at the tolerances of tests/test_pallas_interpret.py."""
    kw = dict(escalate_frac=1.0, escalate_tol=1e-9, pgs_iters=2)
    jm = _tiny_model(**kw)
    B = 8
    q, dq, tau, lam = _states(jm, B, seed=3)
    out = str(tmp_path / "interpret.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(tests)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, tests, os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _INTERPRET_CHILD, out],
                   check=True, cwd=root, env=env, timeout=120)
    ref = np.load(out)
    q_new, dq_plus, lam_full = ref["q_new"], ref["dq_plus"], ref["lam_full"]

    tm = port_model(jm, dtype=torch.float32)
    step = make_sim_step(tm, return_impulses=True)
    state = sim_state_from_numpy(q, dq, lam=lam, device="cpu",
                                 dtype=torch.float32)
    state2, (tcon, tlam) = step(state, T(tau, torch.float32))
    np.testing.assert_allclose(N(state2.q), np.asarray(q_new), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(N(state2.dq), np.asarray(dq_plus),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(N(tlam), np.asarray(lam_full), rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_array_equal(N(tcon.active), ref["active"])
    for f in ("pos", "normal", "depth", "friction", "restitution"):
        np.testing.assert_allclose(N(getattr(tcon, f)), ref[f],
                                   rtol=2e-3, atol=2e-4, err_msg=f)
    # escalation really changed the starved-PGS point
    step0 = make_sim_step(
        port_model(_tiny_model(escalate_frac=0.0, pgs_iters=2),
                   dtype=torch.float32), return_impulses=True)
    _, (_c, lam0) = step0(state, T(tau, torch.float32))
    assert float((tlam - lam0).abs().max()) > 0


def test_auto_reset_selects_per_env():
    """(c) envs with `done` take the reset state built from the given
    numpy noise; the others are untouched."""
    task = make_task("walker2d", dtype=torch.float64, device="cpu",
                     escalate_frac=0.0)
    B, n = 6, task.model.n
    rng = np.random.default_rng(4)
    s = task.reset_noise
    noise0 = rng.uniform(-s, s, (2, B, n))
    vec = VecEnv(task, B, max_episode_steps=3)
    state, obs = vec.reset(noise=noise0)
    np.testing.assert_allclose(
        N(state.sim.q), N(task.model.q_init)[None] + noise0[0], atol=1e-15)
    # envs 1 and 4 are about to hit the step limit, env 2 falls over
    steps = np.array([0, 2, 0, 1, 2, 0])
    q = N(state.sim.q)
    q[2, 2] = 1.5
    state = env_state_from_numpy(q, N(state.sim.dq), lam=N(state.sim.lam),
                                 steps=steps, device="cpu",
                                 dtype=torch.float64)
    a = T(rng.uniform(-1, 1, (B, 6)))
    noise1 = rng.uniform(-s, s, (2, B, n))
    free = VecEnv(task, B, max_episode_steps=3, auto_reset=False)
    st_free, obs_free, rew_free, done_free, _ = free.step(state, a)
    st, ob, rew, done, info = vec.step(state, a, reset_noise=noise1)
    np.testing.assert_array_equal(done.numpy(),
                                  [False, True, True, False, True, False])
    assert torch.equal(done, done_free) and torch.equal(rew, rew_free)
    assert torch.equal(info["terminal_obs"], obs_free)
    d = done.numpy()
    reset_ref, reset_obs = vec.reset(noise=noise1)
    for got, kept, fresh in (
            (st.sim.q, st_free.sim.q, reset_ref.sim.q),
            (st.sim.dq, st_free.sim.dq, reset_ref.sim.dq),
            (st.sim.lam, st_free.sim.lam, reset_ref.sim.lam),
            (st.sim.time, st_free.sim.time, reset_ref.sim.time),
            (st.steps, st_free.steps, reset_ref.steps),
            (ob, obs_free, reset_obs)):
        assert torch.equal(got[~done], kept[~done])
        assert torch.equal(got[done], fresh[done])
    assert st.steps[d].abs().sum() == 0 and st.sim.lam[d].abs().sum() == 0


def test_rollout_finite_and_stats_recount():
    """(d) a 20-step rollout (shipped settings, CPU) stays finite and
    EpisodeStats agrees with a numpy recount of the collected rewards and
    dones."""
    task = make_task("hopper", dtype=torch.float32, device="cpu")
    B, H = 8, 20
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    vec = VecEnv(task, B, max_episode_steps=12, generator=gen)
    state, _ = vec.reset()
    rollout = make_rollout(vec, random_policy(task), H, collect=True)
    state, stats, (obs, act, rew, done) = rollout(None, state, gen)
    assert obs.shape == (H, B, task.obs_size) and act.shape == (H, B, 3)
    for x in (state.sim.q, state.sim.dq, obs, rew):
        assert torch.isfinite(x).all()
    assert float(act.abs().max()) <= 1.0
    rew_n, done_n = N(rew), done.numpy()
    ret = np.zeros(B)
    length = np.zeros(B)
    r_sum = l_sum = eps = 0.0
    for t in range(H):
        ret += rew_n[t]
        length += 1
        r_sum += ret[done_n[t]].sum()
        l_sum += length[done_n[t]].sum()
        eps += done_n[t].sum()
        ret[done_n[t]] = 0
        length[done_n[t]] = 0
    assert eps > 0
    assert float(stats.episodes) == eps
    assert float(stats.lengths_sum) == l_sum
    np.testing.assert_allclose(float(stats.returns_sum), r_sum, rtol=1e-5)
    np.testing.assert_allclose(float(stats.mean_return()), r_sum / eps,
                               rtol=1e-5)
    np.testing.assert_allclose(N(stats.running_return), ret, rtol=1e-5,
                               atol=1e-5)
    # the bench entry point drives the same path (CPU only on request)
    out = bench_env("hopper", batch=4, horizon=3, iters=1,
                    max_episode_steps=5, device="cpu")
    assert out["device"] == "cpu" and out["control_steps_run"] == 6
    assert np.isfinite(out["env_steps_per_s"])

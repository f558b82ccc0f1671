"""PyTorch port, the learner (parallel/train.py) against the JAX
package's on the CPU in float64: the policy carried across by
policy_from_jax (policy_mean, policy_logp), discounted_returns, the
REINFORCE update on a trajectory of the JAX package's hopper rollout
(p - lr * grad at 1e-12), and one full train_step of the port."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu.envs.hopper import make_hopper_task as jax_hopper
from dartenv_tpu.parallel import train as JT
from dartenv_tpu_torch.parallel import train as PT

TOL = 1e-12
T = lambda x: torch.tensor(np.array(x))


def _jax_params(seed=0, obs=11, act=3):
    p = JT.init_policy(jax.random.PRNGKey(seed), obs, act,
                       dtype=jnp.float64)
    # nonzero biases and log_std, so every parameter is exercised
    return {k: v + 0.05 * jax.random.normal(jax.random.PRNGKey(seed + i + 1),
                                            v.shape, v.dtype)
            for i, (k, v) in enumerate(p.items())}


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()))


def test_policy_from_jax():
    params = _jax_params()
    pp = PT.policy_from_jax({k: np.asarray(v) for k, v in params.items()})
    assert set(pp) == set(PT.PARAM_NAMES)
    assert all(v.requires_grad and v.is_leaf for v in pp.values())
    rng = np.random.default_rng(0)
    obs, act = rng.standard_normal((7, 11)), rng.standard_normal((7, 3))
    _close(PT.policy_mean(pp, T(obs)),
           JT.policy_mean(params, jnp.asarray(obs)))
    _close(PT.policy_logp(pp, T(obs), T(act)),
           JT.policy_logp(params, jnp.asarray(obs), jnp.asarray(act)))


def test_init_policy_layout():
    g = torch.Generator().manual_seed(3)
    p = PT.init_policy(g, 11, 3, hidden=16, dtype=torch.float64)
    ref = JT.init_policy(jax.random.PRNGKey(0), 11, 3, hidden=16,
                         dtype=jnp.float64)
    for k, v in ref.items():
        assert tuple(p[k].shape) == v.shape and p[k].dtype == torch.float64
    assert float(p["w3"].detach().abs().max()) < 0.05 < float(
        p["w1"].detach().abs().max())
    assert not p["b1"].any() and not p["log_std"].any()


def test_discounted_returns():
    rng = np.random.default_rng(1)
    rew = rng.standard_normal((9, 5))
    done = rng.uniform(size=(9, 5)) < 0.3
    _close(PT.discounted_returns(T(rew), T(done), 0.97),
           JT.discounted_returns(jnp.asarray(rew), jnp.asarray(done), 0.97))


def test_update_on_the_jax_trajectory():
    """A trajectory of the JAX package's hopper (B = 4, T = 4, from its
    reset states; its policy_sample under fixed keys; the jitted single-env
    step), fed to the port's update: the new parameters equal
    p - lr * jax.grad(loss_fn)(p) of the JAX train step's loss."""
    from dartenv_tpu.envs.base import make_env_reset, make_env_step

    task = jax_hopper(dtype=jnp.float64)
    params = _jax_params(obs=task.obs_size, act=task.action_size)
    reset, step = make_env_reset(task), jax.jit(make_env_step(task))
    states, obs_l = zip(*(reset(k) for k in jax.random.split(
        jax.random.PRNGKey(1), 4)))
    states, obs_t = list(states), jnp.stack(obs_l)
    sample = jax.jit(JT.policy_sample)
    stacks = ([], [], [], [])
    for t in range(4):
        act = sample(params, obs_t, jax.random.PRNGKey(10 + t))
        outs = [step(states[i], act[i]) for i in range(4)]
        for x, y in zip(stacks, (obs_t, act, jnp.stack([o[2] for o in outs]),
                                 jnp.stack([o[3] for o in outs]))):
            x.append(y)
        states = [o[0] for o in outs]
        obs_t = jnp.stack([o[1] for o in outs])
    traj = tuple(jnp.stack(x) for x in stacks)
    obs, act, rew, done = traj
    lr, gamma = 3e-4, 0.99
    rets = JT.discounted_returns(rew, done, gamma)
    adv = rets - jnp.mean(rets)

    def loss_fn(p):
        return -jnp.mean(JT.policy_logp(p, obs, act)
                         * jax.lax.stop_gradient(adv))

    grads = jax.jit(jax.grad(loss_fn))(params)
    pp = PT.policy_from_jax({k: np.asarray(v) for k, v in params.items()})
    new, loss = PT.reinforce_update(pp, tuple(map(T, traj)), lr, gamma)
    _close(loss, jax.jit(loss_fn)(params))
    for k in params:
        assert float(jnp.abs(grads[k]).max()) > 0, k
        _close(new[k], params[k] - lr * grads[k])
        assert new[k].requires_grad and new[k].is_leaf


def test_train_step_on_the_cpu():
    """One full train step of the port (walker2d, B = 8, horizon 3):
    finite loss and parameters, every parameter moved, and the CPU batch
    took the kernels' plain versions only (no launch counter moved)."""
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.lcp import hopper_bpp as hb
    from dartenv_tpu_torch.lcp import hopper_pgs as hp

    launches = lambda: (hs.SUBSTEP_LAUNCHES, hb.CORE_LAUNCHES,
                        hb.FUSED_LAUNCHES, hb.HYBRID_LAUNCHES,
                        hd.DYNAMICS_LAUNCHES, hp.PGS_LAUNCHES)
    before, plain = launches(), hs.PLAIN_CALLS
    task = make_task("walker2d", dtype=torch.float64, device="cpu")
    init_fn, train_step = PT.make_train_step(task, 8, 3)
    g = torch.Generator().manual_seed(0)
    params, state = init_fn(g)
    state, stats, traj = train_step.collect(params, state, g)
    assert traj[0].shape == (3, 8, task.obs_size)
    new, loss = train_step.update(params, traj)
    assert torch.isfinite(loss)
    for k, v in new.items():
        assert torch.isfinite(v).all() and not torch.equal(v, params[k]), k
    new2, state, stats = train_step(new, state, g)
    assert all(torch.isfinite(v).all() for v in new2.values())
    assert torch.isfinite(state.sim.q).all()
    assert launches() == before
    assert hs.PLAIN_CALLS - plain == 2 * 3 * task.frame_skip


def test_init_fn_is_seeded():
    from dartenv_tpu_torch.envs.tasks import make_task

    task = make_task("hopper", dtype=torch.float64, device="cpu")
    init_fn, _ = PT.make_train_step(task, 4, 2)
    (p1, s1), (p2, s2) = (init_fn(torch.Generator().manual_seed(5))
                          for _ in range(2))
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert torch.equal(s1.sim.q, s2.sim.q)

"""One rank of the port's multi-process checks on the CPU (gloo), started
by tests/test_torch_distributed.py as

    python tests/torch_dist_child.py MODE RANK WORLD STORE OUT_DIR

MODE: `stats_train` (a sharded rollout of a cartpole batch under a
deterministic policy, a REINFORCE update on this rank's slice of a fixed
trajectory, then bench_env over the group), `save` (a sharded rollout saved mid-way with
save_sharded, then its continuation) or `load` (restore onto fresh
processes and continue).  STORE is a file:// rendezvous path; each rank
writes its results to OUT_DIR/<mode>_rank<rank>.npz.  Imports torch and
the port only.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the shared inputs of the checks (the test process builds the same)
B = 8                  # cartpole envs over all ranks
HORIZON = 40           # control steps of the stats rollout
T_TRAJ = 5             # steps of the fixed trajectory of the update


def cartpole():
    from dartenv_tpu_torch.envs.cart_pole import make_cartpole_task

    return make_cartpole_task(dtype=torch.float64, device="cpu")


def det_params(task):
    """A deterministic policy's params (a scaled-up init_policy draw)."""
    from dartenv_tpu_torch.parallel.train import init_policy

    p = init_policy(torch.Generator().manual_seed(1), task.obs_size,
                    task.action_size, dtype=torch.float64)
    with torch.no_grad():
        p["w3"].mul_(300.0)
    return p


def det_policy(params, obs, generator=None):
    from dartenv_tpu_torch.parallel.train import policy_mean

    with torch.no_grad():
        return policy_mean(params, obs)


def full_reset(task, seed=0):
    from dartenv_tpu_torch.parallel.vec_env import VecEnv

    vec = VecEnv(task, B, max_episode_steps=1000,
                 generator=torch.Generator().manual_seed(seed))
    return vec


def fixed_traj(obs_size, act_size):
    """(obs, act, rew, done) (T, B, ...) float64, from numpy seed 4."""
    rng = np.random.default_rng(4)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)
    return (t(rng.standard_normal((T_TRAJ, B, obs_size))),
            t(rng.standard_normal((T_TRAJ, B, act_size))),
            t(rng.uniform(0.0, 2.0, (T_TRAJ, B))),
            t(rng.uniform(size=(T_TRAJ, B)) < 0.2))


def stats_train(group, rank, world):
    from dartenv_tpu_torch.parallel.sharding import (
        make_sharded_rollout, sharded_reset,
    )
    from dartenv_tpu_torch.parallel.train import reinforce_update

    task = cartpole()
    vec = full_reset(task)
    params = det_params(task)
    state, _ = sharded_reset(vec, group)
    rollout = make_sharded_rollout(vec, det_policy, HORIZON, group)
    _, stats = rollout(params, state, torch.Generator().manual_seed(2))
    n = B // world
    traj = tuple(x[:, rank * n:(rank + 1) * n]
                 for x in fixed_traj(task.obs_size, task.action_size))
    new, loss = reinforce_update(det_params(task), traj, 3e-4, 0.99, group)
    from dartenv_tpu_torch.bench.throughput import bench_env

    bench = bench_env("cartpole", batch=B, horizon=3, iters=1, device="cpu",
                      group=group)
    return dict(bench_devices=bench["devices"],
                bench_per_chip=bench["env_steps_per_s_per_chip"],
                bench_rate=bench["env_steps_per_s"],
                bench_finite=np.isfinite(bench["mean_return"]),
                returns_sum=stats.returns_sum.numpy(),
                lengths_sum=stats.lengths_sum.numpy(),
                episodes=stats.episodes.numpy(),
                **{"p_" + k: v.detach().numpy() for k, v in new.items()})


def _random_rollout(task, vec, group, horizon):
    from dartenv_tpu_torch.bench.throughput import random_policy
    from dartenv_tpu_torch.parallel.sharding import make_sharded_rollout

    return make_sharded_rollout(vec, random_policy(task), horizon, group)


def save(group, rank, world, out_dir):
    from dartenv_tpu_torch.parallel.sharding import sharded_reset
    from dartenv_tpu_torch.utils.checkpoint import save_sharded

    task = cartpole()
    vec = full_reset(task)
    rollout = _random_rollout(task, vec, group, 3)
    gen = torch.Generator().manual_seed(5)
    state, _ = sharded_reset(vec, group)
    state, _ = rollout(None, state, gen)
    saved_q = state.sim.q.clone()
    save_sharded(os.path.join(out_dir, "ckpt"), {"state": state, "gen": gen},
                 group, step=3)
    for _ in range(2):
        state, _ = rollout(None, state, gen)
    return dict(saved_q=saved_q.numpy(), q=state.sim.q.numpy(),
                dq=state.sim.dq.numpy(), steps=state.steps.numpy())


def load(group, rank, world, out_dir):
    from dartenv_tpu_torch.parallel.sharding import sharded_reset
    from dartenv_tpu_torch.utils.checkpoint import load_sharded

    task = cartpole()
    vec = full_reset(task, seed=99)        # another batch: overwritten
    rollout = _random_rollout(task, vec, group, 3)
    like = {"state": sharded_reset(vec, group)[0],
            "gen": torch.Generator().manual_seed(999)}
    tree = load_sharded(os.path.join(out_dir, "ckpt"), like, group, step=3)
    state, gen = tree["state"], tree["gen"]
    restored_q = state.sim.q.clone()
    for _ in range(2):
        state, _ = rollout(None, state, gen)
    return dict(restored_q=restored_q.numpy(), q=state.sim.q.numpy(),
                dq=state.sim.dq.numpy(), steps=state.steps.numpy())


def main():
    mode, rank, world, store, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from dartenv_tpu_torch.parallel.sharding import distributed_init

    import torch.distributed as dist

    group = distributed_init("cpu", store, world, rank, timeout_s=60.0)
    try:
        if mode == "stats_train":
            out = stats_train(group, rank, world)
        elif mode == "save":
            out = save(group, rank, world, out_dir)
        else:
            out = load(group, rank, world, out_dir)
        np.savez(os.path.join(out_dir, f"{mode}_rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""Env batches split over a torch.distributed process group.

The process group stands where the JAX package's 1-D device mesh stands:
one rank per GPU, the env axis split over the ranks (each keeps a
contiguous slice), the model and the policy replicated.  Envs are
independent, so stepping needs no communication; the only collectives
are at the learner boundary: the episode statistics (`all_reduce`, where
the JAX package `psum`s them) and, in parallel/train.py, the advantage's
global mean and the gradients.

    group = distributed_init("cuda", "tcp://localhost:29500", world, rank)
    rollout = make_sharded_rollout(vec, policy, horizon, group)
    state, obs = sharded_reset(vec, group)
    state, stats = rollout(params, state, generator)

Randomness: each rollout draws one seed from the caller's generator (the
same stream on every rank) and steps with a generator of its rank seeded
from (seed, rank), as the JAX package splits one key per device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from dartenv_tpu_torch.parallel.rollout import EpisodeStats, make_rollout
from dartenv_tpu_torch.parallel.vec_env import VecEnv


def distributed_init(device="cuda", init_method: Optional[str] = None,
                     world_size: int = 1, rank: int = 0, timeout_s=120.0):
    """Join (or, at world size 1, form) the default process group and
    return it.  The backend follows the device the caller names: NCCL for
    "cuda" (this rank's card is rank mod the visible cards), gloo for
    "cpu"; it is never chosen by what happens to initialise, so a failing
    NCCL init raises.  init_method: "tcp://host:port" or "file://path"
    (required: nothing on the machine tells a program of a cluster).  A
    group already formed is returned if its backend is the device's, and
    raises otherwise."""
    import datetime

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"distributed_init({device!r}): the process "
                               f"group is already formed on {have}, not "
                               f"{backend}")
        return dist.group.WORLD
    if init_method is None:
        raise ValueError("distributed_init: give init_method "
                         "(tcp://host:port or file://path)")
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(world_size),
        rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def env_group():
    """The group whose ranks split the env axis (the counterpart of
    env_mesh): the default group."""
    return dist.group.WORLD


def group_shape(group):
    """(world size, rank) of `group` (None: one process, (1, 0))."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """A generator on `device` seeded from (seed, rank): independent
    streams per rank from one seed."""
    state = np.random.SeedSequence([int(seed), int(rank)]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


def _tree_map(fn, tree):
    """fn applied to every tensor leaf of a tree of dataclasses, dicts,
    tuples and lists (None and other leaves pass through)."""
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    return tree


def replicate_model(tree, group):
    """The model / params identical on every rank: each tensor leaf is
    broadcast from the group's first rank, in place.  Returns the tree."""
    if group is None:
        return tree
    src = dist.get_global_rank(group, 0)

    def bcast(t):
        with torch.no_grad():
            dist.broadcast(t, src=src, group=group)
        return t

    return _tree_map(bcast, tree)


def shard_env_batch(tree, group):
    """Each rank's contiguous slice of the leading env axis of every tensor
    leaf (a copy).  Raises unless the axis divides over the ranks."""
    world, rank = group_shape(group)

    def take(t):
        if t.ndim == 0 or t.shape[0] % world:
            raise ValueError(f"shard_env_batch: env axis {tuple(t.shape)} "
                             f"does not split over {world} ranks")
        n = t.shape[0] // world
        return t[rank * n:(rank + 1) * n].clone()

    return _tree_map(take, tree)


def _local_env(vec_env: VecEnv, group) -> VecEnv:
    world, _ = group_shape(group)
    if vec_env.num_envs % world:
        raise ValueError(f"num_envs={vec_env.num_envs} must divide over "
                         f"{world} ranks")
    return VecEnv(vec_env.task, vec_env.num_envs // world,
                  max_episode_steps=vec_env.max_episode_steps,
                  auto_reset=vec_env.auto_reset)


def reduce_stats(stats: EpisodeStats, group) -> EpisodeStats:
    """Episode totals summed over the group (one all_reduce); the
    per-env running accumulators stay local."""
    if group is None:
        return stats
    tot = torch.stack([stats.returns_sum, stats.lengths_sum,
                       stats.episodes])
    dist.all_reduce(tot, group=group)
    return dataclasses.replace(stats, returns_sum=tot[0],
                               lengths_sum=tot[1], episodes=tot[2])


def make_sharded_rollout(vec_env: VecEnv, policy_fn: Callable,
                         horizon: int, group, collect: bool = False,
                         step_hook: Callable = None):
    """rollout(params, state, generator) -> (state, stats[, traj]) of this
    rank's slice of `vec_env`'s batch (`state` is the rank's slice, as
    shard_env_batch gives it).  The episode totals are summed over the
    group; with `collect` the (T, B / world, ...) stacks of
    (obs, action, reward, done) of this rank's envs are returned too.
    The rank's generator (policy samples and auto-resets) is seeded from
    (a seed drawn from `generator`, rank)."""
    local = _local_env(vec_env, group)
    _, rank = group_shape(group)
    local_rollout = make_rollout(local, policy_fn, horizon, collect=collect,
                                 step_hook=step_hook)

    def rollout(params, state, generator=None):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device if generator
                                 is not None else "cpu"))
        g = rank_generator(seed, rank, local.device)
        local.generator = g
        out = local_rollout(params, state, g)
        return (out[0], reduce_stats(out[1], group)) + tuple(out[2:])

    return rollout


def sharded_reset(vec_env: VecEnv, group):
    """Reset the whole batch (from `vec_env`'s generator, the same on
    every rank) and keep this rank's slice: (state, obs)."""
    state, obs = vec_env.reset()
    return shard_env_batch(state, group), shard_env_batch(obs, group)


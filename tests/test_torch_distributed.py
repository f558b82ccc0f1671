"""PyTorch port, the env axis over a torch.distributed process group on the
CPU (gloo), two ranks in child processes (tests/torch_dist_child.py): the
episode totals they all_reduce equal one process's rollout of the whole
batch; a two-rank REINFORCE update equals the one-rank update on the same
trajectory (the global advantage mean and the gradient mean); bench_env
reports the group's size and its per-chip rate; a restart
of all ranks restores each rank's own envs from save_sharded and
reproduces the continuation to the bit."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_child as child
import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu_torch.parallel.rollout import make_rollout
from dartenv_tpu_torch.parallel.sharding import (
    group_shape, make_sharded_rollout, rank_generator, shard_env_batch,
)
from dartenv_tpu_torch.parallel.train import reinforce_update

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2


def run_ranks(mode, tmp_path, world=WORLD):
    """Start `world` ranks of torch_dist_child.py in `mode` and wait for
    them (60 s each at most); returns their results."""
    store = "file://" + str(tmp_path / f"store_{mode}")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_child.py"), mode,
         str(r), str(world), store, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(tmp_path / f"{mode}_rank{r}.npz"))
            for r in range(world)]


def test_group_helpers_without_a_group():
    assert group_shape(None) == (1, 0)
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(shard_env_batch({"a": (x, None)}, None)["a"][0], x)
    a = torch.rand(3, generator=rank_generator(7, 0, "cpu"))
    b = torch.rand(3, generator=rank_generator(7, 1, "cpu"))
    c = torch.rand(3, generator=rank_generator(7, 0, "cpu"))
    assert torch.equal(a, c) and not torch.equal(a, b)


def test_distributed_init_keeps_the_devices_backend(tmp_path):
    """A gloo group formed first is returned for "cpu" and refused for
    "cuda": the learner's collectives never drop to gloo on card tensors."""
    import torch.distributed as dist

    from dartenv_tpu_torch.parallel.sharding import (
        distributed_init, env_group,
    )

    group = distributed_init("cpu", "file://" + str(tmp_path / "store"))
    try:
        assert dist.get_backend() == "gloo"
        assert distributed_init("cpu") is group and env_group() is group
        with pytest.raises(RuntimeError, match="gloo, not nccl"):
            distributed_init("cuda")
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_two_ranks_stats_and_update_equal_one_process(tmp_path):
    ranks = run_ranks("stats_train", tmp_path)
    task = child.cartpole()
    vec = child.full_reset(task)
    params = child.det_params(task)
    state, _ = vec.reset()
    _, stats = make_rollout(vec, child.det_policy, child.HORIZON)(
        params, state, torch.Generator().manual_seed(2))
    # episodes end inside the horizon, so the totals are data
    assert 0 < float(stats.episodes) < child.B
    for r in ranks:
        for k in ("returns_sum", "lengths_sum", "episodes"):
            np.testing.assert_allclose(r[k], float(getattr(stats, k)),
                                       rtol=1e-12, atol=0)
    # bench_env over the group: the rate over both ranks' envs, per chip
    for r in ranks:
        assert int(r["bench_devices"]) == WORLD and bool(r["bench_finite"])
        np.testing.assert_allclose(r["bench_per_chip"] * WORLD,
                                   r["bench_rate"], rtol=1e-12)
    # the update: two ranks on halves of the trajectory, one on the whole
    traj = child.fixed_traj(task.obs_size, task.action_size)
    one, _ = reinforce_update(child.det_params(task), traj, 3e-4, 0.99)
    for k, v in one.items():
        assert not torch.equal(v, params[k]), k
        for r in ranks:
            np.testing.assert_allclose(r["p_" + k], v.detach().numpy(),
                                       rtol=0, atol=1e-12)


def test_restart_all_ranks_restores_each_ranks_own_envs(tmp_path):
    saved = run_ranks("save", tmp_path)
    loaded = run_ranks("load", tmp_path)
    # the two ranks hold different envs, and each got back its own
    assert not np.array_equal(saved[0]["saved_q"], saved[1]["saved_q"])
    for s, ld in zip(saved, loaded):
        np.testing.assert_array_equal(ld["restored_q"], s["saved_q"])
        for k in ("q", "dq", "steps"):
            np.testing.assert_array_equal(ld[k], s[k])


def test_sharded_rollout_one_rank_is_the_plain_rollout():
    """With no group the sharded rollout steps the whole batch under the
    rank generator of the drawn seed."""
    task = child.cartpole()
    vec = child.full_reset(task)
    params = child.det_params(task)
    state, _ = vec.reset()
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    s1, st1 = make_sharded_rollout(vec, child.det_policy, 6, None)(
        params, state, g1)
    s2, st2 = make_rollout(vec, child.det_policy, 6)(params, state, g2)
    assert torch.equal(s1.sim.q, s2.sim.q)
    assert float(st1.returns_sum) == float(st2.returns_sum)


def test_env_axis_must_divide(monkeypatch):
    from dartenv_tpu_torch.parallel import sharding, train

    task = child.cartpole()
    monkeypatch.setattr(sharding, "group_shape", lambda g: (3, 0))
    monkeypatch.setattr(train, "group_shape", lambda g: (3, 0))
    with pytest.raises(ValueError, match="divide"):
        sharding.make_sharded_rollout(child.full_reset(task),
                                      child.det_policy, 2, object())
    with pytest.raises(ValueError, match="divide"):
        train.make_train_step(task, child.B, 2, group=object())

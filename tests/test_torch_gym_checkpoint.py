"""PyTorch port, checkpoint and resume (utils/checkpoint.py): the .npz +
treedef round trip over the port's frozen dataclasses and a
torch.Generator, rejected mismatches, a bit-identical resume of a cartpole
VecEnv (B = 4, as tests/test_checkpoint.py), and the restart-and-restore
flow of tests/test_recovery.py across a process boundary with the
generator's state."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu_torch.engine.world import SimState
from dartenv_tpu_torch.envs.cart_pole import make_cartpole_task
from dartenv_tpu_torch.parallel.vec_env import VecEnv
from dartenv_tpu_torch.utils import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    sim = SimState(q=torch.arange(6.0, dtype=torch.float64).reshape(2, 3),
                   dq=torch.full((2, 3), float(seed)), time=torch.zeros(2))
    return {"sim": sim, "b": (torch.zeros(4, dtype=torch.int32), 3, 0.5),
            "gen": g, "none": None, "arr": np.ones(2)}


def test_npz_roundtrip(tmp_path):
    tree = _tree(1)
    path = os.path.join(tmp_path, "state")
    ckpt.save_pytree(path, tree)
    assert os.path.exists(path + ".npz")
    assert os.path.exists(path + ".treedef.json")
    like = _tree(9)
    out = ckpt.load_pytree(path, like)
    assert isinstance(out["sim"], SimState) and out["sim"].lam is None
    for f in ("q", "dq", "time"):
        x, y = getattr(out["sim"], f), getattr(tree["sim"], f)
        assert torch.equal(x, y) and x.dtype == y.dtype
    assert torch.equal(out["b"][0], tree["b"][0]) and out["b"][1:] == (3,
                                                                       0.5)
    assert out["gen"] is like["gen"]           # restored in place
    assert torch.equal(torch.rand(5, generator=out["gen"]),
                       torch.rand(5, generator=tree["gen"]))
    np.testing.assert_array_equal(out["arr"], tree["arr"])


def test_mismatch_rejected(tmp_path):
    path = os.path.join(tmp_path, "state")
    ckpt.save_pytree(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_pytree(path, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="structure"):
        ckpt.load_pytree(path, {"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure"):
        ckpt.load_pytree(path, {"a": (torch.zeros(3),)})
    ckpt.save_pytree(path, _tree(0))
    bad = _tree(0)
    bad["sim"] = dataclasses.replace(bad["sim"], time=torch.zeros(3))
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_pytree(path, bad)


def test_vec_env_resume_bit_identical(tmp_path):
    """Save mid-rollout (state and generator), go on live, then resume
    from the checkpoint into a VecEnv and a generator built anew: obs,
    reward and done equal to the bit, through auto-resets drawn from the
    generator."""
    task = make_cartpole_task(dtype=torch.float64, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    env = VecEnv(task, num_envs=4, max_episode_steps=6, generator=gen)
    state, _ = env.reset()
    acts = torch.full((4, 1), 0.3, dtype=torch.float64)
    for _ in range(5):
        state, *_ = env.step(state, acts)
    path = os.path.join(tmp_path, "mid")
    ckpt.save_pytree(path, (state, gen))

    def run(env, state, n=8):
        out = []
        for _ in range(n):
            state, obs, r, d, _ = env.step(state, acts)
            out.append(torch.cat([obs, r[:, None], d[:, None].double()], 1))
        return torch.stack(out)

    live = run(env, state)
    gen2 = torch.Generator()
    env2 = VecEnv(task, num_envs=4, max_episode_steps=6, generator=gen2)
    template, _ = env2.reset()
    state2, g = ckpt.load_pytree(path, (template, gen2))
    assert g is gen2
    resumed = run(env2, state2)
    assert torch.equal(live, resumed)
    assert bool((live[:, :, -1] > 0).any())        # an auto-reset ran


_PRE = r"""
import sys
import numpy as np
import torch
from dartenv_tpu_torch.envs.hopper import make_hopper_task
from dartenv_tpu_torch.parallel.vec_env import VecEnv
from dartenv_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)
DIR = sys.argv[1]
task = make_hopper_task(dtype=torch.float64, device="cpu")
gen = torch.Generator()
vec = VecEnv(task, num_envs=8, max_episode_steps=5, generator=gen)
acts = torch.zeros((8, task.action_size), dtype=torch.float64)

def run(state, n):
    traj = []
    for _ in range(n):
        state, obs, r, d, _ = vec.step(state, acts)
        traj.append(obs.numpy())
    return state, np.stack(traj)
"""

_PROC_A = _PRE + r"""
gen.manual_seed(7)
state, _ = vec.reset()
state, _ = run(state, 3)                          # pre-failure work
ckpt.save_pytree(DIR + "/ckpt", (state, gen))     # periodic checkpoint
_, golden = run(state, 6)                         # the continuation
np.save(DIR + "/golden.npy", golden)
print("A-DONE")
"""

_PROC_B = _PRE + r"""
# the restarted job: only the checkpoint on disk; the template comes
# from the same env construction with an unseeded generator
template, _ = vec.reset()
state, _ = ckpt.load_pytree(DIR + "/ckpt", (template, gen))
_, resumed = run(state, 6)
np.save(DIR + "/resumed.npy", resumed)
print("B-DONE")
"""


def _run_child(tmp_path, name, code):
    script = os.path.join(tmp_path, name + ".py")
    with open(script, "w") as f:
        f.write(code)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, script, str(tmp_path)],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out.stdout


def test_restart_and_restore_flow(tmp_path):
    """Process A rolls out, checkpoints state and generator, and records
    its continuation; process B restores and must reproduce it to the
    bit, auto-resets (every 5 steps) included."""
    assert "A-DONE" in _run_child(str(tmp_path), "proc_a", _PROC_A)
    assert "B-DONE" in _run_child(str(tmp_path), "proc_b", _PROC_B)
    golden = np.load(os.path.join(str(tmp_path), "golden.npy"))
    resumed = np.load(os.path.join(str(tmp_path), "resumed.npy"))
    np.testing.assert_array_equal(resumed, golden)

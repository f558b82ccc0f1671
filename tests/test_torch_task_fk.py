"""The task hooks that read one body's pose run forward kinematics along
that body's chain only: their results equal, bit for bit, the same
formula computed through the full fk_positions, on states at the done
thresholds (float32, B = 16, CPU), and walker2d's done test dispatches a
bounded number of ops, so that a later edit cannot bring the full pass
back unnoticed."""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu_torch.dynamics.algorithms import (body_point_world,
                                                    fk_positions)
from dartenv_tpu_torch.engine.world import SimState
from dartenv_tpu_torch.envs.tasks import make_task
from dartenv_tpu_torch.math.spatial import mv

B = 16


def _sim(task, seed, scale=0.3):
    m = task.model
    g = torch.Generator().manual_seed(seed)
    q = m.q_init + scale * (2.0 * torch.rand((B, m.n), generator=g,
                                             dtype=m.dtype) - 1.0)
    dq = 2.0 * torch.rand((B, m.n), generator=g, dtype=m.dtype) - 1.0
    return SimState(q=q, dq=dq, time=q.new_zeros(B))


def _torso_com(task, q):
    """The torso's COM through the full pass."""
    R_w, p_w = fk_positions(task.model, q)
    t = task.torso_body
    return p_w[:, t] + mv(R_w[:, t], task.model.com[t])


def _at_thresholds(task, sim, heights, pitches):
    """`sim` with the torso's height moved to `heights` (through the root's
    vertical dof) and the pitch dof set to `pitches`: states that straddle
    the done test's bounds."""
    q = sim.q.clone()
    q[:, 2] = torch.tensor(pitches, dtype=q.dtype)
    h = _torso_com(task, q)[:, 1]
    q[:, 1] += torch.tensor(heights, dtype=q.dtype) - h
    return SimState(q=q, dq=sim.dq, time=sim.time)


def _done_via_full_fk(sim, task, lo, hi, pitch_max):
    s = torch.cat([sim.q, sim.dq], dim=-1)
    height, pitch = _torso_com(task, sim.q)[:, 1], sim.q[:, 2]
    ok = (torch.all(torch.isfinite(s), dim=-1)
          & torch.all(torch.abs(s[:, 2:]) < 100.0, dim=-1)
          & (height > lo))
    if hi is not None:
        ok = ok & (height < hi)
    return ~(ok & (torch.abs(pitch) < pitch_max))


# (task, height bounds of its done test, pitch bound)
PLANAR = [("walker2d", 0.8, 2.0, 1.0), ("hopper", 0.7, None, 0.2)]


@pytest.mark.parametrize("name,lo,hi,pitch_max", PLANAR)
def test_planar_done_matches_full_fk(name, lo, hi, pitch_max):
    task = make_task(name, device="cpu")
    e = (-1e-3, -1e-6, 0.0, 1e-6)
    top = hi if hi is not None else 1.5
    heights = [lo + d for d in e] + [top + d for d in e] + [1.2] * 8
    pitches = ([0.0] * 8 + [pitch_max + d for d in e]
               + [-pitch_max + d for d in e])
    sim = _at_thresholds(task, _sim(task, 3), heights, pitches)
    height, pitch = task.height_pitch(sim)
    assert torch.equal(height, _torso_com(task, sim.q)[:, 1])
    assert torch.equal(pitch, sim.q[:, 2])
    done = task.done(sim, None)
    assert torch.equal(done, _done_via_full_fk(sim, task, lo, hi, pitch_max))
    assert done.any() and not done.all()


@pytest.mark.parametrize("name,hook", [("walker3d", "pelvis_pose"),
                                       ("dog", "torso_pose")])
def test_root_pose_hooks_match_full_fk(name, hook):
    task = make_task(name, device="cpu")
    b = task.pelvis_body if name == "walker3d" else task.torso_body
    sim = _sim(task, 4)
    R, p = getattr(task, hook)(sim)
    R_w, p_w = fk_positions(task.model, sim.q)
    assert torch.equal(R, R_w[:, b])
    assert torch.equal(p, p_w[:, b] + mv(R_w[:, b], task.model.com[b]))


@pytest.mark.parametrize("name", ["reacher", "reacher2d", "doublependulum"])
def test_body_point_world_matches_full_fk(name):
    task = make_task(name, device="cpu")
    m = task.model
    q = _sim(task, 5, scale=1.0).q
    off = (0.2, -0.1, 0.3)
    R_w, p_w = fk_positions(m, q)
    for b in range(m.nb):
        ref = p_w[:, b] + mv(R_w[:, b], torch.tensor(off, dtype=q.dtype))
        assert torch.equal(body_point_world(m, q, b, off), ref), b


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


# The done tests of these tasks dispatch 103-110 aten ops (views
# included) along the torso's chain; a full pass over every body would
# dispatch 354 (hopper) to 955 (dog).
DONE_OPS_MAX = 150


@pytest.mark.parametrize("name", ["walker2d", "hopper", "walker3d", "dog"])
def test_done_dispatches_a_bounded_number_of_ops(name):
    task = make_task(name, device="cpu")
    sim = _sim(task, 6)
    task.done(sim, None)
    with _OpCount() as c:
        task.done(sim, None)
    assert c.n <= DONE_OPS_MAX, c.n

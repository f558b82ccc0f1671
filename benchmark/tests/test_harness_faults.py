"""The output check fails a run whose timed path is broken underneath:
the driver's run, cut to a tiny batch on the CPU, with VecEnv.step (or
DartEnv.step) replaced by a faulty one; and it passes the sound run.  The
control (the reference in bfloat16 in the program's place) fails too."""
import dataclasses

import pytest
import torch

from dartenv_tpu_torch.engine import hopper_substep
from dartenv_tpu_torch.envs.base import DartEnv
from dartenv_tpu_torch.lcp import hybrid
from dartenv_tpu_torch.parallel.vec_env import VecEnv

REAL_STEP = VecEnv.step
REAL_GYM_STEP = DartEnv._step
REAL_ESCALATE = hopper_substep.escalate_batch


def unchanged(self, state, actions, **kw):
    """A step that returns its state (and its obs) unchanged."""
    _, _, reward, done, info = REAL_STEP(self, state, actions, **kw)
    obs = self.task.obs(state.sim, state.aux)
    return state, obs, reward, done & False, dict(info, terminal_obs=obs)


def half_left_out(self, state, actions, **kw):
    """The second half of the batch is not stepped."""
    new, obs, reward, done, info = REAL_STEP(self, state, actions, **kw)
    B = state.sim.q.shape[0]
    keep = torch.arange(B, device=state.sim.q.device) >= B // 2
    old_obs = self.task.obs(state.sim, state.aux)

    def pick(a, b):
        if not torch.is_tensor(a):
            return a
        k = keep.reshape((B,) + (1,) * (a.ndim - 1))
        return torch.where(k, b, a)
    sim = dataclasses.replace(new.sim, q=pick(new.sim.q, state.sim.q),
                              dq=pick(new.sim.dq, state.sim.dq),
                              lam=pick(new.sim.lam, state.sim.lam))
    new = dataclasses.replace(new, sim=sim,
                              steps=pick(new.steps, state.steps))
    info = dict(info, terminal_obs=pick(info["terminal_obs"], old_obs))
    return (new, pick(obs, old_obs), pick(reward, torch.zeros_like(reward)),
            done & ~keep, info)


def answer_altered(self, state, actions, **kw):
    """One env's reward altered where the step produces it."""
    new, obs, reward, done, info = REAL_STEP(self, state, actions, **kw)
    reward = reward.clone()
    reward[0] += 0.5
    return new, obs, reward, done, info


def escalation_corrupted(st, cfg, outs, dq_plus, lam_full, exact1,
                         exact2=None, with_diag=False):
    """A wrong kernel 2: the escalation's answer off by 0.5 in every
    velocity of the K envs it re-solves, and nowhere else (their
    positions follow through the integration)."""
    dqp, lamf, diag = REAL_ESCALATE(st, cfg, outs, dq_plus, lam_full,
                                    exact1, exact2, with_diag=True)
    dqp = dqp.index_add(0, diag["idx"], torch.full_like(dqp[diag["idx"]],
                                                        0.5))
    return (dqp, lamf, diag) if with_diag else (dqp, lamf)


def impulses_corrupted(real):
    """A wrong kernel 2 in its hybrid mode: `real` (lcp/hybrid.
    escalate_rows, or on the card lcp/hopper_bpp.bpp_hybrid, which take
    the escalated envs' indices eighth) with the impulses of those K envs
    off by 0.5 in every row, and nowhere else."""
    def wrong(*args, **kw):
        lam, *rest = real(*args, **kw)
        idx = args[7]
        return (lam.index_add(0, idx, torch.full_like(lam[idx], 0.5)),
                *rest)
    return wrong


def gym_answer_altered(self, action):
    obs, reward, done, info = REAL_GYM_STEP(self, action)
    return obs, reward + 0.5, done, info


def gym_unchanged(self, action):
    state = self._state
    obs, reward, done, info = REAL_GYM_STEP(self, action)
    self._state = state
    return obs, reward, done, info


@pytest.mark.parametrize("workload", ["walker2d-b8192",
                                      "walker2d-push-b8192"])
def test_sound_run_is_correct(run_tiny, workload):
    out = run_tiny(workload, batch=16)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [unchanged, half_left_out,
                                   answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", ["walker2d-b8192",
                                      "walker2d-push-b8192"])
def test_a_broken_step_is_not_correct(run_tiny, monkeypatch, workload,
                                      fault):
    monkeypatch.setattr(VecEnv, "step", fault)
    out = run_tiny(workload, batch=16)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [gym_unchanged, gym_answer_altered],
                         ids=lambda f: f.__name__)
def test_a_broken_gym_step_is_not_correct(run_tiny, monkeypatch, fault):
    assert run_tiny("walker2d-gym-b1")["correct"]
    monkeypatch.setattr(DartEnv, "_step", fault)
    out = run_tiny("walker2d-gym-b1")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload,batch", [
    ("walker2d-b8192", 16), ("walker2d-push-b8192", 16),
    ("humanwalker-b1024", 4), ("walker2d-gym-b1", None)])
def test_the_control_is_not_correct(run_tiny, workload, batch):
    out = run_tiny(workload, batch=batch, control=True, samples=1)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload,kw", [
    ("walker2d-b8192", dict(batch=64)),
    ("humanwalker-b1024", dict(batch=8, samples=1, seconds=6.0))])
def test_a_wrong_escalation_is_not_correct(run_tiny, monkeypatch, workload,
                                           kw):
    """A fault held to the few envs that kernel 2 re-solves (K of B) is
    caught by the high quantile of the physics gap; on walker2d (2 of 64
    envs a substep) the 75th percentile alone passes it."""
    assert run_tiny(workload, **kw)["correct"]
    monkeypatch.setattr(hopper_substep, "escalate_batch",
                        escalation_corrupted)
    out = run_tiny(workload, **kw)
    assert not out["correct"], out["checks"]


def test_a_wrong_hybrid_escalation_is_not_correct(run_tiny, monkeypatch):
    """The pushed cell's phase-wise path: a fault held to the K envs that
    kernel 2's hybrid mode re-solves (2 of 64 a substep)."""
    monkeypatch.setattr(hybrid, "escalate_rows",
                        impulses_corrupted(hybrid.escalate_rows))
    out = run_tiny("walker2d-push-b8192", batch=64)
    assert not out["correct"], out["checks"]

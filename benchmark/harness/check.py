"""The output check: the program's answers of the sampled control steps
against the plain reference (benchmark/reference/), once the window has
closed.

Each sample holds the batch's state before a control step (`pre`: q, dq,
lam, steps and, with pushes, perturb_force, perturb_ttl), the inputs the
benchmark drew for it (actions, reset noise, push dice) and what the
program answered (`post`: the state after it, obs, reward, done,
terminal_obs).  The reference cannot follow a chaotic rollout from its
start, so it takes the program's own state before each sampled step and
works the step out again from the .skel bytes and the inputs; three
numbers cover the step's stages:

  gap_qNN / gap_max   physics and task: per env, the largest relative gap
                      |x - x_ref| / (1 + |x_ref|) of the terminal obs and
                      the reward, 1 where done differs or only one side is
                      finite; its 50th, 75th, 90th and 99th percentiles and
                      its largest over every env of every sample.  A
                      cell's limits file names the ones it judges: the
                      75th percentile catches half a batch gone wrong, a
                      high one a fault held to the few envs that kernel 2
                      re-solves (K of B a substep), the 90th the gym
                      cell's one env over its sampled steps.  None judges
                      the largest: a float32 escalation whose pivots its
                      budget leaves unconverged parts a rare sampled step
                      from the float64 answer as far as the control does.
  env_gap_max         the env layer alone: obs, reward, done and the step
                      counter of the envs that go on, worked out by the
                      reference's hooks from the program's own states
                      before and after the step; 1 for a wrong flag or
                      counter.
  reset_gap_max       the auto-reset of the envs that finished: their new
                      q, dq (the defaults plus the drawn noise), obs, zero
                      impulses and counter, and zero push state.
"""
from __future__ import annotations

import torch

from benchmark.reference.env import Sim


def rel(x, y):
    """|x - y| / (1 + |y|), with NaN where either side is not finite."""
    return (x - y).abs() / (1.0 + y.abs())


def _row_max(g):
    g = torch.nan_to_num(g, nan=1.0, posinf=1.0)
    return g.reshape(g.shape[0], -1).amax(dim=1)


def compare_batched(ref, samples, max_episode_steps):
    """The three numbers over `samples` (see the module docstring):
    dict(gap=(per-env gaps, all samples), env_gap_max, reset_gap_max,
    envs, live, reset)."""
    if not samples:
        return None
    hooks, ctx, t = ref.hooks, ref.ctx, ref.t
    gaps, env_gap, r_gap = [], 0.0, 0.0
    n_live = n_reset = 0
    for s in samples:
        pre, post, (a, rn, pn) = s["pre"], s["post"], s["inputs"]
        out = ref.step(pre, a, rn, pn, max_episode_steps)
        to_p, r_p = t(post["terminal_obs"]), t(post["reward"])
        d_p = post["done"].to(ref.device)
        g = torch.maximum(_row_max(rel(to_p, out["terminal_obs"])),
                          _row_max(rel(r_p, out["reward"])[:, None]))
        g = torch.where(d_p != out["done"], torch.ones_like(g), g)
        gaps.append(g)
        # the env layer on the program's own states, for the envs that go on
        live = ~d_p
        if bool(live.any()):
            a_c = torch.minimum(torch.maximum(t(a), ref.lo), ref.hi)
            prev = Sim(t(pre["q"])[live], t(pre["dq"])[live])
            new = Sim(t(post["q"])[live], t(post["dq"])[live])
            obs_e = hooks.obs(ctx, new)
            rew_e = hooks.reward(ctx, prev, new, a_c[live])
            steps_p = post["steps"].to(ref.device, torch.int64)[live]
            steps_e = pre["steps"].to(ref.device, torch.int64)[live] + 1
            flag = hooks.done(ctx, new)
            if max_episode_steps is not None:
                flag = flag | (steps_e >= max_episode_steps)
            e = torch.maximum(_row_max(rel(t(post["obs"])[live], obs_e)),
                              _row_max(rel(r_p[live], rew_e)[:, None]))
            bad = flag | (steps_p != steps_e)
            e = torch.where(bad, torch.ones_like(e), e)
            env_gap = max(env_gap, float(e.max()))
            n_live += int(live.sum())
        if rn is not None and bool(d_p.any()):
            e = reset_gap(ref, post, ref.reset(rn), d_p)
            r_gap = max(r_gap, float(e.max()))
            n_reset += int(d_p.sum())
    return dict(gap=torch.cat(gaps), env_gap_max=env_gap,
                reset_gap_max=r_gap, live=n_live, reset=n_reset)


def reset_gap(ref, post, rs, mask=None):
    """Per env, how far the program's reset state `post` (q, dq, obs,
    lam, steps, push state) lies from the reference's `rs` of the same
    noise: relative gaps, 1 for a counter or timer that is not 0."""
    t = ref.t
    sel = (lambda x: x) if mask is None else (lambda x: x[mask])
    e = torch.maximum(_row_max(rel(sel(t(post["q"])), sel(rs["q"]))),
                      _row_max(rel(sel(t(post["dq"])), sel(rs["dq"]))))
    e = torch.maximum(e, _row_max(rel(sel(t(post["obs"])), sel(rs["obs"]))))
    e = torch.maximum(e, _row_max(sel(t(post["lam"])).abs()))
    bad = sel(post["steps"].to(ref.device)) != 0
    if "perturb_force" in post:
        e = torch.maximum(e, _row_max(sel(t(post["perturb_force"])).abs()))
        bad = bad | (sel(post["perturb_ttl"].to(ref.device)) != 0)
    return torch.where(bad, torch.ones_like(e), e)


def compare_start(ref, start, noise):
    """The batch's first reset (its state and obs) against the
    reference's reset of the same noise: the largest reset_gap."""
    return float(reset_gap(ref, start, ref.reset(noise)).max())


def compare_resets(ref, resets, noises):
    """The gym surface's resets, in order (state q, dq: (1, n), and obs),
    against the reference's reset of each next noise of `noises`: the
    largest reset_gap."""
    gap = 0.0
    for (q, dq, obs), noise in zip(resets, noises):
        rs = ref.reset(torch.as_tensor(noise))
        post = dict(q=q, dq=dq, obs=obs, lam=rs["lam"], steps=rs["steps"])
        gap = max(gap, float(reset_gap(ref, post, rs).max()))
    return gap


QUANTILES = (0.5, 0.75, 0.9, 0.99)


def numbers(found):
    """The compared numbers of a comparison's record, by name (none when
    no sample was taken)."""
    if found is None:
        return {}
    g = found["gap"].double()
    q = torch.quantile(g, torch.tensor(QUANTILES, dtype=g.dtype,
                                       device=g.device))
    out = {f"gap_q{round(100 * p)}": float(v) for p, v in zip(QUANTILES, q)}
    out.update(gap_max=float(g.max()), env_gap_max=found["env_gap_max"],
               reset_gap_max=found["reset_gap_max"], envs=int(g.numel()),
               live=found["live"], reset=found["reset"])
    return out


def judge(values, limits):
    """(correct, checks): every number that `limits` names against its
    limit; a number missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks

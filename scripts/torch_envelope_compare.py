"""The batched residual envelope of walker2d in the JAX package's CPU path
and in the port's plain path, on the same inputs (not a test).

    JAX_PLATFORMS=cpu python scripts/torch_envelope_compare.py \
        [--env walker2d] [--batch 4096] [--substeps 25] [--seed 0] \
        [--same_states | --probe SUBSTEP]

Both packages start from the same float32 states (the model's default
pose + U(-0.005, 0.005) on q, U(-0.005, 0.005) on dq, zero warm-start
impulses) and take the same seeded torques (the JAX envelope script's
protocol: U(-1, 1) x the harness torque on the actuated dofs, drawn anew
every frame_skip substeps).  Per substep and env the normalized
complementarity residual (lcp/hybrid.comp_residual: max violation over
the active rows at the point's own friction bounds, over max(1, |x|)) of
the impulses the package keeps, after its escalation of the worst
K = min(128, ceil(B/32)) envs:

  * `jax`: the JAX package's CPU path, `make_sim_step` vmapped (dynamics,
    collision, assembly, PGS and the hybrid solver's batch rule with its
    exact re-solve of the worst K); the residual of the LCP that
    `make_lcp_capture`, vmapped, returns from the same state: the same
    solve the step makes;
  * `torch_capture`: the port's `make_lcp_capture` on the same states as
    the port's rollout below, by the same protocol;
  * `torch_fused`: the port's fused path as the card runs it, in its plain
    versions (`substep_reference`, `escalate_reference`): every env's PGS
    residual with the escalated envs' replaced by the residual of the
    point kept; the rollout follows this path (chip_smoke.py's phase
    `envelope` measures it with the kernels).

Prints one JSON line per package with the median / p95 / max over all
envs and substeps, the same over the envs that hold an impulse, the share
of (env, substep) pairs above 1e-4, and the (env, substep) pairs above
1e-3 and 1e-2.

`--probe SUBSTEP` takes the worst K envs of the port's fused-path rollout
at that substep (their LCPs as the escalation gathers them) and solves
each with the escalation's tier-1 budgets three ways: the port's BPP plain
version (bitwise the port's kernel), the JAX package's BPP Pallas kernel
in interpret mode (its TPU path) and its `dantzig_solve` (its CPU path);
it prints the residuals and how many envs the port and the JAX kernel
solve alike.

`--same_states` instead gives both packages' solvers the same LCPs: along
the port's fused-path rollout, each substep's state goes to the JAX
package's vmapped `make_lcp_capture` (`jax_on_port_states`) and to the
port's (`torch_capture`), so the two differ only by their assembly's
float32 rounding and their solvers (the JAX CPU path re-solves with its
`dantzig_solve`, the port with the BPP kernel's algorithm).
"""
import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402

HARNESS_TORQUE = {"walker2d": 100.0, "hopper": 200.0, "walker3d": 100.0,
                  "dog": 60.0, "humanwalker": 100.0}


def inputs(model_n, q_init, frame_skip, B, T, seed, torque):
    """(q0, dq0, [tau per substep]) as float32 numpy."""
    rng = np.random.default_rng(seed)
    q = (np.broadcast_to(q_init, (B, model_n))
         + rng.uniform(-0.005, 0.005, (B, model_n))).astype(np.float32)
    dq = rng.uniform(-0.005, 0.005, (B, model_n)).astype(np.float32)
    taus = []
    tau = np.zeros((B, model_n), np.float32)
    for k in range(T):
        if k % frame_skip == 0:
            tau = np.zeros((B, model_n), np.float32)
            tau[:, 3:] = (rng.uniform(-1.0, 1.0, (B, model_n - 3))
                          * torque).astype(np.float32)
        taus.append(tau)
    return q, dq, taus


def summary(label, res, held, seconds):
    res, held = np.concatenate(res), np.concatenate(held)
    pct = lambda x: ([float(np.median(x)), float(np.quantile(x, 0.95)),
                      float(x.max())] if x.size else None)
    return dict(package=label, median_p95_max=pct(res),
                median_p95_max_with_impulse=pct(res[held]),
                share_above_1e4=float((res > 1e-4).mean()),
                pairs_above_1e3=int((res > 1e-3).sum()),
                pairs_above_1e2=int((res > 1e-2).sum()),
                pairs=int(res.size), pairs_with_impulse=int(held.sum()),
                seconds=seconds)


def jax_side(env):
    """(task, jitted vmapped sim step, residual(q, dq, lam, tau) -> (res,
    held)) of the JAX package's CPU path, float32."""
    import jax
    import jax.numpy as jnp

    from dartenv_tpu.bench.throughput import make_task
    from dartenv_tpu.engine.world import (
        SimState, make_lcp_capture, make_sim_step,
    )
    from dartenv_tpu.lcp.hybrid import comp_residual

    task = make_task(env, dtype=jnp.float32)
    capture = make_lcp_capture(task.model)

    @jax.jit
    def solve(state, tau):
        p = jax.vmap(capture)(state, tau)
        return p["A"], p["b"], p["lo"], p["hi"], p["mu"], p["active"], \
            p["lam"]

    findex = []

    def residual(q, dq, lam, tau):
        state = SimState(q=jnp.asarray(q), dq=jnp.asarray(dq),
                         time=jnp.zeros(q.shape[0], jnp.float32),
                         lam=jnp.asarray(lam))
        if not findex:
            # the capture's findex is static: read it from one env's
            one = jax.tree_util.tree_map(lambda x: x[0], state)
            findex.append(np.asarray(capture(one, jnp.asarray(tau[0]))[
                "findex"]))
        A, b, lo, hi, mu, act, lam = solve(state, jnp.asarray(tau))
        r = comp_residual(A, b, lam, lo, hi, findex[0], mu, act)
        return (np.asarray(r, np.float64),
                np.abs(np.asarray(lam)).max(axis=1) > 1e-9)

    return task, jax.jit(jax.vmap(make_sim_step(task.model))), residual


def run_jax(env, B, T, seed):
    import jax.numpy as jnp

    from dartenv_tpu.engine.constraints import build_layout
    from dartenv_tpu.engine.world import SimState

    task, step, residual = jax_side(env)
    model = task.model
    q, dq, taus = inputs(model.n, np.asarray(model.q_init),
                         task.frame_skip, B, T, seed, HARNESS_TORQUE[env])
    state = SimState(q=jnp.asarray(q), dq=jnp.asarray(dq),
                     time=jnp.zeros(B, jnp.float32),
                     lam=jnp.zeros((B, build_layout(model).m), jnp.float32))
    t0 = time.time()
    out, held = [], []
    for k in range(T):
        r, h = residual(state.q, state.dq, state.lam, taus[k])
        out.append(r)
        held.append(h)
        state, _ = step(state, jnp.asarray(taus[k]))
    return summary("jax", out, held, time.time() - t0)


def run_torch(env, B, T, seed, jax_residual=None):
    import torch

    from dartenv_tpu_torch.dynamics.batched import integrate_positions
    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.engine.world import SimState, make_lcp_capture
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.lcp import hopper_bpp as hb
    from dartenv_tpu_torch.lcp.hybrid import comp_residual

    task = make_task(env, dtype=torch.float32, device="cpu")
    model, cfg = task.model, task.model.solver
    q, dq, taus = inputs(model.n, model.q_init.numpy(), task.frame_skip,
                         B, T, seed, HARNESS_TORQUE[env])
    q, dq = torch.as_tensor(q), torch.as_tensor(dq)
    st = hs._SubStatic(model)
    exact1, exact2 = hb.tier_solvers(st.findex_c, hb.tier_budgets(
        cfg.escalate_iters, cfg.escalate_refine, cfg.escalate_iters2,
        *st.ref_passes))
    capture = make_lcp_capture(model)
    lam = q.new_zeros((B, st.layout.m))
    t0 = time.time()
    fused, fused_held, cap, cap_held, jx, jx_held = [], [], [], [], [], []
    for k in range(T):
        tau = torch.as_tensor(taus[k])
        if jax_residual is not None:
            r, h = jax_residual(q.numpy(), dq.numpy(), lam.numpy(),
                                taus[k])
            jx.append(r)
            jx_held.append(h)
        p = capture(SimState(q=q, dq=dq, time=q.new_zeros(B), lam=lam), tau)
        cap.append(comp_residual(p["A"], p["b"], p["lam"], p["lo"], p["hi"],
                                 p["findex"], p["mu"], p["active"]
                                 ).double().numpy())
        cap_held.append((p["lam"].abs().amax(1) > 1e-9).numpy())
        outs = hs.substep_reference(model, st, q, dq, tau, lam)
        dq, lam, idx, _, kept = hs.escalate_reference(
            st, cfg, outs, outs["dq_plus"], outs["lam_full"], exact1,
            exact2)
        fused.append(outs["res"][:, 0].index_copy(0, idx, kept)
                     .double().numpy())
        fused_held.append((lam.abs().amax(1) > 1e-9).numpy())
        q = integrate_positions(model, q, dq, st.dt)
    seconds = time.time() - t0
    rows = [summary("torch_capture", cap, cap_held, seconds),
            summary("torch_fused", fused, fused_held, seconds)]
    if jax_residual is not None:
        rows.insert(0, summary("jax_on_port_states", jx, jx_held, seconds))
    return rows


def probe(env, B, seed, substep):
    """The escalated LCPs of the port's fused path at `substep`, solved by
    the port's BPP, the JAX BPP kernel (interpret mode) and the JAX
    dantzig_solve with the tier-1 budgets."""
    import jax
    import jax.numpy as jnp
    import torch

    from dartenv_tpu.lcp.dantzig import dantzig_solve
    from dartenv_tpu.lcp.pallas_bpp import bpp_solve_pallas
    from dartenv_tpu_torch.dynamics.batched import integrate_positions
    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.lcp import hopper_bpp as hb
    from dartenv_tpu_torch.lcp.hybrid import comp_residual

    task = make_task(env, dtype=torch.float32, device="cpu")
    model, cfg = task.model, task.model.solver
    q, dq, taus = inputs(model.n, model.q_init.numpy(), task.frame_skip,
                         B, substep + 1, seed, HARNESS_TORQUE[env])
    q, dq = torch.as_tensor(q), torch.as_tensor(dq)
    st = hs._SubStatic(model)
    budgets = hb.tier_budgets(cfg.escalate_iters, cfg.escalate_refine,
                              cfg.escalate_iters2, *st.ref_passes)
    exact1, exact2 = hb.tier_solvers(st.findex_c, budgets)
    lam = q.new_zeros((B, st.layout.m))
    for k in range(substep + 1):
        tau = torch.as_tensor(taus[k])
        outs = hs.substep_reference(model, st, q, dq, tau, lam)
        if k == substep:
            break
        dq, lam = hs.escalate_reference(st, cfg, outs, outs["dq_plus"],
                                        outs["lam_full"], exact1,
                                        exact2)[:2]
        q = integrate_positions(model, q, dq, st.dt)
    g = hs.gather_escalation(st, cfg, outs)
    prob = [g[k] for k in ("A", "b", "lo", "hi", "mu", "act")]
    A, b, lo, hi, mu, act = prob
    iters, refine, polish = budgets[:3]
    findex = st.findex_c
    port = hb.bpp_solve_reference(A, b, lo, hi, findex, mu, act,
                                  iters=iters, polish_iters=polish,
                                  lam0=g["lam_c"], refine_iters=refine)
    J = lambda x: jnp.asarray(x.numpy())
    jargs = [J(x) for x in prob]
    kern = torch.as_tensor(np.array(bpp_solve_pallas(
        *jargs[:4], findex, jargs[4], jargs[5], iters=iters,
        polish_iters=polish, lam0=J(g["lam_c"]), interpret=True,
        refine_iters=refine)))
    cpu = torch.as_tensor(np.array(jax.vmap(
        lambda a, b_, l, h, m_, c, l0: dantzig_solve(
            a, b_, l, h, findex, m_, c, iters=iters, polish_iters=polish,
            lam0=l0, refine_iters=refine))(*jargs, J(g["lam_c"]))))
    res = lambda x: comp_residual(A, b, x, lo, hi, findex, mu, act,
                                  seq=True).double().numpy()
    pct = lambda r: [float(np.median(r)), float(r.max()),
                     int((r > 1e-4).sum())]
    same = ((port - kern).abs().max(1).values
            / kern.abs().max(1).values.clamp(min=1.0)) <= 1e-5
    return dict(substep=substep, K=int(b.shape[0]), m=int(b.shape[1]),
                budgets=[iters, refine, polish],
                pgs_median_max_above1e4=pct(g["worst"].double().numpy()),
                port_bpp=pct(res(port)), jax_bpp_kernel=pct(res(kern)),
                jax_dantzig_solve=pct(res(cpu)),
                port_equals_jax_kernel=int(same.sum()),
                res_abs_diff_port_jax_kernel=float(np.abs(
                    res(port) - res(kern)).max()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--env", default="walker2d", choices=sorted(
        HARNESS_TORQUE))
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--substeps", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--same_states", action="store_true")
    ap.add_argument("--probe", type=int, default=None, metavar="SUBSTEP")
    args = ap.parse_args()
    head = dict(env=args.env, batch=args.batch, substeps=args.substeps,
                seed=args.seed, dtype="float32", device="cpu",
                same_states=args.same_states)
    if args.probe is not None:
        print(json.dumps({**head, **probe(args.env, args.batch, args.seed,
                                          args.probe)}), flush=True)
        return
    if args.same_states:
        for row in run_torch(args.env, args.batch, args.substeps, args.seed,
                             jax_side(args.env)[2]):
            print(json.dumps({**head, **row}), flush=True)
        return
    print(json.dumps({**head, **run_jax(args.env, args.batch,
                                        args.substeps, args.seed)}),
          flush=True)
    for row in run_torch(args.env, args.batch, args.substeps, args.seed):
        print(json.dumps({**head, **row}), flush=True)


if __name__ == "__main__":
    main()

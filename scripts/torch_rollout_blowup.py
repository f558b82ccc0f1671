"""Runaway envs of a phase-wise rollout in the JAX package and in the port
on the same world and inputs (not a test).

    JAX_PLATFORMS=cpu python scripts/torch_rollout_blowup.py \
        --pkg jax|jax-tpu-path|torch --world multiskel|servo \
        [--batch 1024] [--steps 100] [--dtype float32|float64] [--seed 0] \
        [--torques] [--probe STEP ENV]

The world is `dartenv_tpu_torch.bench.scenes.walker_box_world` (walker2d
composed with a free box, contact cap 10) or `scenes.servo_walker`
(walker2d with servo rows of flimit 50 on its 6 actuated dofs), built
for the JAX side from the JAX package's walker2d task model in the same
way.  Every env starts from the model's default pose; each control step
(frame skip 4) draws, from one numpy generator seeded by --seed, torques
U(-100, 100) on the walker's 6 actuated dofs (multiskel, or the servo
walker with --torques) and servo commands U(-2, 2) rad/s on them (servo).
The same numbers go to both packages.  On the CPU the port runs its
kernels' plain versions; `--pkg jax` runs the JAX package's CPU path (its
exact solver `dantzig_solve`), `--pkg jax-tpu-path` its TPU path, with
the Pallas kernels of the dynamics, PGS and BPP phases in interpret mode
(float32 only: the JAX package sends a float64 batch to its CPU path).

Prints one line per control step on which an env first runs away
(non-finite, or max |dq| > 1e3) and a JSON summary: the runaway envs
with their first step, the largest finite max |dq| over the run, and
how many envs ever exceeded --kick in max |dq|.  `--probe STEP ENV`
traces one env's LCP instead (`probe`).
"""
import argparse
import dataclasses
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402

RUNAWAY_DQ = 1e3


def jax_world(world, dtype):
    import jax.numpy as jnp

    from dartenv_tpu.bench.throughput import make_task
    from dartenv_tpu.model.builder import ModelBuilder
    from dartenv_tpu.model.compose import compose_models
    from dartenv_tpu_torch.bench import scenes

    dt = getattr(jnp, dtype)
    walker = make_task("walker2d", dtype=dt).model
    if world == "servo":
        fl = np.zeros(walker.n)
        fl[3:] = 50.0
        return walker.replace(servo_flimit=jnp.asarray(fl, dt))
    box = scenes.box_skeleton_builder(ModelBuilder).finalize(dtype=dt)
    m = compose_models([walker, box])
    return m.replace(solver=dataclasses.replace(m.solver, contact_cap=10))


def interpret_kernels():
    """Route the JAX package's Pallas kernels to interpret mode, so that a
    step traced under `platform_scope("tpu")` runs its TPU path (kernels
    3, 4 and 2) on the CPU."""
    import functools

    from dartenv_tpu.dynamics import pallas_dynamics
    from dartenv_tpu.lcp import pallas_bpp, pallas_pgs

    for mod, name in ((pallas_dynamics, "dynamics_pallas"),
                      (pallas_bpp, "bpp_solve_pallas"),
                      (pallas_pgs, "pgs_solve_pallas")):
        fn = getattr(mod, name)

        @functools.wraps(fn)
        def forced(*a, _fn=fn, **k):
            k["interpret"] = True
            return _fn(*a, **k)

        setattr(mod, name, forced)


def jax_runner(world, B, dtype, tpu_path=False):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", dtype == "float64")
    from dartenv_tpu.engine.world import init_state, make_do_simulation
    from dartenv_tpu.lcp.pgs import platform_scope

    model = jax_world(world, dtype)
    if tpu_path:
        interpret_kernels()
    with platform_scope("tpu" if tpu_path else "cpu"):
        do_sim = jax.jit(jax.vmap(make_do_simulation(model, 4)))
    st = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(
        x, (B,) + x.shape), init_state(model))
    dt = getattr(jnp, dtype)

    def run(st, tau, cmd):
        with platform_scope("tpu" if tpu_path else "cpu"):
            st, con = do_sim(st, jnp.asarray(tau, dt), None,
                             None if cmd is None else jnp.asarray(cmd, dt))
        return st, np.asarray(st.dq, np.float64)

    return model.n, st, run


def torch_runner(world, B, dtype):
    import torch

    from dartenv_tpu_torch.bench import scenes
    from dartenv_tpu_torch.engine.world import init_state, make_do_simulation

    dt = getattr(torch, dtype)
    model = (scenes.walker_box_world("cpu", dt) if world == "multiskel"
             else scenes.servo_walker("cpu", dt))
    do_sim = make_do_simulation(model, 4)
    st = init_state(model, B)

    def run(st, tau, cmd):
        st, con = do_sim(st, torch.tensor(tau, dtype=dt), None,
                         None if cmd is None else torch.tensor(cmd, dtype=dt))
        return st, st.dq.double().numpy()

    return model.n, st, run


def inputs(rng, B, n, world, torques):
    """(tau, servo commands) of one control step, drawn from rng."""
    tau = np.zeros((B, n))
    cmd = None
    if world == "multiskel" or torques:
        tau[:, 3:9] = rng.uniform(-100.0, 100.0, (B, 6))
    if world == "servo":
        cmd = np.zeros((B, n))
        cmd[:, 3:9] = rng.uniform(-2.0, 2.0, (B, 6))
    return tau, cmd


def probe(a, step, env):
    """--probe STEP ENV (float64): run the port to control step STEP, then
    step its substeps from the port's own state in both packages; at the
    first substep where env ENV parts (|dq| apart > 1e-6), solve that env's
    LCP (the port's assembly, warm PGS point) with the port's exact tier 1,
    the JAX package's `dantzig_solve` and its Pallas BPP kernel in
    interpret mode, and print each point's largest impulse and residual
    (the JAX `comp_residual`) beside the PGS point's, and the first pivot
    after which the port and the Pallas kernel part."""
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_enable_x64", True)
    from dartenv_tpu.engine.world import SimState as JState
    from dartenv_tpu.engine.world import make_sim_step as jax_step
    from dartenv_tpu.lcp.dantzig import dantzig_solve
    from dartenv_tpu.lcp.hybrid import comp_residual
    from dartenv_tpu.lcp.pallas_bpp import bpp_solve_pallas
    from dartenv_tpu_torch.bench import scenes
    from dartenv_tpu_torch.collision.narrowphase import collide
    from dartenv_tpu_torch.dynamics import batched
    from dartenv_tpu_torch.engine import constraints as tc
    from dartenv_tpu_torch.engine.world import make_sim_step
    from dartenv_tpu_torch.lcp import hopper_bpp
    from dartenv_tpu_torch.lcp.hopper_pgs import pgs_solve_batch
    from dartenv_tpu_torch.lcp.hybrid import escalation_size

    B, E = a.batch, env
    n, st, run = torch_runner(a.world, B, "float64")
    rng = np.random.default_rng(a.seed)
    for _ in range(step):
        st, _ = run(st, *inputs(rng, B, n, a.world, a.torques))
    tau, cmd = inputs(rng, B, n, a.world, a.torques)
    T = lambda x: None if x is None else torch.tensor(x)
    model = (scenes.walker_box_world("cpu", torch.float64)
             if a.world == "multiskel"
             else scenes.servo_walker("cpu", torch.float64))
    jm = jax_world(a.world, "float64")
    jstep = jax.jit(jax.vmap(jax_step(jm)))
    tstep = make_sim_step(model)
    for sub in range(4):
        js, _ = jstep(JState(q=jnp.asarray(st.q.numpy()),
                             dq=jnp.asarray(st.dq.numpy()),
                             time=jnp.zeros(B), lam=jnp.asarray(
                                 st.lam.numpy())),
                      jnp.asarray(tau), None,
                      None if cmd is None else jnp.asarray(cmd))
        st2, _ = tstep(st, T(tau), None, T(cmd))
        gap = float(np.abs(np.asarray(js.dq)[E] - st2.dq[E].numpy()).max())
        print(f"substep {sub}: env {E} max |dq| port "
              f"{float(st2.dq[E].abs().max())} JAX "
              f"{float(np.abs(np.asarray(js.dq)[E]).max())}, apart {gap}")
        if gap > 1e-6:
            break
        st = st2
    else:
        return
    cfg, lay = model.solver, tc.build_layout(model)
    q, dq = st.q, st.dq
    kin = batched.bkin(model, q, dq)
    ddq, M = batched.forward_dynamics(model, kin, q, dq, T(tau), model.dt,
                                      None)
    A, b, lo, hi, act, mu, findex, _, row_sel, _ = tc.assemble_lcp(
        model, lay, kin.phi, M, q, dq, dq + model.dt * ddq,
        collide(model, kin.R_w, kin.p_w), model.dt, servo_target=T(cmd))
    lam, res = pgs_solve_batch(
        A, b, lo, hi, findex, mu, act, iters=cfg.pgs_iters,
        omega=cfg.pgs_omega, lam0=tc.compact_lam(st.lam, row_sel, act),
        return_residual=True)
    K = escalation_size(B, cfg.escalate_frac, cfg.escalate_kmax)
    print(f"PGS residual {float(res[E])}, rank {int((res > res[E]).sum())}"
          f" of the worst K = {K}")
    it, rf = cfg.escalate_iters, cfg.escalate_refine
    one = lambda x: x[E:E + 1]
    J = lambda x: jnp.asarray(x[E].numpy())
    prob = [one(x) for x in (A, b, lo, hi, mu, act)]
    jprob = [J(x) for x in (A, b, lo, hi)], [J(x) for x in (mu, act)]

    def port(iters, refine, polish):
        return hopper_bpp.bpp_solve_reference(
            *prob[:4], findex, *prob[4:], iters=iters, polish_iters=polish,
            lam0=one(lam), refine_iters=refine)[0].numpy()

    def pallas(iters, refine, polish):
        return np.asarray(bpp_solve_pallas(
            *[x[None] for x in jprob[0]], findex,
            *[x[None] for x in jprob[1]], iters=iters, polish_iters=polish,
            lam0=J(lam)[None], interpret=True, refine_iters=refine))[0]

    tier1 = hopper_bpp.tier_solvers(findex, hopper_bpp.tier_budgets(
        it, rf, 0))[0]
    pts = {"PGS": lam[E].numpy(),
           "port exact tier 1": tier1(*prob, one(lam))[0].numpy(),
           "JAX dantzig_solve": np.asarray(dantzig_solve(
               *jprob[0], findex, *jprob[1], iters=it, polish_iters=3,
               lam0=J(lam), refine_iters=rf)),
           "JAX Pallas BPP (interpret)": pallas(it, rf, 3)}
    for name, x in pts.items():
        r = float(comp_residual(*jprob[0][:2], jnp.asarray(x),
                                *jprob[0][2:], findex, *jprob[1]))
        print(f"{name}: max |impulse| {np.abs(x).max()}, residual {r}")
    for k in range(1, it + rf + 1):
        d, r = min(k, it), max(0, k - it)
        xp, xj = port(d, r, 0), pallas(d, r, 0)
        print(f"after pivot {k}: max |impulse| port {np.abs(xp).max()} "
              f"Pallas {np.abs(xj).max()}, apart {np.abs(xp - xj).max()}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", choices=("jax", "jax-tpu-path", "torch"),
                    required=True)
    ap.add_argument("--world", choices=("multiskel", "servo"),
                    default="multiskel")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--torques", action="store_true",
                    help="servo world: torques as well as commands")
    ap.add_argument("--kick", type=float, default=10.0,
                    help="count the envs whose max |dq| ever exceeds this")
    ap.add_argument("--probe", type=int, nargs=2, metavar=("STEP", "ENV"),
                    help="float64: trace env ENV's LCP at control step STEP")
    a = ap.parse_args()
    if a.probe:
        return probe(a, *a.probe)
    B = a.batch
    if a.pkg == "torch":
        n, st, run = torch_runner(a.world, B, a.dtype)
    else:
        n, st, run = jax_runner(a.world, B, a.dtype,
                                tpu_path=a.pkg == "jax-tpu-path")
    rng = np.random.default_rng(a.seed)
    first = {}
    kicked = np.zeros(B, bool)
    worst = 0.0
    t0 = time.time()
    for k in range(a.steps):
        st, dq = run(st, *inputs(rng, B, n, a.world, a.torques))
        mx = np.abs(dq).max(1)
        bad = ~np.isfinite(mx) | (mx > RUNAWAY_DQ)
        kicked |= bad | (mx > a.kick)
        new = [int(e) for e in np.nonzero(bad)[0] if int(e) not in first]
        for e in new:
            first[e] = k
        if new:
            print(f"step {k}: envs {new} run away", flush=True)
        if (~bad).any():
            worst = max(worst, float(mx[~bad].max()))
    print(json.dumps(dict(pkg=a.pkg, world=a.world, batch=B,
                          steps=a.steps, dtype=a.dtype, seed=a.seed,
                          torques=a.world == "multiskel" or a.torques,
                          runaway_envs=len(first),
                          first_step=first, max_finite_dq=worst,
                          kick=a.kick, envs_kicked=int(kicked.sum()),
                          seconds=time.time() - t0)))


if __name__ == "__main__":
    main()

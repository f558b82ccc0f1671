#!/usr/bin/env python
"""Runaway envs of the domain-randomization bench's protocol, route by
route.

bench/throughput.bench_dr holds fixed random torques U(-50, 50) on every
dof, the root's included, over a randomized batch (the bench's spec:
mass, geom_friction and damping scaled per env by U(0.7, 1.3)).  On a
model with a FREE root (walker3d) an env of the batch can run away.  This
script runs the protocol (the bench's seeds) through each route and
prints, per route, the envs that end non-finite or beyond |dq| = 1e3 and
the substep at which each first did:

  kernel     the fused route with the DR leaves (the substep kernel's DR
             build, the BPP kernel's fused mode) -- bench_dr's route
  phasewise  the phase-wise route (the dynamics kernel's DR build, the PGS
             kernel, the BPP kernel's hybrid mode)
  nodr       the fused route on the base model, every env's leaves the
             base values (no DR)
  plain64    the fused route's plain versions in float64 on the per-env
             model (a float64 batch runs no kernel)

On a machine with one GPU:
  python scripts/torch_dr_runaway.py --env walker3d
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

RUNAWAY_DQ = 1e3      # rad/s or m/s: an env beyond it has blown up


def run(route, env, B, substeps, dev):
    """First substep at which each env ran away (-1: never), and the
    seconds the route took."""
    from dartenv_tpu_torch.bench.throughput import DR_SPEC
    from dartenv_tpu_torch.engine.world import init_state, make_sim_step
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.parallel.domain_rand import (
        make_randomized_sim_step, randomize_model,
    )

    dtype = torch.float64 if route == "plain64" else torch.float32
    task = make_task(env, device=dev, dtype=dtype)
    model = task.model
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)                       # bench_dr's seed 0
    bmodel = randomize_model(model, DR_SPEC, B, gen)
    state = init_state(model, B, warm_start=task.warm_start)
    rng = np.random.default_rng(0)
    tau = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, model.n)) * 50.0,
                          dtype=dtype, device=dev)
    if route == "nodr":
        plain_step = make_sim_step(model)
        step = lambda s: plain_step(s, tau)[0]
    else:
        dr_step = make_randomized_sim_step(
            model, list(DR_SPEC), force_phasewise=route == "phasewise")
        step = lambda s: dr_step(bmodel, s, tau)[0]
    first = torch.full((B,), -1, dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for k in range(substeps):
        state = step(state)
        bad = ~(torch.isfinite(state.q).all(1)
                & torch.isfinite(state.dq).all(1)
                & (state.dq.abs().amax(1) <= RUNAWAY_DQ))
        first = torch.where(bad & (first < 0), k, first)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return first.cpu(), time.perf_counter() - t0


def main(argv=None):
    from dartenv_tpu_torch.bench.throughput import card_name

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--env", default="walker3d")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--substeps", type=int, default=400)
    p.add_argument("--routes", default="kernel,phasewise,nodr,plain64")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    out = dict(env=args.env, batch=args.batch, substeps=args.substeps,
               runaway_dq=RUNAWAY_DQ, card=card_name(dev), routes={})
    for route in args.routes.split(","):
        first, seconds = run(route, args.env, args.batch, args.substeps,
                             dev)
        envs = torch.nonzero(first >= 0)[:, 0].tolist()
        out["routes"][route] = dict(
            runaway_envs=envs, first_substep=[int(first[i]) for i in envs],
            seconds=seconds)
        print(json.dumps({"route": route, **out["routes"][route]}),
              flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

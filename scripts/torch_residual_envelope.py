#!/usr/bin/env python
"""Post-escalation residual envelope at production batch sizes, on the
PyTorch / CUDA port.

The port's counterpart of scripts/residual_envelope.py, with its flags
(--device in place of --cpu) and its records: the fused substep (the
substep kernel on a float32 CUDA batch) and the escalation (the BPP
kernel's fused mode) as production runs them, through escalate_batch's
with_diag hook (dartenv_tpu_torch/validation/residual.
make_envelope_substep).  Per substep it records percentiles of the whole
batch's post-escalation normalized complementarity residual: every env's
substep-kernel residual, the escalated K replaced by their kept points'.
The first --warmup substeps (every env starts at q_init +- 0.005, so the
first ground impacts land on the same substeps) are reported apart from
the steady state.

On a machine with one GPU:
  python scripts/torch_residual_envelope.py --env walker2d --batch 8192
  python scripts/torch_residual_envelope.py --env humanwalker --batch 8192
On the CPU (the plain versions; a small batch):
  python scripts/torch_residual_envelope.py --device cpu --batch 64 \\
      --substeps 8
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

# env -> N m per unit action (scripts/residual_envelope.py's)
TORQUE = {"walker2d": 100.0, "hopper": 200.0, "humanwalker": 100.0,
          "dog": 60.0, "walker3d": 100.0}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--env", default="walker2d")
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--substeps", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--ref64", type=int, default=-1,
                   help=">=0: override escalate_ref64")
    p.add_argument("--ref", type=int, default=-1,
                   help=">=0: override escalate_ref (compensated)")
    p.add_argument("--warmup", type=int, default=100,
                   help="substeps of synchronized-impact transient "
                        "reported separately")
    p.add_argument("--kmax", type=int, default=0,
                   help=">0: override escalate_kmax")
    p.add_argument("--iters", type=int, default=0,
                   help=">0: override escalate_iters (tier-1 budget)")
    p.add_argument("--iters2", type=int, default=-1,
                   help=">=0: override escalate_iters2 (0: no tier 2)")
    p.add_argument("--pgs_iters", type=int, default=0,
                   help=">0: override pgs_iters")
    p.add_argument("--frac", type=float, default=0.0,
                   help=">0: override escalate_frac")
    return p.parse_args(argv)


def overrides(args):
    """The SolverConfig overrides the flags ask for."""
    kw = {}
    for flag, field, asked in (
            ("ref64", "escalate_ref64", args.ref64 >= 0),
            ("ref", "escalate_ref", args.ref >= 0),
            ("kmax", "escalate_kmax", args.kmax > 0),
            ("iters", "escalate_iters", args.iters > 0),
            ("iters2", "escalate_iters2", args.iters2 >= 0),
            ("pgs_iters", "pgs_iters", args.pgs_iters > 0),
            ("frac", "escalate_frac", args.frac > 0)):
        if asked:
            kw[field] = getattr(args, flag)
    return kw


def agg_window(w):
    """Worst and median over the substeps of a window of records (T, 5)."""
    from dartenv_tpu_torch.validation.residual import ENVELOPE_PCTS

    return dict(
        worst_over_substeps={f"p{v:g}": float(x)
                             for v, x in zip(ENVELOPE_PCTS, w.max(axis=0))},
        median_over_substeps={f"p{v:g}_med": float(x) for v, x in
                              zip(ENVELOPE_PCTS, np.median(w, axis=0))})


def main(argv=None):
    """Runs the protocol; prints and returns one JSON record."""
    from dartenv_tpu_torch.bench.throughput import card_name
    from dartenv_tpu_torch.engine.hopper_substep import escalation_size
    from dartenv_tpu_torch.envs.base import with_solver
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.validation.residual import (
        envelope_percentiles, make_envelope_substep,
    )

    args = parse(argv)
    dev = torch.device(args.device)
    env, B, T = args.env, args.batch, args.substeps
    task = make_task(env, dtype=torch.float32, device=dev)
    model = with_solver(task.model, **overrides(args))
    cfg = model.solver
    assert cfg.escalate_frac > 0.0, "escalation disabled for this task"
    sub = make_envelope_substep(model)
    st = sub.st

    rng = np.random.default_rng(args.seed)
    n = model.n
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    q = model.q_init[None] + f32(rng.uniform(-0.005, 0.005, (B, n)))
    dq = f32(rng.uniform(-0.005, 0.005, (B, n)))
    lam = torch.zeros((B, st.layout.m), dtype=torch.float32, device=dev)
    tau = torch.zeros((B, n), dtype=torch.float32, device=dev)
    torque = TORQUE.get(env, 50.0)

    rows, pre = [], []
    t0 = time.perf_counter()
    for k in range(T):
        if k % task.frame_skip == 0:
            a = rng.uniform(-1.0, 1.0, (B, n - 3))
            tau = torch.zeros((B, n), dtype=torch.float32, device=dev)
            tau[:, 3:] = f32(a) * torque
        q, dq, lam, diag = sub(q, dq, lam, tau)
        rows.append(envelope_percentiles(diag["envelope"]))
        pre.append(envelope_percentiles(diag["res_pre"]))
    rows = torch.stack(rows).double().cpu().numpy()      # (T, 5)
    pre = torch.stack(pre).double().cpu().numpy()
    seconds = time.perf_counter() - t0
    finite = bool(torch.isfinite(q).all() and torch.isfinite(dq).all())

    warm = min(args.warmup, T // 2)
    out = dict(env=env, batch=B, substeps=T, kmax=int(cfg.escalate_kmax),
               frac=float(cfg.escalate_frac),
               ref64=int(st.ref_passes[1]), ref=int(st.ref_passes[0]),
               escalation_k=escalation_size(B, cfg.escalate_frac,
                                            cfg.escalate_kmax),
               pgs_iters=int(cfg.pgs_iters), seed=args.seed,
               device=str(dev), card=card_name(dev),
               transient=agg_window(rows[:warm]),
               steady=agg_window(rows[warm:]),
               before_escalation=dict(transient=agg_window(pre[:warm]),
                                      steady=agg_window(pre[warm:])),
               finite_state=finite, seconds=seconds)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

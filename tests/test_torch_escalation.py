"""PyTorch port, the hybrid exact-escalation stage: the port's
escalate_batch against the JAX package's on the SAME substep outputs
(hopper, B = 16, starved PGS so offenders exist), float64 <= 1e-8;
untouched envs bit-identical."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dartenv_tpu.bench.throughput import make_task as jax_make_task
from dartenv_tpu.engine import pallas_substep as jps
from dartenv_tpu.envs.base import with_solver as jax_with_solver
from dartenv_tpu.lcp.dantzig import make_exact_solver as jax_exact_solver
from dartenv_tpu_torch.engine import hopper_substep as ths
from dartenv_tpu_torch.lcp.dantzig import dantzig_solve
from torch_port_util import N, T, port_model


def test_escalate_batch_matches_jax():
    jm = jax_with_solver(
        jax_make_task("hopper", dtype=jnp.float64).model, None,
        escalate_frac=1.0 / 8, escalate_tol=1e-7, pgs_iters=3)
    tm = port_model(jm)
    jst, tst = jps._SubStatic(jm), ths._SubStatic(tm)
    cfg = jm.solver
    B, n, m = 16, jm.n, jst.layout.m
    rng = np.random.default_rng(5)
    q = np.asarray(jm.q_init)[None] + rng.uniform(-0.06, 0.06, (B, n))
    q[:, 1] -= 0.05                       # bias toward ground contact
    dq = rng.uniform(-1.5, 1.5, (B, n))
    tau = np.concatenate(
        [np.zeros((B, 3)), rng.uniform(-200, 200, (B, n - 3))], axis=1)
    outs = ths.substep_reference(tm, tst, T(q), T(dq), T(tau),
                                 torch.zeros((B, m), dtype=torch.float64))
    jouts = {k: jnp.asarray(N(outs[k])) for k in ("res", "esc")}
    dqp0, lamf0 = outs["dq_plus"], outs["lam_full"]

    jex1 = jax_exact_solver(jst.findex_c, iters=cfg.escalate_iters,
                            polish_iters=3)
    jex2 = jax_exact_solver(jst.findex_c, iters=6, polish_iters=6)
    tex = lambda iters, polish: (
        lambda A, b, lo, hi, mu, act, lam0: dantzig_solve(
            A, b, lo, hi, tst.findex_c, mu, act, iters=iters,
            polish_iters=polish, lam0=lam0))
    # tier 2 on: the warm tier-1 and the cold tier-2 logic in one pass
    jdqp, jlamf = jax.jit(lambda o, d, l: jps.escalate_batch(
        jst, cfg, o, d, l, jex1, jex2,
        jnp.float64))(jouts, jnp.asarray(N(dqp0)),
                      jnp.asarray(N(lamf0)))
    dqp, lamf = ths.escalate_batch(
        tst, tm.solver, outs, dqp0, lamf0, tex(cfg.escalate_iters, 3),
        tex(6, 6))
    np.testing.assert_allclose(N(dqp), np.asarray(jdqp), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(N(lamf), np.asarray(jlamf), rtol=0,
                               atol=1e-8)
    changed = (dqp != dqp0).any(dim=1).numpy()
    jchanged = np.abs(np.asarray(jdqp) - N(dqp0)).max(1) > 0
    np.testing.assert_array_equal(changed, jchanged)
    K = ths.escalation_size(tm.solver, B)
    assert K == 2
    top = np.argsort(-N(outs["res"])[:, 0])[:K]
    assert set(np.nonzero(changed)[0]) <= set(top)
    assert changed.any(), "no env escalated — test setup is vacuous"
    # every other env is untouched bit for bit
    assert torch.equal(dqp[~changed], dqp0[~changed])
    assert torch.equal(lamf[~changed], lamf0[~changed])
    # inputs were not modified in place
    assert torch.equal(dqp0, outs["dq_plus"])


def test_escalate_batch_refuses_unported_tiers():
    import dataclasses

    import pytest

    jm = jax_make_task("hopper", dtype=jnp.float64).model
    tm = port_model(jm)
    cfg = dataclasses.replace(tm.solver, escalate_ref=2)
    with pytest.raises(NotImplementedError, match="escalate_ref"):
        ths.escalate_batch(ths._SubStatic(tm), cfg, {}, None, None, None)

"""PyTorch port, engine/world.make_lcp_capture vs the JAX package's
(float64, CPU): the captured boxed LCPs (A, b, lo, hi, active, mu,
findex), the solver's impulses and dq_star / dq_plus of a batch, on
walker2d and on the walker-and-box world, within 1e-12 (plain PGS: the
JAX side's vmapped trace stays short), warm-started from the previous
impulses as the JAX capture takes them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.bench.throughput import make_task as jax_make_task
from dartenv_tpu.engine.constraints import build_layout as jbl
from dartenv_tpu.engine.world import SimState as JSimState
from dartenv_tpu.engine.world import make_lcp_capture as jax_capture
from dartenv_tpu_torch.engine.world import SimState, make_lcp_capture
from test_torch_compose import _walker_box_jax
from torch_port_util import N, T, port_model, rel_err

B = 4


def _walker_jax():
    jm = jax_make_task("walker2d", dtype=jnp.float64).model
    return jm.replace(solver=dataclasses.replace(jm.solver,
                                                 escalate_frac=0.0))


@pytest.mark.parametrize("world", ["walker2d", "walker_box"])
def test_lcp_capture_matches_jax(world):
    jm = _walker_jax() if world == "walker2d" else _walker_box_jax()
    tm = port_model(jm)
    rng = np.random.default_rng(4)
    q = np.asarray(jm.q_init)[None] + rng.uniform(-0.1, 0.1, (B, jm.n))
    q[:, 1] -= 0.12                        # feet in the ground
    if world == "walker_box":
        q[:, 12] = 0.2
    dq = rng.normal(size=(B, jm.n)) * 0.3
    tau = rng.uniform(-30, 30, (B, jm.n)) * (np.arange(jm.n) >= 3)
    lam = np.abs(rng.normal(size=(B, jbl(jm).m))) * 0.01
    ref = jax.jit(jax.vmap(jax_capture(jm)))(
        JSimState(q=jnp.asarray(q), dq=jnp.asarray(dq), time=jnp.zeros(B),
                  lam=jnp.asarray(lam)), jnp.asarray(tau))
    got = make_lcp_capture(tm)(
        SimState(q=T(q), dq=T(dq), time=T(np.zeros(B)), lam=T(lam)), T(tau))
    assert set(got) == set(ref)
    # the static findex, broadcast over the batch by the JAX vmap
    np.testing.assert_array_equal(got["findex"],
                                  np.asarray(ref["findex"])[0])
    for k in ("A", "b", "lo", "hi", "active", "mu", "lam", "dq_star",
              "dq_plus"):
        assert got[k].shape == ref[k].shape, k
        assert rel_err(got[k], ref[k]) <= 1e-12, (k, rel_err(got[k],
                                                              ref[k]))
    A = N(got["A"])
    np.testing.assert_allclose(A, A.transpose(0, 2, 1), atol=1e-12)
    assert N(got["active"]).sum() > 0

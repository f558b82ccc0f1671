"""PyTorch port, the trace harness (validation/trace.py): `capture_trace`
of one env driven substep by substep against the JAX package's
`capture_trace` on the same numpy inputs, float64 on the CPU, within
1e-10; `compare_traces` gives the JAX comparator's report; the
float32-vs-float64 self-consistency report runs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu.bench.throughput import make_task as jax_make_task
from dartenv_tpu.validation import trace as jtrace
from dartenv_tpu_torch.envs.tasks import make_task
from dartenv_tpu_torch.validation import (
    Trace, capture_trace, compare_traces, self_consistency_report,
)

TOL = 1e-10      # q, dq, lam against JAX, absolute


@pytest.mark.parametrize("name,T,scale", [("hopper", 75, 60.0),
                                          ("cartpole", 60, 20.0)])
def test_capture_trace_matches_jax(name, T, scale):
    """Seeded per-substep torques from the default pose (the hopper lands
    within the run, so its contact rows are live)."""
    jm = jax_make_task(name, dtype=jnp.float64).model
    model = make_task(name, dtype=torch.float64, device="cpu").model
    rng = np.random.default_rng(3)
    tau = rng.uniform(-scale, scale, (T, model.n))
    q0 = np.asarray(jm.q_init)
    dq0 = rng.uniform(-0.2, 0.2, model.n)
    ref = jtrace.capture_trace(jm, q0, dq0, tau)
    got = capture_trace(model, q0, dq0, tau)
    assert got.q.shape == ref.q.shape == (T, model.n)
    assert got.lam.shape == ref.lam.shape
    assert got.meta == ref.meta and got.dtype == ref.dtype == "float64"
    for f in ("q", "dq", "lam"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=0, atol=TOL, err_msg=f)
    rep = compare_traces(got, Trace(q=ref.q, dq=ref.dq, lam=ref.lam))
    assert rep["first_divergence"] == -1
    if name == "hopper":
        assert rep["contact_events_match"] and got.lam.max() > 0.0


def test_compare_traces_reports_like_jax():
    rng = np.random.default_rng(0)
    a = Trace(q=rng.normal(size=(20, 4)), dq=rng.normal(size=(20, 4)),
              lam=np.abs(rng.normal(size=(20, 6))))
    b = Trace(q=a.q.copy(), dq=a.dq.copy(), lam=a.lam.copy())
    b.q[7, 2] += 1e-3
    b.lam[3, 1] = 0.0
    ja = jtrace.Trace(q=a.q, dq=a.dq, lam=a.lam)
    jb = jtrace.Trace(q=b.q, dq=b.dq, lam=b.lam)
    rep = compare_traces(a, b)
    assert rep == jtrace.compare_traces(ja, jb)
    assert rep["first_divergence"] == 7
    assert not rep["contact_events_match"]


def test_self_consistency_report_runs_on_the_cpu():
    rep = self_consistency_report("cartpole.skel", T=40, device="cpu")
    r = rep["f32_vs_f64"]
    assert r["first_divergence"] == -1
    assert r["max_q_err"] < 1e-4

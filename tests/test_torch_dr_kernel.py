"""PyTorch port, the kernels' domain-randomization inputs: the substep
kernel (csrc/substep.cu) and the dynamics kernel (csrc/dynamics.cu) take
per-env model leaves.  Their plain versions against the JAX package's
Pallas-kernel trace with substituted leaves (float64), and the kernels'
per-env C++ built for the host (g++) against those plain versions
(float32), on leaves that differ env by env."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.bench.throughput import make_task as jax_make_task
from dartenv_tpu.engine import pallas_substep as jps
from dartenv_tpu.envs.base import with_solver as jax_with_solver
from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
from dartenv_tpu_torch.engine import hopper_substep as ths
from dartenv_tpu_torch.envs.tasks import make_task
from test_torch_dynamics_kernel import TOL32, _OUTS
from torch_port_util import N, T, dr_leaves, port_dr_model, rel_err

# the fields of the JAX package's tests/test_dr_kernel.py
_JAX_TEST_FIELDS = ("mass", "damping", "geom_friction", "geom_size",
                    "gravity")
_EXACT = ("con_active", "overflow", "act", "sel_slots", "lo", "hi", "mu")


def _states(jm, B, seed):
    """Contact-biased states (numpy): q near q_init with the feet pressed
    in, dq, torques on the actuated dofs, warm-start impulses."""
    rng = np.random.default_rng(seed)
    n = jm.n
    q = np.asarray(jm.q_init, np.float64)[None] + rng.uniform(-0.05, 0.05,
                                                              (B, n))
    q[:, 1] -= rng.uniform(0.0, 0.06, B)
    dq = rng.uniform(-1.0, 1.0, (B, n))
    tau = np.concatenate([np.zeros((B, 3)),
                          rng.uniform(-100, 100, (B, n - 3))], 1)
    return q, dq, tau


@pytest.mark.parametrize("env", ["walker2d", "hopper"])
def test_plain_dr_substep_matches_pallas_trace_f64(env):
    """(a) substep_reference on the model with per-env (mass, damping,
    geom_friction, geom_size, gravity) against the JAX kernel's own
    per-env trace, _trace_substep(_apply_dr_sub(...)), with (B,) blocks as
    its scalars (as the JAX suite runs it on the CPU): float64, B = 4,
    every output within 1e-12 of max(1, |JAX|), discrete ones exactly."""
    jm = jax_with_solver(jax_make_task(env, dtype=jnp.float64).model, None,
                         escalate_frac=0.0)
    B = 4
    leaves = dr_leaves(jm, _JAX_TEST_FIELDS, B, seed=11)
    _, base, bmodel = port_dr_model(jm, leaves)
    jst, tst = jps._SubStatic(jm), ths._SubStatic(base)
    q, dq, tau = _states(jm, B, 12)
    lam = np.zeros((B, jst.layout.m))
    cols = lambda x: [jnp.asarray(x[:, i]) for i in range(x.shape[1])]
    dr = {f: cols(v.reshape(B, -1)) for f, v in leaves.items()}
    outs = jps._trace_substep(jps._apply_dr_sub(jst, dr), cols(q), cols(dq),
                              cols(tau), cols(lam))
    ref = {k: np.stack([np.broadcast_to(np.asarray(v, np.float64), (B,))
                        for v in vals], axis=1) for k, vals in outs.items()}
    got = ths.substep_reference(bmodel, tst, T(q), T(dq), T(tau), T(lam))
    for f in ("dq_plus", "lam_full", "res", "M", "Jc", "b", "mu", "act",
              "con_depth", "con_pos", "con_active", "esc"):
        err = rel_err(got[f], ref[f])
        assert err <= (0.0 if f in ("act", "con_active") else 1e-12), (f,
                                                                     err)
    assert N(ref["con_active"]).sum() > 0 and np.abs(ref["lam_full"]).max()
    # the per-env values matter: the trace without them differs
    base_out = jps._trace_substep(jst, cols(q), cols(dq), cols(tau),
                                  cols(lam))
    d0 = np.stack([np.broadcast_to(np.asarray(v), (B,))
                   for v in base_out["dq_plus"]], axis=1)
    assert np.abs(d0 - ref["dq_plus"]).max() > 1e-8


@pytest.mark.parametrize("env", ["walker2d", "hopper"])
def test_substep_host_build_with_dr_inputs_matches_plain(env):
    """(b) The substep kernel's per-env code built with all twelve
    DR_FIELDS_SUB leaves as inputs, on the host, against the DR plain
    version in float32 at the bounds of the existing host-build test
    (copied blocks to the bit, computed ones within 1e-4 of
    max(1, |plain|)); B = 19, not a multiple of the envs per block, each
    env's leaves its own (up to 30 % apart, so a mix-up of envs fails at
    O(0.1)).  Fed the base model's values, the DR build reproduces the
    build without DR inputs to the bit."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    jm = jax_make_task(env, dtype=jnp.float64).model
    B = 19
    fields = ths.DR_FIELDS_SUB
    leaves = dr_leaves(jm, fields, B, seed=13)
    _, base, bmodel = port_dr_model(jm, leaves, dtype=torch.float32)
    kern = ths.get_substep_kernel(base, dr_fields=fields)
    assert kern.dr_width == {"walker2d": 158, "hopper": 95}[env]
    assert B % kern.shape[0]
    st = kern.st
    q, dq, tau = (T(x, torch.float32) for x in _states(jm, B, 14))
    lam = T(np.random.default_rng(15).uniform(0.0, 0.3, (B, st.layout.m)),
            torch.float32)
    vals = [getattr(bmodel, f) for f in fields]
    got = ths.output_blocks(st, kern.run_host(q, dq, tau, lam, *vals))
    ref = ths.output_blocks(st, ths.substep_reference(bmodel, st, q, dq,
                                                      tau, lam))
    for f in got:
        if f in _EXACT:
            assert torch.equal(got[f], ref[f]), f
        else:
            assert rel_err(got[f], ref[f]) <= 1e-4, (f, rel_err(got[f],
                                                                 ref[f]))
    assert float(ref["con_active"].sum()) > B / 4
    # the base values through the DR build == the build without DR inputs
    base_vals = [getattr(base, f)[None].expand((B,) + getattr(base, f).shape)
                 for f in fields]
    plain_build = ths.get_substep_kernel(base).run_host(q, dq, tau, lam)
    dr_build = kern.run_host(q, dq, tau, lam, *base_vals)
    for f in ths._OUT_FIELDS:
        assert torch.equal(dr_build[f], plain_build[f]), f


@pytest.mark.parametrize("env", ["cartpole", "walker2d"])
def test_dynamics_host_build_with_dr_inputs_matches_plain(env):
    """(c) The dynamics kernel's per-env code built with the seven
    DR_FIELDS_DYN leaves as inputs, on the host, against the DR plain
    version at the kernel's bounds (TOL32), on cartpole and walker2d
    states, B = 19 and per-env leaves; fed the base values it reproduces
    the build without DR inputs to the bit."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    jm = jax_make_task(env, dtype=jnp.float64).model
    B = 19
    fields = hd.DR_FIELDS_DYN
    leaves = dr_leaves(jm, fields, B, seed=16)
    _, base, bmodel = port_dr_model(jm, leaves, dtype=torch.float32)
    kern = hd.get_dynamics_kernel(base, fields)
    rng = np.random.default_rng(17)
    n = base.n
    q = T(N(base.q_init)[None] + rng.uniform(-0.3, 0.3, (B, n)),
          torch.float32)
    dq = T(rng.uniform(-2.0, 2.0, (B, n)), torch.float32)
    tau = T(rng.uniform(-50.0, 50.0, (B, n)), torch.float32)
    vals = [getattr(bmodel, f) for f in fields]
    got = kern.run_host(q, dq, tau, *vals)
    ref = hd.dynamics_reference(bmodel, q, dq, tau)
    for k, a, r in zip(_OUTS, got, ref):
        assert torch.isfinite(a).all(), k
        assert rel_err(a, r) <= TOL32[k], (k, rel_err(a, r))
    # an env's values belong to that env: with the envs' leaves rolled by
    # one the outputs are far off
    rolled = kern.run_host(q, dq, tau, *[v.roll(1, 0) for v in vals])
    assert rel_err(rolled[0], ref[0]) > 1e-2
    base_vals = [getattr(base, f)[None].expand((B,) + getattr(base, f).shape)
                 for f in fields]
    plain_build = hd.get_dynamics_kernel(base).run_host(q, dq, tau)
    for a, b in zip(kern.run_host(q, dq, tau, *base_vals), plain_build):
        assert torch.equal(a, b)

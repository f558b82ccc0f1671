"""PyTorch port, the debug mode (engine/debug.py): each check of the
checked substep fires with the JAX module's message and the index of the
first failing env, `err.get()` is None on a clean batch, `err.throw()`
raises, and `checked_rollout` stops at the first corrupt substep.  The
scenarios are tests/test_debug_mode.py's, on a batch of three hopper envs
on the CPU in float64; the JAX checkify'd step gives the same message on
the same input."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu.engine.debug import make_checked_sim_step as jax_checked
from dartenv_tpu.engine.world import init_state as jax_init_state
from dartenv_tpu.envs.hopper import make_hopper_task as jax_hopper
from dartenv_tpu_torch.engine import debug
from dartenv_tpu_torch.engine.debug import (
    CheckFailed, checked_rollout, make_checked_sim_step,
)
from dartenv_tpu_torch.engine.world import init_state
from dartenv_tpu_torch.envs.hopper import make_hopper_task

B = 3


@pytest.fixture(scope="module")
def model():
    return make_hopper_task(dtype=torch.float64, device="cpu").model


def _jax_message(state_fn, tau_fn, **kw):
    """err.get() of the JAX checked step on the default state and zero
    tau, edited by state_fn / tau_fn (one env, unbatched)."""
    jm = jax_hopper(dtype=jnp.float64).model
    st = state_fn(jax_init_state(jm))
    err, _ = jax.jit(jax_checked(jm, **kw))(st, tau_fn(jnp.zeros(jm.n)))
    return err.get()


def test_clean_batch_has_no_error(model):
    checked = make_checked_sim_step(model)
    state = init_state(model, B)
    tau = torch.zeros(B, model.n, dtype=torch.float64)
    for _ in range(10):
        err, (state, contacts) = checked(state, tau)
        assert err.get() is None
        err.throw()
    assert torch.isfinite(state.q).all()
    assert [m for m, _ in err.checks] == [
        debug.MSG_Q_IN, debug.MSG_DQ_IN, debug.MSG_TAU_IN, debug.MSG_Q_OUT,
        debug.MSG_DQ_OUT, debug.MSG_LAM, debug.MSG_LAM_MAX,
        debug.MSG_OVERFLOW]


@pytest.mark.parametrize("field,env,msg", [
    ("q", 1, debug.MSG_Q_IN), ("dq", 2, debug.MSG_DQ_IN),
    ("tau", 0, debug.MSG_TAU_IN)])
def test_non_finite_input_is_located(model, field, env, msg):
    checked = make_checked_sim_step(model)
    state = init_state(model, B)
    tau = torch.zeros(B, model.n, dtype=torch.float64)
    if field == "tau":
        tau[env] = float("inf")
    else:
        x = getattr(state, field).clone()
        x[env, 2] = float("nan")
        state = dataclasses.replace(state, **{field: x})
    err, _ = checked(state, tau)
    assert err.get() == f"{msg} (env {env})"
    with pytest.raises(CheckFailed, match=f"non-finite {field}"):
        err.throw()
    if field == "tau":
        ref = _jax_message(lambda s: s, lambda t: t + jnp.inf)
    else:
        ref = _jax_message(lambda s: dataclasses.replace(s, **{
            field: getattr(s, field).at[2].set(jnp.nan)}), lambda t: t)
    assert msg in ref


def test_non_finite_output_is_located(model):
    """Finite velocities of 1e200 in env 2 overflow its bias forces
    (quadratic in dq): the output checks flag env 2 only, and q's message
    comes first."""
    checked = make_checked_sim_step(model)
    state = init_state(model, B)
    dq = state.dq.clone()
    dq[2, 2:] = 1e200
    state = dataclasses.replace(state, dq=dq)
    tau = torch.zeros(B, model.n, dtype=torch.float64)
    err, _ = checked(state, tau)
    assert err.get() == f"{debug.MSG_Q_OUT} (env 2)"
    flagged = {m: f.tolist() for m, f in err.checks}
    assert flagged[debug.MSG_DQ_OUT] == [False, False, True]
    assert flagged[debug.MSG_TAU_IN] == [False] * B


def test_impulse_blow_up_is_located(model):
    """Env 1 set into the ground: its contact impulses exceed a bound of
    1e-9 and the check names env 1 (the others are airborne)."""
    checked = make_checked_sim_step(model, lam_max=1e-9)
    state = init_state(model, B)
    q = state.q.clone()
    q[1, 1] -= 0.05
    state = dataclasses.replace(state, q=q)
    err, (new_state, _) = checked(state,
                                  torch.zeros(B, model.n,
                                              dtype=torch.float64))
    assert err.get() == f"{debug.MSG_LAM_MAX} (env 1)"
    assert float(new_state.lam[1].abs().max()) > 1e-9


def test_contact_overflow_is_flagged():
    """The hopper's LCP capped at one contact slot and landed (as in
    tests/test_debug_mode.py): the overflow check fires for the envs that
    land on two points, with the JAX module's message."""
    model = make_hopper_task(dtype=torch.float64, device="cpu",
                             contact_cap=1).model
    checked = make_checked_sim_step(model)
    state = init_state(model, B)
    q = state.q.clone()
    q[:, 1] -= 0.04            # start just above the ground
    state = dataclasses.replace(state, q=q)
    tau = torch.zeros(B, model.n, dtype=torch.float64)
    msg = None
    for _ in range(150):
        err, (state, contacts) = checked(state, tau)
        msg = err.get()
        if msg is not None:
            break
    assert msg is not None, "hopper landing never overflowed a cap of 1"
    assert msg.startswith(debug.MSG_OVERFLOW + " (env ")
    env = int(msg.split("(env ")[1].rstrip(")"))
    assert float(contacts.overflow[env]) > 0
    assert "contact_cap overflow" in debug.MSG_OVERFLOW


def test_checked_rollout_stops_at_the_corrupt_substep(model):
    state = init_state(model, B)
    taus = torch.zeros(6, B, model.n, dtype=torch.float64)
    out = checked_rollout(model, state, taus)
    assert torch.isfinite(out.q).all()
    taus[4, 1, 0] = float("nan")
    with pytest.raises(CheckFailed, match=r"non-finite tau \(env 1\)"):
        checked_rollout(model, state, taus)

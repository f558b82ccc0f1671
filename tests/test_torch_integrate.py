"""PyTorch port, the position-update kernel (csrc/integrate.cu,
csrc/integrate_body.h) and the one dispatch every substep goes through
(dynamics/hopper_integrate.integrate).

* the kernel's per-env arithmetic, built with the host compiler
  (csrc/integrate_host.cpp), against the plain version
  dynamics/batched.integrate_positions in float32: on humanwalker, walker3d
  and dog (FREE roots), a ModelBuilder chain with a FREE root and two BALL
  joints apart in q, and the composed multiskel world (a PLANAR walker and
  a FREE box); at B = 1, 7 and 64; on random states, on states whose w and
  dw * dt take the Taylor branches, on states with |w| within 1e-3 of pi
  (where the product quaternion's w < 0 flip is taken), and with dq = 0.
  The linear columns equal the plain version's to the bit; the rotation and
  translation columns of each BALL / FREE joint lie within 1e-6 of it as
  max |x - x_ref| / (1 + |x_ref|) (libm's sinf / cosf / atan2f against
  PyTorch's vectorized ones: a few float32 ulps), and the Taylor-branch
  rotations within 1e-6 of |x_ref| itself;
* the fused phase, the phase-wise step and the envelope hook each call
  hopper_integrate.integrate once a substep; a walker2d substep (no BALL
  or FREE joint) reaches the plain version with its bits, and PLAIN_CALLS
  counts it; building a sim step or a fused phase starts the kernel's
  build (hopper_integrate.prepare), which a CPU model skips;
* on a card (skipped without one): the kernel against the plain version on
  the card, one humanwalker substep adding exactly 1 to INTEGRATE_LAUNCHES,
  and the envelope hook's next q equal to the fused phase's, as the
  benchmark's `hook_vs_path_substeps` check holds them.

This file imports no JAX, so it also runs on a machine without it:
`python -m pytest --noconftest tests/test_torch_integrate.py`.
"""
import functools
import math
import shutil

import numpy as np
import pytest
import torch

from dartenv_tpu_torch.dynamics import batched
from dartenv_tpu_torch.dynamics import hopper_integrate as hi
from dartenv_tpu_torch.math import spatial as sp
from dartenv_tpu_torch.model import skel_model as sm

MODELS = ("humanwalker", "walker3d", "dog", "ball_chain", "multiskel")
STATES = ("random", "tiny", "near_pi", "dq_zero")
TOL = 1e-6


@functools.lru_cache(maxsize=None)
def _model(name, device="cpu"):
    from dartenv_tpu_torch.bench import scenes
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.model.builder import ModelBuilder, box_inertia

    if name == "multiskel":
        return scenes.walker_box_world(device, dtype=torch.float32)
    if name == "ball_chain":
        ine = lambda m: box_inertia(m, (0.1, 0.06, 0.04))
        b = ModelBuilder(dt=0.002)
        b.add_body("root", None, sm.FREE, mass=2.0, inertia=ine(2.0))
        b.add_body("ball", "root", sm.BALL, mass=0.5, inertia=ine(0.5),
                   pj_pos=(-0.1, 0.1, 0))
        b.add_body("hinge", "ball", sm.REVOLUTE, axes=[(0, 0, 1)],
                   mass=0.4, inertia=ine(0.4), pj_pos=(0, -0.2, 0))
        b.add_body("ball2", "hinge", sm.BALL, mass=0.3, inertia=ine(0.3),
                   pj_pos=(0, -0.1, 0))
        return b.finalize(dtype=torch.float32, device=device)
    return make_task(name, device=device).model


def _rot_cols(model):
    """(rotation columns, translation columns) of the BALL / FREE joints."""
    rot, tra = [], []
    for s, free in hi.joint_table(model):
        rot += [s, s + 1, s + 2]
        if free:
            tra += [s + 3, s + 4, s + 5]
    return np.array(rot, np.int64), np.array(tra, np.int64)


def _states(model, B, kind, seed):
    """(q, dq) float32 (B, n) of one kind of state."""
    rng = np.random.default_rng(seed)
    n = model.n
    q = model.q_init.cpu().numpy()[None] + rng.uniform(-1.0, 1.0, (B, n))
    dq = rng.uniform(-20.0, 20.0, (B, n))
    rot = _rot_cols(model)[0].reshape(-1, 3)
    for cols in rot:
        u = rng.normal(size=(B, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        if kind == "random":
            q[:, cols] = u * rng.uniform(0.0, 3.0, (B, 1))
        elif kind == "tiny":            # theta2 and vn2 below 1e-12
            q[:, cols] = u * rng.uniform(0.0, 5e-7, (B, 1))
            dq[:, cols] = rng.uniform(-1e-4, 1e-4, (B, 3))
        elif kind == "near_pi":         # |w| within 1e-3 of pi
            q[:, cols] = u * (math.pi - rng.uniform(0.0, 1e-3, (B, 1)))
            dq[:, cols] = u * rng.uniform(-1.0, 1.0, (B, 1))
    if kind == "dq_zero":
        dq[:] = 0.0
    f = lambda x: torch.as_tensor(x, dtype=torch.float32)
    return f(q), f(dq)


def _compare(model, got, ref):
    """Linear columns to the bit; BALL / FREE columns within TOL."""
    rot, tra = _rot_cols(model)
    lin = np.setdiff1d(np.arange(model.n), np.concatenate([rot, tra]))
    assert torch.equal(got[:, lin], ref[:, lin])
    for cols in (rot, tra):
        if len(cols):
            err = ((got[:, cols] - ref[:, cols]).abs()
                   / (1.0 + ref[:, cols].abs())).max()
            assert float(err) <= TOL, float(err)
    assert torch.isfinite(got).all()


def _flips(model, q, dq, dt):
    """Envs whose product quaternion has w < 0 (the short-geodesic flip)."""
    hits = 0
    for s, _ in hi.joint_table(model):
        w, dw = q[:, s:s + 3], dq[:, s:s + 3] * dt
        quat = sp.quat_mul(sp.so3_exp_quat(w), sp.so3_exp_quat(dw))
        hits += int((quat[:, 0] < 0).sum())
    return hits


@pytest.mark.parametrize("kind", STATES)
@pytest.mark.parametrize("B", (1, 7, 64))
@pytest.mark.parametrize("name", MODELS)
def test_host_build_matches_plain(name, B, kind):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    model = _model(name)
    assert hi.has_rotations(model)
    q, dq = _states(model, B, kind, seed=MODELS.index(name) * 10 + B)
    dt = model.dt
    got = hi.integrate_host(model, q, dq, dt)
    ref = batched.integrate_positions(model, q, dq, dt)
    _compare(model, got, ref)
    if kind == "tiny":          # Taylor-branch rotations, to their scale
        rot = _rot_cols(model)[0]
        assert ((got[:, rot] - ref[:, rot]).abs()
                <= TOL * ref[:, rot].abs()).all()
    if kind == "near_pi" and B == 64:
        assert _flips(model, q, dq, dt) > 0     # the flip is exercised
    if kind == "dq_zero":                   # only the rotations move
        keep = np.setdiff1d(np.arange(model.n), _rot_cols(model)[0])
        assert torch.equal(got[:, keep], q[:, keep])


def _humanwalker_inputs(device, B=4, seed=3):
    """humanwalker's model and (q, dq, lam, tau) of B envs near its rest
    pose on `device`, float32."""
    from dartenv_tpu_torch.engine.world import init_state

    model = _model("humanwalker", device)
    st = init_state(model, B)
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *s: (torch.rand(*s, generator=g) - 0.5).to(device)
    q = st.q + 0.05 * rnd(B, model.n)
    dq = st.dq + 0.5 * rnd(B, model.n)
    tau = 20.0 * rnd(B, model.n)
    return model, q, dq, st.lam, tau


def test_every_substep_goes_through_one_dispatch(monkeypatch):
    from dartenv_tpu_torch.engine.hopper_substep import make_substep_phase
    from dartenv_tpu_torch.engine.world import (
        SimState, init_state, make_sim_step,
    )
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.validation.residual import make_envelope_substep

    calls = []
    real = hi.integrate
    monkeypatch.setattr(hi, "integrate", lambda *a: calls.append(1)
                        or real(*a))
    model, q, dq, lam, tau = _humanwalker_inputs("cpu")
    state = SimState(q=q, dq=dq, time=q.new_zeros(q.shape[0]), lam=lam)

    make_substep_phase(model)(q, dq, lam, tau)
    assert len(calls) == 1                          # the fused phase
    f_ext = q.new_zeros((q.shape[0], model.nb, 6))
    make_sim_step(model)(state, tau, f_ext_world=f_ext)
    assert len(calls) == 2                          # the phase-wise step
    make_envelope_substep(model)(q, dq, lam, tau)
    assert len(calls) == 3                          # the envelope hook

    w2d = make_task("walker2d", device="cpu").model
    assert not hi.has_rotations(w2d)
    st = init_state(w2d, 3)
    st = SimState(q=st.q + 0.01, dq=st.dq + 0.1, time=st.time, lam=st.lam)
    plain = hi.PLAIN_CALLS
    sub = make_substep_phase(w2d)
    q_new, dq_plus, _, _ = sub(st.q, st.dq, st.lam,
                               torch.zeros_like(st.q))
    assert len(calls) == 4 and hi.PLAIN_CALLS == plain + 1
    assert torch.equal(q_new, batched.integrate_positions(
        w2d, st.q, dq_plus, w2d.dt))


def test_build_starts_where_a_step_is_built(monkeypatch):
    from dartenv_tpu_torch.engine.hopper_substep import make_substep_phase
    from dartenv_tpu_torch.engine.world import make_sim_step

    started, prepared = [], []
    monkeypatch.setattr(hi, "start_build", lambda: started.append(1))
    model = _model("humanwalker")
    hi.prepare(model)
    assert started == []            # a CPU model runs the plain version
    real = hi.prepare
    monkeypatch.setattr(hi, "prepare",
                        lambda m: prepared.append(m) or real(m))
    make_sim_step(model)            # itself and its fused phase
    make_substep_phase(model)
    assert len(prepared) == 3 and all(m is model for m in prepared)
    assert started == []


def test_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dartenv_tpu_torch.engine.world import SimState, make_sim_step
    from dartenv_tpu_torch.validation.residual import make_envelope_substep

    for name in MODELS:
        model = _model(name, "cuda")
        for kind in STATES:
            q, dq = (x.cuda() for x in _states(model, 1024, kind, seed=7))
            launches = hi.INTEGRATE_LAUNCHES
            got = hi.integrate(model, q, dq, model.dt)
            assert hi.INTEGRATE_LAUNCHES == launches + 1
            ref = batched.integrate_positions(model, q, dq, model.dt)
            _compare(model, got.cpu(), ref.cpu())

    model, q, dq, lam, tau = _humanwalker_inputs("cuda", B=64)
    step, hook = make_sim_step(model), make_envelope_substep(model)
    state = SimState(q=q, dq=dq, time=q.new_zeros(64), lam=lam)
    launches = hi.INTEGRATE_LAUNCHES
    st2, _ = step(state, tau)
    assert hi.INTEGRATE_LAUNCHES == launches + 1
    q2, dq2, lam2, _ = hook(q, dq, lam, tau)
    assert torch.equal(q2, st2.q) and torch.equal(dq2, st2.dq)
    assert torch.equal(lam2, st2.lam)

    from dartenv_tpu_torch.envs.tasks import make_task

    w2d = make_task("walker2d", device="cuda").model
    q = w2d.q_init.expand(64, -1) + 0.01
    launches, plain = hi.INTEGRATE_LAUNCHES, hi.PLAIN_CALLS
    got = hi.integrate(w2d, q, q + 1.0, w2d.dt)
    assert (hi.INTEGRATE_LAUNCHES, hi.PLAIN_CALLS) == (launches, plain + 1)
    assert torch.equal(got, batched.integrate_positions(w2d, q, q + 1.0,
                                                        w2d.dt))

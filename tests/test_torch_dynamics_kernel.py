"""PyTorch port, the dynamics kernel (dynamics/hopper_dynamics.py):

* its plain version against the JAX package's dynamics phase
  (make_dynamics_phase under jax.vmap) in float64, to 1e-10;
* its plain version against the Pallas kernel in interpret mode in
  float32, at the JAX package's own kernel bounds (5e-6 for M, phi, R_w,
  p_w and 2e-4 for dq_star, relative to max(1, |ref|_inf));
* the kernel's per-env C++ (csrc/dynamics_body.h, built with g++) against
  the plain version for all ten joint types, at the same bounds;
* the dispatch: plain version on a CPU batch, counted; the kernel wrapper
  refuses CPU tensors.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.bench.throughput import make_task as jax_make_task
from dartenv_tpu.dynamics.pallas_dynamics import (
    _Static, dynamics_pallas,
    make_dynamics_phase as jax_make_dynamics_phase,
)
from dartenv_tpu.model import skel_model as jsm
from dartenv_tpu.model.builder import ModelBuilder as JBuilder
from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
from dartenv_tpu_torch.envs.tasks import make_task
from dartenv_tpu_torch.model import skel_model as tsm
from dartenv_tpu_torch.model.builder import ModelBuilder as TBuilder
from torch_port_util import N, T, port_model, rel_err

_OUTS = ("dq_star", "M", "phi", "R_w", "p_w")
TOL32 = {"dq_star": 2e-4, "M": 5e-6, "phi": 5e-6, "R_w": 5e-6, "p_w": 5e-6}


def _chains(Bld, sm, rpy_to_mat, box_inertia, finalize):
    """The six joint types the substep kernel lacks, in two chains of at
    most 12 dofs (FREE, UNIVERSAL, EULER, SCREW; TRANSLATIONAL, BALL,
    SCREW), and a WELD chain (PRISMATIC, WELD, REVOLUTE)."""
    ine = lambda m: box_inertia(m, (0.1, 0.06, 0.04))
    a = Bld(dt=0.002)
    a.add_body("root", None, sm.FREE, mass=2.0, inertia=ine(2.0),
               com=(0.01, 0.02, 0.0))
    a.add_body("uni", "root", sm.UNIVERSAL, axes=[(1, 0, 0), (0, 0.6, 0.8)],
               mass=0.8, inertia=ine(0.8), pj_pos=(0.1, 0, 0),
               pj_rot=rpy_to_mat(0.2, -0.1, 0.3), cj_pos=(0, 0.1, 0),
               damping=0.02)
    a.add_body("eul", "uni", sm.EULER, mass=0.6, inertia=ine(0.6),
               pj_pos=(0, -0.2, 0), cj_rot=rpy_to_mat(0.1, 0.2, -0.1),
               com=(0, 0.03, 0.01))
    a.add_body("scr", "eul", sm.SCREW, axes=[(0, 0, 1)], pitch=0.3,
               mass=0.3, inertia=ine(0.3), pj_pos=(0, -0.1, 0), spring=2.0,
               damping=0.5)
    b = Bld(dt=0.002)
    b.add_body("base", None, sm.TRANSLATIONAL, mass=2.0,
               inertia=box_inertia(2.0, (0.1, 0.1, 0.1)), spring=3.0,
               rest=(0.0, 0.1, 0.0))
    b.add_body("mid", "base", sm.BALL, mass=1.0,
               inertia=box_inertia(1.0, (0.05, 0.2, 0.05)),
               pj_pos=(0.0, 0.3, 0.0), cj_pos=(0.0, -0.2, 0.0))
    b.add_body("tip", "mid", sm.SCREW, mass=0.5,
               inertia=box_inertia(0.5, (0.05, 0.05, 0.05)),
               axes=[(0.0, 0.0, 1.0)], pitch=0.1, pj_pos=(0.0, 0.25, 0.0),
               damping=0.5, spring=2.0)
    w = Bld(dt=0.002)
    w.add_body("slider", None, sm.PRISMATIC, axes=[(0.6, 0.8, 0)],
               mass=1.2, inertia=ine(1.2), damping=0.3, spring=2.0,
               rest=0.1)
    w.add_body("plate", "slider", sm.WELD, mass=0.4, pj_pos=(0, 0.1, 0),
               inertia=ine(0.4), com=(0.01, 0, 0))
    w.add_body("arm", "plate", sm.REVOLUTE, axes=[(0, 0, 2.0)], mass=0.7,
               inertia=ine(0.7), cj_pos=(0, 0.2, 0), com=(0, -0.02, 0.01))
    return {"chain_a": finalize(a), "chain_b": finalize(b),
            "chain_weld": finalize(w)}


def _torch_models(dtype=torch.float32):
    from dartenv_tpu_torch.model.builder import box_inertia, rpy_to_mat

    models = _chains(TBuilder, tsm, rpy_to_mat, box_inertia,
                     lambda b: b.finalize(dtype=dtype, device="cpu"))
    for name in ("cartpole", "doublependulum", "walker2d"):
        models[name] = make_task(name, dtype=dtype, device="cpu").model
    return models


def _jax_model(name, dtype):
    if name.startswith("chain"):
        from dartenv_tpu.model.builder import box_inertia, rpy_to_mat

        return _chains(JBuilder, jsm, rpy_to_mat, box_inertia,
                       lambda b: b.finalize(dtype=dtype))[name]
    return jax_make_task(name, dtype=dtype).model


def _inputs(model, B, seed):
    """The draw of tests/test_pallas_dynamics.py::_rand_batch, as numpy."""
    rng = np.random.default_rng(seed)
    q = N(model.q_init)[None] + rng.uniform(-0.3, 0.3, (B, model.n))
    return (q, rng.uniform(-2.0, 2.0, (B, model.n)),
            rng.uniform(-50.0, 50.0, (B, model.n)))


@pytest.mark.parametrize("name", ["cartpole", "doublependulum", "chain_a",
                                  "chain_b"])
def test_reference_matches_jax_phase_f64(name):
    jm = _jax_model(name, jnp.float64)
    tm = port_model(jm)
    q, dq, tau = _inputs(tm, 5, seed=3)
    phase = jax_make_dynamics_phase(jm, float(jm.dt))
    ref = jax.jit(jax.vmap(phase))(jnp.asarray(q), jnp.asarray(dq),
                                   jnp.asarray(tau))
    got = hd.dynamics_reference(tm, T(q), T(dq), T(tau))
    for k, a, r in zip(_OUTS, got, ref):
        assert N(a).shape == np.asarray(r).shape, k
        assert rel_err(a, r) <= 1e-10, (k, rel_err(a, r))


def test_reference_matches_pallas_interpret_f32():
    jm = _jax_model("cartpole", jnp.float32)
    tm = port_model(jm, dtype=torch.float32)
    q, dq, tau = _inputs(tm, 16, seed=4)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    st = _Static(jm)            # host-side digest, built outside the trace
    run = jax.jit(lambda a, b, c: dynamics_pallas(jm, a, b, c, st=st,
                                                  interpret=True))
    ref = run(f32(q), f32(dq), f32(tau))
    t32 = lambda x: T(x, torch.float32)
    got = hd.dynamics_reference(tm, t32(q), t32(dq), t32(tau))
    for k, a, r in zip(_OUTS, got, ref):
        assert a.dtype == torch.float32
        assert rel_err(a, r) <= TOL32[k], (k, rel_err(a, r))


def test_host_build_of_kernel_arithmetic_matches_plain():
    """csrc/dynamics_body.h is the per-env code of the CUDA kernel; built
    with g++ it runs here on float32 CPU tensors, against the plain
    version at the bounds the kernel is held to on the card, for models
    that together hold all ten joint types."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    models = _torch_models()
    types = set()
    for i, (name, model) in enumerate(models.items()):
        types |= set(model.joint_type)
        q, dq, tau = (T(x, torch.float32) for x in _inputs(model, 48, i))
        q[0, : min(3, model.n)] = 0.0    # exp map at the identity
        kern = hd.get_dynamics_kernel(model)
        got = kern.run_host(q, dq, tau)
        ref = hd.dynamics_reference(model, q, dq, tau)
        for k, a, r in zip(_OUTS, got, ref):
            assert a.shape == r.shape, (name, k)
            assert torch.isfinite(a).all(), (name, k)
            assert rel_err(a, r) <= TOL32[k], (name, k, rel_err(a, r))
    assert types == set(range(10))


def test_phase_dispatch_and_header():
    """A CPU batch runs the plain version (counted); the wrapper refuses
    CPU tensors; the generated header carries the digest's sizes and the
    mask of joint types present."""
    model = make_task("cartpole", device="cpu").model
    phase = hd.make_dynamics_phase(model)
    before = hd.PLAIN_CALLS, hd.DYNAMICS_LAUNCHES
    q = model.q_init.expand(3, -1).clone()
    out = phase(q, torch.zeros_like(q), torch.ones_like(q))
    assert (hd.PLAIN_CALLS, hd.DYNAMICS_LAUNCHES) == (before[0] + 1,
                                                      before[1])
    assert [tuple(x.shape) for x in out] == [(3, 2), (3, 2, 2), (3, 2, 6),
                                             (3, 2, 3, 3), (3, 2, 3)]
    head = hd.dynamics_header(model)
    assert "#define DY_N 2\n" in head and "#define DY_NB 2\n" in head
    # PRISMATIC (2) and REVOLUTE (1)
    assert f"#define DY_JMASK {(1 << 1) | (1 << 2)}\n" in head
    kern = hd.get_dynamics_kernel(model)
    with pytest.raises(ValueError, match="CUDA"):
        kern(q, q, q)

"""PyTorch port, the per-body algorithms of one env against the JAX
package's on the CPU in float64: joint_kinematics for all ten joint
types; fk, aba (with f_ext_world), crba, rnea_bias and
forward_dynamics_crb on the chains of tests/test_dynamics.py and on every
.skel asset, at 1e-12 (relative to max(1, |ref|)); and CRBA against ABA
as the JAX package's own test holds them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu.dynamics import algorithms as JA
from dartenv_tpu.dynamics.joints import joint_kinematics as jax_jk
from dartenv_tpu.model.skel_model import JOINT_NDOF
from dartenv_tpu.model.skel_parser import asset_path, parse_skel
from dartenv_tpu_torch.dynamics import algorithms as PA
from dartenv_tpu_torch.dynamics.joints import joint_kinematics
from test_dynamics import MODELS
from torch_port_util import port_model

TOL = 1e-12
ASSETS = ("cartpole.skel", "doublependulum.skel", "hopper_capsule.skel",
          "walker2d.skel", "reacher.skel", "reacher2d.skel", "walker3d.skel",
          "kima_humanwalker.skel", "dog.skel", "snake_7link.skel")
FIELDS = ("R_w", "p_w", "E", "r", "S", "Sdot", "v")


def _close(got, ref, what=""):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("jtype", range(10))
def test_joint_kinematics(jtype):
    rng = np.random.default_rng(jtype)
    nd = JOINT_NDOF[jtype]
    ax = rng.standard_normal((3, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    fn = jax.jit(lambda a, q, d: jax_jk(jtype, a, q, d))
    for _ in range(3):
        q, dq = rng.uniform(-2, 2, nd), rng.uniform(-3, 3, nd)
        ref = fn(jnp.asarray(ax), jnp.asarray(q), jnp.asarray(dq))
        got = joint_kinematics(jtype, torch.tensor(ax), torch.tensor(q),
                               torch.tensor(dq))
        for g, r, what in zip(got, ref, ("R", "p", "S", "Sdot")):
            _close(g, r, what)


def _jax_fn(model, part):
    """One jitted JAX function of the model's per-body algorithms: "kin"
    (fk, aba with and without f_ext_world) or "crb" (crba, rnea_bias
    with and without f_ext_world, forward_dynamics_crb)."""
    def run(q, dq, tau, fext):
        kin = JA.fk(model, q, dq)
        if part == "kin":
            return dict(
                kin={f: getattr(kin, f) for f in FIELDS},
                aba=JA.aba(model, kin, q, dq, tau, model.dt),
                aba_f=JA.aba(model, kin, q, dq, tau, model.dt,
                             f_ext_world=fext))
        return dict(
            rnea=JA.rnea_bias(model, kin, dq),
            rnea_f=JA.rnea_bias(model, kin, dq, f_ext_world=fext),
            fd=JA.forward_dynamics_crb(model, kin, q, dq, tau, model.dt,
                                       fext))
    return jax.jit(run)


def _check_model(jmodel, seed, parts=("kin", "crb"), states=2):
    model = port_model(jmodel)
    runs = {p: _jax_fn(jmodel, p) for p in parts}
    rng = np.random.default_rng(seed)
    n, nb = jmodel.n, jmodel.nb
    dt = float(jmodel.dt)
    for _ in range(states):
        q = np.asarray(jmodel.q_init) + rng.uniform(-0.6, 0.6, n)
        dq, tau = rng.uniform(-2, 2, n), rng.uniform(-5, 5, n)
        fext = rng.uniform(-10, 10, (nb, 6))
        args = tuple(map(jnp.asarray, (q, dq, tau, fext)))
        tq, tdq, ttau, tf = map(torch.tensor, (q, dq, tau, fext))
        kin = PA.fk(model, tq, tdq)
        if "kin" in parts:
            ref = runs["kin"](*args)
            for f in FIELDS:
                _close(getattr(kin, f), ref["kin"][f], f)
            _close(PA.aba(model, kin, tq, tdq, ttau, dt), ref["aba"], "aba")
            _close(PA.aba(model, kin, tq, tdq, ttau, dt, f_ext_world=tf),
                   ref["aba_f"], "aba f_ext")
        if "crb" in parts:
            ref = runs["crb"](*args)
            _close(PA.rnea_bias(model, kin, tdq), ref["rnea"], "rnea")
            _close(PA.rnea_bias(model, kin, tdq, f_ext_world=tf),
                   ref["rnea_f"], "rnea f_ext")
            ddq, M = PA.forward_dynamics_crb(model, kin, tq, tdq, ttau, dt,
                                             tf)
            _close(ddq, ref["fd"][0], "forward_dynamics_crb ddq")
            _close(M, ref["fd"][1], "forward_dynamics_crb M (crba)")
            _close(PA.crba(model, kin), ref["fd"][1], "crba")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_chains(name):
    _check_model(MODELS[name](), seed=len(name))


@pytest.mark.parametrize("part", ["kin", "crb"])
@pytest.mark.parametrize("asset", ASSETS)
def test_assets(asset, part):
    world = parse_skel(asset_path(asset), dtype=jnp.float64)
    for i, jmodel in enumerate(world.skeletons):
        _check_model(jmodel, seed=i, parts=(part,), states=1)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_crba_vs_aba(name):
    """M^-1 (tau - C) equals ABA's ddq (tests/test_dynamics.py's check,
    its tolerances)."""
    model = port_model(MODELS[name]())
    rng = np.random.RandomState(3)
    for _ in range(5):
        q = torch.tensor(rng.randn(model.n) * 0.5)
        dq = torch.tensor(rng.randn(model.n))
        tau = torch.tensor(rng.randn(model.n))
        kin = PA.fk(model, q, dq)
        ddq_crb = torch.linalg.solve(PA.crba(model, kin),
                                     tau - PA.rnea_bias(model, kin, dq))
        ddq_aba = PA.aba(model, kin, q, dq, tau, model.dt)
        np.testing.assert_allclose(ddq_aba.numpy(), ddq_crb.numpy(),
                                   rtol=1e-6, atol=1e-8)

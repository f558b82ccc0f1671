"""PyTorch port, the C++ golden engines (native/aba.cpp,
native/lcp_dantzig.cpp through dartenv_tpu_torch/native) on the CPU: the
loader builds and loads in concurrent processes without a race; the
golden LCP solve against the port's pgs_solve and dantzig_solve by
complementarity residual; the golden ABA against the port's per-body
aba on every joint type, with damping, springs and external forces, and
on every env asset; kernel 3's per-env code (its g++ host build) against
the golden ABA on walker2d states."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu_torch import native
from dartenv_tpu_torch.dynamics import algorithms as PA
from dartenv_tpu_torch.model import skel_model as sm
from dartenv_tpu_torch.model.builder import ModelBuilder, box_inertia
from dartenv_tpu_torch.model.skel_parser import asset_path, parse_skel
from dartenv_tpu_torch.validation.residual import comp_residual

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no host C++ compiler (g++)")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ABA_TOL = 1e-8     # golden vs port, relative to max(1, |ddq|) (test_native)


def test_concurrent_builds_do_not_race():
    """Six processes rebuild and load the golden library at once (as six
    test workers may): each writes under its own name and renames into
    place, so every one loads a whole library and solves."""
    code = ("import numpy as np\n"
            "from dartenv_tpu_torch import native\n"
            "native.build(force=True)\n"
            "x, w, bad = native.lcp_solve(np.eye(2) * 2, -np.ones(2), "
            "np.zeros(2), np.full(2, 1e20))\n"
            "assert bad == 0 and np.allclose(x, 0.5), x\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(6)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    lib_dir = os.path.dirname(native.build())
    assert not [f for f in os.listdir(lib_dir) if ".tmp" in f]
    assert native.lib() is native.lib()


def _random_boxed_lcp(rng, m, friction=False):
    """tests/test_native.py's random boxed LCPs."""
    G = rng.standard_normal((m, max(m, 6)))
    A = G @ G.T + 0.5 * np.eye(m)
    b = rng.standard_normal(m)
    lo, hi = np.zeros(m), np.full(m, 1e20)
    findex, mu = -np.ones(m, dtype=np.int64), np.ones(m)
    if friction:
        for k in range(m // 3):
            for t in (1, 2):
                i = 3 * k + t
                findex[i], lo[i], hi[i], mu[i] = 3 * k, -1e20, 1e20, 0.8
    return A, b, lo, hi, findex, mu


def _residual(A, b, x, lo, hi, findex, mu):
    return comp_residual(A, b, x, lo, hi, findex, mu, np.ones(len(b)))


@pytest.mark.parametrize("m", [3, 8, 17])
def test_golden_lcp_against_pgs(m):
    """No friction, SPD A: one solution; the golden and the port's PGS
    (600 sweeps) reach it."""
    from dartenv_tpu_torch.lcp.pgs import pgs_solve

    rng = np.random.default_rng(1)
    for _ in range(5):
        A, b, lo, hi, findex, mu = _random_boxed_lcp(rng, m)
        x, w, bad = native.lcp_solve(A, b, lo, hi, findex, mu)
        assert bad == 0
        np.testing.assert_allclose(w, A @ x + b, atol=1e-9)
        scale = max(1.0, np.abs(b).max())
        assert _residual(A, b, x, lo, hi, findex, mu) < 1e-8 * scale
        T = lambda a: torch.tensor(a)[None]
        xp = pgs_solve(T(A), T(b), T(lo), T(hi), findex, T(mu),
                       torch.ones(1, m, dtype=torch.float64),
                       iters=600)[0].numpy()
        assert _residual(A, b, xp, lo, hi, findex, mu) < 1e-6 * scale
        np.testing.assert_allclose(xp, x, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("m", [6, 9])
def test_golden_lcp_against_dantzig_with_friction(m):
    """Friction rows (findex): both are complementarity points of their
    friction bounds; friction LCPs may have several, so they are compared
    by residual, not by impulses."""
    from dartenv_tpu_torch.lcp.dantzig import dantzig_solve

    rng = np.random.default_rng(2)
    for _ in range(8):
        A, b, lo, hi, findex, mu = _random_boxed_lcp(rng, m, friction=True)
        x, _, bad = native.lcp_solve(A, b, lo, hi, findex, mu)
        assert bad == 0
        T = lambda a: torch.tensor(a)[None]
        xp = dantzig_solve(T(A), T(b), T(lo), T(hi), findex, T(mu),
                           torch.ones(1, m, dtype=torch.float64), iters=25,
                           polish_iters=60)[0].numpy()
        assert _residual(A, b, x, lo, hi, findex, mu) < 1e-8
        assert _residual(A, b, xp, lo, hi, findex, mu) < 5e-4


def _check_aba(model, seed, fext=False, states=3):
    rng = np.random.default_rng(seed)
    n, nb = model.n, model.nb
    for _ in range(states):
        q = model.host("q_init") + rng.uniform(-0.7, 0.7, n)
        dq, tau = rng.uniform(-2, 2, n), rng.uniform(-5, 5, n)
        fe = rng.uniform(-10, 10, (nb, 6)) if fext else None
        tq, tdq = torch.tensor(q), torch.tensor(dq)
        got = PA.aba(model, PA.fk(model, tq, tdq), tq, tdq, torch.tensor(tau),
                     model.dt, None if fe is None else torch.tensor(fe))
        ref = native.aba(model, q, dq, tau, model.dt, f_ext_world=fe)
        scale = max(1.0, np.abs(ref).max())
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=ABA_TOL * scale)


def _all_joint_types():
    """One chain through all ten joint types, with springs, dampers and
    joint frames."""
    ine = lambda m: box_inertia(m, (0.1, 0.06, 0.04))
    b = ModelBuilder(dt=0.002)
    chain = [(sm.FREE, {}), (sm.EULER, dict(damping=0.3)),
             (sm.UNIVERSAL, dict(axes=[(1, 0, 0), (0, 0.6, 0.8)],
                                 spring=2.0, rest=(0.1, -0.2))),
             (sm.REVOLUTE, dict(axes=[(0, 1, 0)], damping=0.5)),
             (sm.PRISMATIC, dict(axes=[(0, 1, 0)], spring=3.0)),
             (sm.SCREW, dict(axes=[(0, 0, 1)], pitch=0.3, damping=0.2)),
             (sm.BALL, {}), (sm.WELD, {}),
             (sm.TRANSLATIONAL, dict(spring=1.5, damping=0.1)),
             (sm.PLANAR, dict(axes=[(1, 0, 0), (0, 0, 1), (0, 1, 0)]))]
    parent = None
    for i, (jt, kw) in enumerate(chain):
        name = f"b{i}"
        b.add_body(name, parent, jt, mass=1.0 + 0.1 * i, inertia=ine(1.0),
                   com=(0.01 * i, -0.02, 0.0),
                   pj_pos=(0.05, -0.2, 0.01) if parent else (0, 0, 0),
                   cj_pos=(0.0, 0.1, -0.02), **kw)
        parent = name
    return b.finalize(dtype=torch.float64, device="cpu")


def test_golden_aba_every_joint_type():
    model = _all_joint_types()
    assert set(model.joint_type) == set(range(10))
    _check_aba(model, 0)
    _check_aba(model, 1, fext=True)


@pytest.mark.parametrize("asset", [
    "walker2d.skel", "hopper_capsule.skel", "kima_humanwalker.skel",
    "walker3d.skel", "dog.skel", "snake_7link.skel", "reacher.skel",
    "reacher2d.skel", "cartpole.skel", "doublependulum.skel"])
def test_golden_aba_on_env_assets(asset):
    world = parse_skel(asset_path(asset), dtype=torch.float64, device="cpu")
    for i, model in enumerate(world.skeletons):
        _check_aba(model, i, fext=(i == 0), states=2)


def test_dynamics_kernel_host_build_against_golden():
    """Kernel 3's per-env arithmetic (float32, g++ host build) against
    the golden ABA on walker2d states: ddq = (dq_star - dq) / dt within
    1e-4 of max(1, |ddq|) (measured 1.8e-5: the float32 rounding of
    dq_star over dt)."""
    from dartenv_tpu_torch.bench.throughput import make_task
    from dartenv_tpu_torch.dynamics.hopper_dynamics import get_dynamics_kernel

    model = make_task("walker2d", dtype=torch.float32, device="cpu").model
    m64 = model.to(dtype=torch.float64)
    rng = np.random.default_rng(3)
    B, n = 16, model.n
    q = model.host("q_init") + rng.uniform(-0.5, 0.5, (B, n))
    dq, tau = rng.uniform(-3, 3, (B, n)), rng.uniform(-100, 100, (B, n))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    dq_star = get_dynamics_kernel(model).run_host(f32(q), f32(dq),
                                                  f32(tau))[0]
    dt = float(model.dt)
    q32, dq32, tau32 = (f32(a).double().numpy() for a in (q, dq, tau))
    for i in range(B):
        ref = native.aba(m64, q32[i], dq32[i], tau32[i], dt)
        got = (dq_star[i].double().numpy() - dq32[i]) / dt
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(ref).max()))


def test_bpp_core_plain_against_golden():
    """The BPP kernel's plain version (core mode, the solver="dantzig"
    budgets) on walker2d's phase-wise LCPs from a short float32 rollout,
    against the golden by normalized residual: the golden exact (below
    1e-9), the plain version below 1e-4 on all but one env of 16 and
    below 1e-3 on that one (a float32 BPP solve can stall just above 1e-4,
    ROADMAP.md Queue 3 item 3: here one env at 1.2e-4, the rest below
    6e-7).  chip_smoke.py's phase golden holds the kernel so on the card,
    at most 4 envs of 64 above 1e-4."""
    from dartenv_tpu_torch.bench.throughput import make_task
    from dartenv_tpu_torch.engine.constraints import (
        assemble_lcp, build_layout, compact_lam,
    )
    from dartenv_tpu_torch.collision.narrowphase import collide
    from dartenv_tpu_torch.dynamics import batched
    from dartenv_tpu_torch.lcp.hopper_bpp import bpp_solve_reference
    from dartenv_tpu_torch.parallel.vec_env import VecEnv

    task = make_task("walker2d", device="cpu")
    gen = torch.Generator().manual_seed(0)
    vec = VecEnv(task, 16, max_episode_steps=1000, generator=gen)
    state, _ = vec.reset()
    hi_a = torch.as_tensor(task.control_bounds[0], dtype=torch.float32)
    act_a = lambda: (torch.rand((16, task.action_size), generator=gen)
                     * 2 - 1) * hi_a
    for _ in range(10):
        state, *_ = vec.step(state, act_a())
    model = task.model
    q, dq, lam = state.sim.q, state.sim.dq, state.sim.lam
    kin = batched.bkin(model, q, dq)
    ddq, M = batched.forward_dynamics(model, kin, q, dq,
                                      task.action_to_tau(act_a(), state.aux),
                                      model.dt)
    dq_star = dq + model.dt * ddq
    A, b, lo, hi, act, mu, findex, _, row_sel, _ = assemble_lcp(
        model, build_layout(model), kin.phi, M, q, dq, dq_star,
        collide(model, kin.R_w, kin.p_w), model.dt)
    lam_k = bpp_solve_reference(A, b, lo, hi, findex, mu, act, iters=24,
                                polish_iters=10,
                                lam0=compact_lam(lam, row_sel, act))
    assert float(act.sum()) > 16, "constraint rows are not live"
    res_k = []
    for i in range(16):
        a = act[i].double().numpy() > 0.5
        h = lambda x: x[i].double().numpy()
        loi, hii = np.where(a, h(lo), 0.0), np.where(a, h(hi), 0.0)
        x, _, bad = native.lcp_solve(h(A), h(b), loi, hii, findex, h(mu))
        res = lambda z: (comp_residual(h(A), h(b), z, loi, hii, findex,
                                       h(mu), a.astype(np.float64))
                         / max(1.0, np.abs(z).max()))
        assert bad == 0 and res(x) < 1e-9
        res_k.append(res(h(lam_k)))
    res_k = np.asarray(res_k)
    assert (res_k > 1e-4).sum() <= 1 and res_k.max() < 1e-3, res_k

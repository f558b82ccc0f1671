"""PyTorch port, domain randomization (parallel/domain_rand,
engine/world.make_dr_sim_step, bench/throughput.bench_dr): per-env
physics leaves through the port's plain paths against per-env runs of the
port and against the JAX package's make_randomized_sim_step, on the same
numpy leaves, float64."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.bench.throughput import make_task as jax_make_task
from dartenv_tpu.engine.world import init_state as jax_init_state
from dartenv_tpu.envs.base import with_solver as jax_with_solver
from dartenv_tpu.parallel.domain_rand import (
    make_randomized_sim_step as jax_randomized_step,
)
from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
from dartenv_tpu_torch.engine import hopper_substep as ths
from dartenv_tpu_torch.engine.world import (
    init_state, make_dr_sim_step, make_sim_step,
)
from dartenv_tpu_torch.parallel import domain_rand as tdr
from test_dynamics import double_pendulum_model
from torch_port_util import N, T, dr_leaves, port_dr_model, port_model

_DYN = ("mass", "com", "inertia", "damping", "spring_stiff", "rest_pos",
        "gravity")
_SUB = _DYN + ("geom_friction", "geom_restitution", "wg_friction",
               "wg_restitution", "geom_size")


def _rel(got, ref):
    got, ref = N(got), np.asarray(ref, np.float64)
    if not ref.size:                    # lam of a model without rows
        return 0.0 if got.shape == ref.shape else np.inf
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def test_randomized_batch_matches_per_env_runs():
    """(a) make_randomized_sim_step on a double pendulum with per-env mass
    and damping (B = 5, 25 substeps, float64) equals stepping each env's
    own model alone, to 1e-12; the port's counterpart of the JAX test of
    the same name."""
    base = port_model(dataclasses.replace(
        double_pendulum_model(dtype=jnp.float64),
        damping=jnp.asarray([0.3, 0.8])))
    B = 5
    spec = {"mass": 0.4, "damping": 0.5}
    gen = torch.Generator()
    gen.manual_seed(0)
    bmodel = tdr.randomize_model(base, spec, B, gen)
    assert bmodel.mass.shape == (B, base.nb)
    assert bmodel.damping.shape == (B, base.n)
    assert torch.equal(bmodel.com, base.com)          # unrandomized: shared
    step = tdr.make_randomized_sim_step(base, list(spec))
    tau = torch.tensor([0.5, -0.2], dtype=torch.float64)
    bs = init_state(base, B)
    for _ in range(25):
        bs, _ = step(bmodel, bs, tau.expand(B, 2))
    for i in range(B):
        mi = base.replace(mass=bmodel.mass[i], damping=bmodel.damping[i])
        step_i = make_sim_step(mi)
        si = init_state(mi, 1)
        for _ in range(25):
            si, _ = step_i(si, tau[None])
        assert _rel(bs.q[i], si.q[0]) <= 1e-12
        assert _rel(bs.dq[i], si.dq[0]) <= 1e-12
    assert float(bs.q[:, 0].std()) > 1e-5


@pytest.mark.parametrize("env", ["walker2d", "hopper", "cartpole"])
def test_plain_dr_path_matches_jax(env):
    """(b) The same per-env leaves (numpy, seeded) through JAX
    make_randomized_sim_step (on the CPU its vmapped XLA composition) and
    through the port's: walker2d and hopper with all twelve DR_FIELDS_SUB
    leaves (the port's fused route, plain versions), cartpole with the
    seven DR_FIELDS_DYN leaves (the phase-wise route); float64, B = 4,
    escalation off, one substep from contact-biased states: q, dq and lam
    within 1e-12 of max(1, |JAX|).  (c) The DR values matter: dq differs
    from the base model's step by more than 1e-8."""
    jm = jax_with_solver(jax_make_task(env, dtype=jnp.float64).model, None,
                         escalate_frac=0.0)
    fields = _DYN if env == "cartpole" else _SUB
    B = 4
    leaves = dr_leaves(jm, fields, B, seed=5)
    jb, base, bmodel = port_dr_model(jm, leaves)
    assert bmodel.mass.shape == (B, base.nb)
    if env != "cartpole":
        assert bmodel.geom_size.shape == (B, base.ng, 3)
        assert make_dr_sim_step(base, fields) is not None

    rng = np.random.default_rng(6)
    n = jm.n
    q = np.asarray(jm.q_init)[None] + rng.uniform(-0.05, 0.05, (B, n))
    if env != "cartpole":
        q[:, 1] -= rng.uniform(0.0, 0.04, B)     # press the feet in
    dq = rng.uniform(-1.0, 1.0, (B, n))
    tau = rng.uniform(-60.0, 60.0, (B, n))
    j0 = jax_init_state(jm, warm_start=True)
    m = j0.lam.shape[0]
    lam = rng.uniform(0.0, 0.2, (B, m))
    jstate = dataclasses.replace(
        jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                               j0),
        q=jnp.asarray(q), dq=jnp.asarray(dq), lam=jnp.asarray(lam))
    jstep = jax.jit(jax_randomized_step(jm, list(fields)))
    jout, _ = jstep(jb, jstate, jnp.asarray(tau))

    tstate = dataclasses.replace(init_state(base, B), q=T(q), dq=T(dq),
                                 lam=T(lam))
    before = ths.PLAIN_CALLS, hd.PLAIN_CALLS
    tstep = tdr.make_randomized_sim_step(base, fields)
    tout, contacts = tstep(bmodel, tstate, T(tau))
    # the route: the fused phase (walker2d, hopper), else the dynamics
    # phase with the DR leaves
    fused = env != "cartpole"
    assert (ths.PLAIN_CALLS - before[0], hd.PLAIN_CALLS - before[1]) == (
        (1, 0) if fused else (0, 1))
    for name, a, r in (("q", tout.q, jout.q), ("dq", tout.dq, jout.dq),
                       ("lam", tout.lam, jout.lam)):
        assert _rel(a, r) <= 1e-12, (env, name, _rel(a, r))
    if fused:
        assert float(N(tout.lam).max()) > 0, "contacts are not live"
        # per-env contact values in the returned Contacts: per slot, min
        # of its geom's and world geom's friction, max of restitution
        slots = ths._SubStatic(base).slots
        gi = [d["gi"] for d in slots for _ in range(d["nslots"])]
        wi = [d["wi"] for d in slots for _ in range(d["nslots"])]
        for got, g, w, op in (
                (contacts.friction, "geom_friction", "wg_friction",
                 np.minimum),
                (contacts.restitution, "geom_restitution",
                 "wg_restitution", np.maximum)):
            np.testing.assert_array_equal(
                N(got), op(leaves[g][:, gi], leaves[w][:, wi]))
    # (c) against the base model's step
    s0, _ = make_sim_step(base)(tstate, T(tau))
    assert np.abs(N(s0.dq) - N(tout.dq)).max() > 1e-8


def test_randomized_contact_params():
    """(d) geom_friction randomization through the whole contact
    pipeline, the port's ModelBuilder: a box sliding at 2 m/s decelerates
    faster with more friction (the JAX test of the same name)."""
    from dartenv_tpu_torch.model import skel_model as sm
    from dartenv_tpu_torch.model.builder import ModelBuilder, box_inertia

    b = ModelBuilder(dt=0.002)
    b.add_body("b", None, sm.TRANSLATIONAL, mass=1.0,
               inertia=box_inertia(1.0, (0.1, 0.1, 0.1)),
               q_init=[0.0, 0.1, 0.0])
    b.add_geom("b", sm.GEOM_BOX, (0.1, 0.1, 0.1), friction=0.5)
    b.add_ground(friction=10.0)          # pair friction = min -> geom's
    base = b.finalize(dtype=torch.float64, device="cpu")
    B = 4
    fr = torch.tensor([0.05, 0.2, 0.5, 1.0], dtype=torch.float64)[:, None]
    bmodel = base.replace(geom_friction=fr.expand(B, 1))
    step = tdr.make_randomized_sim_step(base, ["geom_friction"])
    state = init_state(base, B)
    state = dataclasses.replace(
        state, dq=torch.tensor([2.0, 0.0, 0.0],
                               dtype=torch.float64).expand(B, 3).clone())
    tau = torch.zeros((B, 3), dtype=torch.float64)
    for _ in range(100):
        state, contacts = step(bmodel, state, tau)
    vx = N(state.dq[:, 0])
    assert np.all(np.diff(vx) < 0), vx
    assert vx[-1] < 0.4 < vx[0]
    np.testing.assert_array_equal(N(contacts.friction[:, 0]), N(fr[:, 0]))


def test_layout_leaves_rejected_and_dr_step_routing():
    """(e) Layout leaves are refused; make_dr_sim_step serves every
    DR_FIELDS_SUB set of a fused-scope model and refuses others (the JAX
    package's tests/test_dr_kernel.py routing), and no model without
    constraint rows."""
    base = port_model(double_pendulum_model(dtype=jnp.float64))
    for leaf in sorted(tdr.LAYOUT_LEAVES)[:2]:
        with pytest.raises(ValueError):
            tdr.make_randomized_sim_step(base, [leaf])
        with pytest.raises(ValueError):
            tdr.randomize_model(base, {leaf: 0.1}, 2, torch.Generator())
    with pytest.raises(NotImplementedError, match="axes"):
        tdr.make_randomized_sim_step(base, ["mass", "axes"])
    from dartenv_tpu_torch.bench.throughput import make_task

    model = make_task("walker2d", device="cpu").model
    assert ths.DR_FIELDS_SUB == _SUB and hd.DR_FIELDS_DYN == _DYN
    assert make_dr_sim_step(model, ("mass", "geom_friction")) is not None
    assert make_dr_sim_step(model, ths.DR_FIELDS_SUB) is not None
    assert make_dr_sim_step(model, ("mass", "axes")) is None
    assert make_dr_sim_step(model, ("ancestor_mask",)) is None
    assert make_dr_sim_step(make_task("cartpole", device="cpu").model,
                            ("mass",)) is None
    assert hd.make_dynamics_phase(model, ("geom_friction",)) is None


def test_bench_dr_runs_both_routes_on_cpu():
    """(f) bench_dr's harness on the CPU for both routes (B = 8, 4
    substeps): the fused route runs the substep phase's plain version on
    every substep, the phase-wise route the dynamics phase's, and neither
    the plain per-env dynamics; both end finite."""
    from dartenv_tpu_torch.bench.throughput import bench_dr

    for force in (False, True):
        before = (ths.PLAIN_CALLS, hd.PLAIN_CALLS,
                  tdr.PLAIN_DYNAMICS_STEPS)
        r = bench_dr("hopper", batch=8, substeps=4, iters=1, device="cpu",
                     force_phasewise=force)
        after = (ths.PLAIN_CALLS, hd.PLAIN_CALLS, tdr.PLAIN_DYNAMICS_STEPS)
        runs = [a - b for a, b in zip(after, before)]
        assert runs == ([0, 8, 0] if force else [8, 0, 0]), (force, runs)
        assert r["kernel_path"] is not force and r["finite_state"]
        assert r["env_steps_per_s"] > 0 and r["device_name"] == "cpu"

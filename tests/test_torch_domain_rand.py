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
# leaves outside the fused route's set: joint frames and axes, limits,
# geom frames, the ground plane (and mass, a kernel leaf, beside them)
_FRAMES = ("pj_rot", "pj_pos", "cj_rot", "cj_pos", "axes", "q_lower",
           "q_upper", "geom_rot", "geom_pos", "wg_normal", "wg_offset",
           "mass")


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
    # every other numeric leaf is taken (the frame leaves among them)
    assert callable(tdr.make_randomized_sim_step(base, ["mass", "axes"]))
    from dartenv_tpu_torch.envs.tasks import make_task

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


def test_frame_limit_geom_ground_leaves_match_jax():
    """(g) Per-env joint frames and axes, limits, geom frames and the
    ground plane (and mass) of walker2d through the JAX
    make_randomized_sim_step (its vmapped phase-wise fallback) and the
    port's (the phase-wise route with the plain per-env dynamics, the
    per-env collision and limit rows): float64, B = 3, escalation off, 4
    substeps from contact-biased states, q, dq and lam within 1e-9 of
    max(1, |JAX|); the leaves matter (dq differs from the base model's)."""
    jm = jax_with_solver(jax_make_task("walker2d", dtype=jnp.float64).model,
                         None, escalate_frac=0.0)
    B, steps = 3, 4
    leaves = dr_leaves(jm, _FRAMES, B, seed=8)
    # limits tight enough that some bind, the plane tilted and raised a
    # little per env
    rng = np.random.default_rng(9)
    leaves["q_lower"] = np.asarray(jm.q_lower)[None] * 0.1 - 0.02
    leaves["q_upper"] = np.asarray(jm.q_upper)[None] * 0.1 + 0.02
    leaves["q_lower"] = leaves["q_lower"] + rng.uniform(-0.01, 0.01,
                                                        (B, jm.n))
    leaves["q_upper"] = leaves["q_upper"] + rng.uniform(-0.01, 0.01,
                                                        (B, jm.n))
    nrm = np.asarray(jm.wg_normal)[None] + rng.uniform(
        -0.05, 0.05, (B,) + np.asarray(jm.wg_normal).shape)
    leaves["wg_normal"] = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    leaves["wg_offset"] = rng.uniform(-0.02, 0.02,
                                      (B,) + np.asarray(jm.wg_offset).shape)
    jb, base, bmodel = port_dr_model(jm, leaves)
    assert bmodel.axes.shape == (B,) + tuple(base.axes.shape)
    assert make_dr_sim_step(base, _FRAMES) is None

    rng = np.random.default_rng(10)
    n = jm.n
    q = np.asarray(jm.q_init)[None] + rng.uniform(-0.05, 0.05, (B, n))
    q[:, 1] -= rng.uniform(0.0, 0.04, B)        # press the feet in
    dq = rng.uniform(-1.0, 1.0, (B, n))
    tau = rng.uniform(-60.0, 60.0, (B, n))
    j0 = jax_init_state(jm, warm_start=True)
    lam = np.zeros((B, j0.lam.shape[0]))
    jstate = dataclasses.replace(
        jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                               j0),
        q=jnp.asarray(q), dq=jnp.asarray(dq), lam=jnp.asarray(lam))
    jstep = jax.jit(jax_randomized_step(jm, list(_FRAMES)))
    tstate = dataclasses.replace(init_state(base, B), q=T(q), dq=T(dq),
                                 lam=T(lam))
    tstep = tdr.make_randomized_sim_step(base, _FRAMES)
    s0 = tstate
    plain = tdr.PLAIN_DYNAMICS_STEPS
    live = 0.0
    for _ in range(steps):
        jstate, _ = jstep(jb, jstate, jnp.asarray(tau))
        tstate, _ = tstep(bmodel, tstate, T(tau))
        live = max(live, float(N(tstate.lam).max()))
        for name, a, r in (("q", tstate.q, jstate.q),
                           ("dq", tstate.dq, jstate.dq),
                           ("lam", tstate.lam, jstate.lam)):
            assert _rel(a, r) <= 1e-9, (name, _rel(a, r))
    assert tdr.PLAIN_DYNAMICS_STEPS - plain == steps
    assert live > 0, "no contact or limit row is live"
    for _ in range(steps):
        s0, _ = make_sim_step(base)(s0, T(tau))
    assert np.abs(N(s0.dq) - N(tstate.dq)).max() > 1e-6


def test_per_env_geom_pos_on_capsule_box_pairs():
    """(h) The composed walker-and-box world (bench/scenes.
    walker_box_world: its capsule-box cross pairs collide in one call)
    with per-env geom_pos and geom_rot, B = 2, float64, 6 substeps near
    the default pose (the pairs are collided on every substep, live or
    not): the randomized batch equals stepping each env's own model alone,
    to 1e-12."""
    from dartenv_tpu_torch.bench.scenes import walker_box_world

    base = walker_box_world(device="cpu", dtype=torch.float64)
    B, steps = 2, 6
    rng = np.random.default_rng(12)
    gpos = base.geom_pos[None].repeat(B, 1, 1)
    gpos = gpos + T(rng.uniform(-0.02, 0.02, tuple(gpos.shape)))
    grot = base.geom_rot[None].repeat(B, 1, 1, 1)
    grot = grot * T(rng.uniform(0.97, 1.03, (B, base.ng, 1, 1)))
    bmodel = base.replace(geom_pos=gpos, geom_rot=grot)
    fields = ("geom_pos", "geom_rot")
    step = tdr.make_randomized_sim_step(base, fields)
    q = base.q_init[None].repeat(B, 1)
    q[:, 9 + 4] += 0.02                         # the box drops 2 cm
    q = q + T(rng.uniform(-0.02, 0.02, (B, base.n)))
    tau = T(rng.uniform(-30.0, 30.0, (B, base.n)))
    bs = dataclasses.replace(init_state(base, B), q=q.clone())
    for _ in range(steps):
        bs, contacts = step(bmodel, bs, tau)
    assert float(N(bs.lam).max()) > 0, "no contact is live"
    for i in range(B):
        mi = base.replace(geom_pos=gpos[i], geom_rot=grot[i])
        si = dataclasses.replace(init_state(mi, 1), q=q[i:i + 1].clone())
        step_i = make_sim_step(mi)
        for _ in range(steps):
            si, _ = step_i(si, tau[i:i + 1])
        assert _rel(bs.q[i], si.q[0]) <= 1e-12
        assert _rel(bs.dq[i], si.dq[0]) <= 1e-12
    assert _rel(bs.dq[0], bs.dq[1]) > 1e-9


@pytest.mark.parametrize("fields,plain", [
    (("mass", "axes"), True), (("pj_rot",), True), (("cj_pos",), True),
    (("q_lower",), False), (("mass", "geom_pos", "wg_offset"), False)])
def test_frame_leaves_route_to_plain_dynamics(fields, plain):
    """(i) Routing of the phase-wise route (the JAX package's
    tests/test_dr_kernel.py example ("mass", "axes") among them): a field
    set with a frame leaf runs the plain batched dynamics
    (PLAIN_DYNAMICS_STEPS, never the dynamics phase), one without keeps
    the dynamics phase for its DR_FIELDS_DYN part; neither takes the
    fused route."""
    from dartenv_tpu_torch.envs.tasks import make_task

    base = make_task("walker2d", device="cpu", dtype=torch.float64).model
    assert make_dr_sim_step(base, fields) is None
    B = 2
    gen = torch.Generator()
    gen.manual_seed(0)
    bmodel = tdr.randomize_model(base, dict.fromkeys(fields, 0.05), B, gen)
    step = tdr.make_randomized_sim_step(base, fields)
    before = (tdr.PLAIN_DYNAMICS_STEPS, hd.PLAIN_CALLS, ths.PLAIN_CALLS)
    st, _ = step(bmodel, init_state(base, B), torch.zeros((B, base.n),
                                                          dtype=torch.float64))
    after = (tdr.PLAIN_DYNAMICS_STEPS, hd.PLAIN_CALLS, ths.PLAIN_CALLS)
    assert [a - b for a, b in zip(after, before)] == (
        [1, 0, 0] if plain else [0, 1, 0])
    assert torch.isfinite(st.q).all()

"""PyTorch port, fused substep: the kernel's plain version
(engine/hopper_substep.substep_reference) against the JAX package's
per-env scalar trace (_trace_substep, float64, every output field
including the packed `esc`) and against the Pallas kernel in interpret
mode (float32, tiny model)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.bench.throughput import make_task as jax_make_task
from dartenv_tpu.engine import pallas_substep as jps
from dartenv_tpu.envs.base import with_solver as jax_with_solver
from dartenv_tpu_torch.dynamics import batched as tb
from dartenv_tpu_torch.engine import hopper_substep as ths
from test_pallas_interpret import _states, _tiny_model
from torch_port_util import N, T, port_model, rel_err

_FIELDS = ("dq_star", "dq_plus", "lam_c", "lam_full", "res", "b", "lo",
           "hi", "mu", "act", "Jc", "M", "sel_slots", "overflow", "con_pos",
           "con_depth", "con_active", "esc")
_DISCRETE = ("act", "con_active", "sel_slots", "overflow")


def _trace_batch(st, q, dq, tau, lam_prev):
    """_trace_substep with (B,) arrays as its scalar blocks."""
    cols = lambda x: [jnp.asarray(x[:, i]) for i in range(x.shape[1])]
    outs = jps._trace_substep(st, cols(q), cols(dq), cols(tau),
                              cols(lam_prev))
    B = q.shape[0]
    return {k: np.stack([np.broadcast_to(np.asarray(v, np.float64), (B,))
                         for v in vals], axis=1)
            for k, vals in outs.items()}


def test_reference_matches_trace_f64_rollout():
    """12 substeps of a contact-rich walker2d rollout: every field of the
    plain version equals the JAX trace to 1e-9 (float64; the two differ
    only in summation order), discrete fields exactly."""
    jm = jax_with_solver(jax_make_task("walker2d", dtype=jnp.float64).model,
                         None, escalate_frac=0.0)
    tm = port_model(jm)
    jst, tst = jps._SubStatic(jm), ths._SubStatic(tm)
    assert (tst.ns, tst.cap, tst.m_c, tst.layout.m) == \
        (jst.ns, jst.cap, jst.m_c, jst.layout.m) == (14, 6, 24, 48)
    np.testing.assert_array_equal(tst.findex_c, jst.findex_c)
    assert ths._esc_layout(tst) == jps._esc_layout(jst)
    assert ths._esc_layout(tst)[1] == 447
    assert ths._out_sizes(tst) == jps._out_sizes(jst)
    assert ths.substep_supported(tm) and jps.substep_supported(jm)

    B, n, m = 4, jm.n, jst.layout.m
    rng = np.random.default_rng(0)
    q = np.asarray(jm.q_init)[None] + rng.uniform(-0.05, 0.05, (B, n))
    q[:, 1] -= rng.uniform(0.0, 0.03, B)       # press the feet in
    dq = rng.uniform(-0.5, 0.5, (B, n))
    lam = np.zeros((B, m))
    worst, seen_active, seen_overflow = {}, 0.0, 0.0
    for k in range(12):
        if k % 4 == 0:
            tau = np.concatenate(
                [np.zeros((B, 3)), rng.uniform(-100, 100, (B, n - 3))], 1)
        ref = _trace_batch(jst, q, dq, tau, lam)
        got = ths.substep_reference(tm, tst, T(q), T(dq), T(tau), T(lam))
        for f in _FIELDS:
            assert N(got[f]).shape == ref[f].shape, f
            err = rel_err(got[f], ref[f])
            worst[f] = max(worst.get(f, 0.0), err)
        seen_active += ref["con_active"].sum()
        seen_overflow += ref["overflow"].sum()
        lam = N(got["lam_full"])
        dq = N(got["dq_plus"])
        q = N(tb.integrate_positions(tm, T(q), got["dq_plus"], tst.dt))
    for f, err in worst.items():
        assert err <= (0.0 if f in _DISCRETE else 1e-9), (f, err)
    assert seen_active > 0 and np.abs(lam).max() > 0


def test_reference_matches_pallas_interpret_f32():
    """The plain version in float32 vs the Pallas kernel's wrapper in
    interpret mode (un-jitted) on the tiny model of
    tests/test_pallas_interpret.py, B = 8, at that file's tolerances."""
    jm = _tiny_model(escalate_frac=0.0)
    tm = port_model(jm, dtype=torch.float32)
    q, dq, tau, lam = _states(jm, 8)
    outs = jps.substep_pallas(jm, q, dq, tau, lam, interpret=True)
    t32 = lambda x: T(x, torch.float32)
    tst = ths._SubStatic(tm)
    got = ths.substep_reference(tm, tst, t32(q), t32(dq), t32(tau),
                                t32(lam))
    assert got["dq_plus"].dtype == torch.float32
    for f in ths._OUT_FIELDS:
        assert tuple(got[f].shape) == tuple(outs[f].shape), f
    np.testing.assert_array_equal(N(got["con_active"]),
                                  np.asarray(outs["con_active"]))
    np.testing.assert_array_equal(N(got["overflow"]),
                                  np.asarray(outs["overflow"]))
    for f in ("dq_plus", "lam_full", "esc", "con_depth", "con_pos"):
        np.testing.assert_allclose(N(got[f]), np.asarray(outs[f]),
                                   rtol=2e-3, atol=2e-4, err_msg=f)
    np.testing.assert_allclose(N(got["res"]), np.asarray(outs["res"]),
                               rtol=0, atol=2e-3)
    assert N(got["con_active"]).sum() > 0
    assert np.abs(N(got["lam_full"])).max() > 0


def test_kernel_scope_and_cuda_only_paths():
    """Joint types outside the kernel's four are refused for the CUDA
    kernel by name, and nothing here launches on a CPU tensor."""
    from dartenv_tpu_torch.model import skel_model as sm
    from dartenv_tpu_torch.model.builder import ModelBuilder

    b = ModelBuilder(dt=0.002)
    b.add_body("ball", None, sm.BALL, mass=1.0, q_lower=-1.0, q_upper=1.0)
    b.add_geom("ball", sm.GEOM_SPHERE, (0.1,))
    b.add_ground()
    model = b.finalize(dtype=torch.float32, device="cpu")
    assert ths.in_fused_scope(model) and not ths.substep_supported(model)
    assert ths.unsupported_joints(model) == ["BALL"]
    with pytest.raises(NotImplementedError, match="BALL"):
        ths.model_header(model, ths._SubStatic(model))
    # a model without constraint rows is outside the fused path
    b2 = ModelBuilder(dt=0.002)
    b2.add_body("b", None, sm.REVOLUTE, mass=1.0)
    assert ths.make_substep_phase(
        b2.finalize(dtype=torch.float32, device="cpu")) is None
    # the header of a supported model carries the digest's sizes
    tm = port_model(_tiny_model(), dtype=torch.float32)
    head = ths.model_header(tm, ths._SubStatic(tm))
    assert "#define SS_N 2\n" in head and "#define SS_MC 4\n" in head
    kern = ths.get_substep_kernel(tm)
    z = torch.zeros((3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        kern(z, z, z, torch.zeros((3, 4)))


def _mixed_model():
    """Every family the kernel takes that walker2d lacks: PRISMATIC and
    WELD joints, a box (corner ranking), a sphere, dof-friction rows, no
    compaction, damping and a spring (the implicit-scheme branch)."""
    from dartenv_tpu_torch.model import skel_model as sm
    from dartenv_tpu_torch.model.builder import ModelBuilder, box_inertia

    b = ModelBuilder(dt=0.002)
    b.add_body("base", None, sm.PLANAR, mass=2.0,
               inertia=box_inertia(2.0, (0.2, 0.1, 0.15)),
               dof_friction=(0.0, 0.0, 0.3))
    b.add_body("rail", "base", sm.PRISMATIC, axes=[(0.6, 0.8, 0)], mass=0.3,
               inertia=box_inertia(0.3, (0.05, 0.05, 0.05)), damping=0.4,
               spring=5.0, rest=0.02, q_lower=-0.05, q_upper=0.05)
    b.add_body("plate", "rail", sm.WELD, mass=0.2, pj_pos=(0.25, 0, 0),
               inertia=box_inertia(0.2, (0.03, 0.03, 0.03)), com=(0.01, 0, 0))
    b.add_body("arm", "plate", sm.REVOLUTE, axes=[(0, 0, 2.0)], mass=0.5,
               inertia=box_inertia(0.5, (0.05, 0.15, 0.05)),
               cj_pos=(0, 0.15, 0), q_lower=-0.2, q_upper=0.2)
    b.add_geom("base", sm.GEOM_BOX, (0.2, 0.1, 0.15), friction=0.7,
               restitution=0.2)
    b.add_geom("arm", sm.GEOM_SPHERE, (0.08,), pos=(0, -0.15, 0))
    b.add_geom("arm", sm.GEOM_CAPSULE, (0.04, 0.1), pos=(0, 0.05, 0))
    b.add_ground(offset=0.0, friction=0.9)
    return b.finalize(dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("name", ["walker2d", "hopper", "mixed"])
def test_host_build_of_kernel_arithmetic_matches_plain(name):
    """csrc/substep_body.h is the per-env code of the CUDA kernel; built
    with g++ it runs here, on float32 CPU tensors, against the plain
    version at the bound the kernel is held to on the card: discrete
    fields and the bounds equal, every continuous field and every
    continuous block of `esc` (b, lam_c, M, Jc) within 1e-4 of its own
    max(1, |ref|_inf)."""
    import shutil

    from dartenv_tpu_torch.bench.throughput import make_task

    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    rng = np.random.default_rng(8)
    B = 48
    if name == "mixed":
        model = _mixed_model()
        q = rng.uniform(-0.3, 0.3, (B, model.n))
        q[:, 1] = rng.uniform(0.03, 0.14, B)
        q[:, 3] = rng.uniform(-0.07, 0.07, B)
    else:
        model = make_task(name, device="cpu").model
        q = N(model.q_init)[None] + rng.uniform(-0.15, 0.15, (B, model.n))
        q[:, 1] -= rng.uniform(0.0, 0.1, B)
    assert ths.substep_supported(model)
    kern = ths.get_substep_kernel(model)
    st = kern.st
    t32 = lambda x: T(x, torch.float32)
    q = t32(q)
    dq = t32(rng.uniform(-1.5, 1.5, (B, model.n)))
    tau = t32(rng.uniform(-60.0, 60.0, (B, model.n)))
    lam = t32(rng.uniform(0.0, 0.3, (B, st.layout.m)))
    got = kern.run_host(q, dq, tau, lam)
    ref = ths.substep_reference(model, st, q, dq, tau, lam)
    got, ref = ths.output_blocks(st, got), ths.output_blocks(st, ref)
    assert set(got) == set(ref) and "esc" not in got
    # copied or selected, never computed: equal to the last bit (lo and hi
    # hold 1e20, so a relative bound on them would hold nothing)
    exact = ("con_active", "overflow", "act", "sel_slots", "lo", "hi", "mu")
    for f in got:
        if f in exact:
            assert torch.equal(got[f], ref[f]), f
        else:
            assert rel_err(got[f], ref[f]) <= 1e-4, (
                f, rel_err(got[f], ref[f]))
    assert float(ref["con_active"].sum()) > B / 4
    assert float(ref["lam_full"].abs().max()) > 0


def test_host_build_is_bit_identical_to_the_recorded_outputs():
    """tests/data/substep_host_golden.npz holds the host build's outputs
    on recorded inputs from before two changes of csrc/substep_body.h: the
    dynamics stage moved into the shared csrc/dynamics_body.h, and the
    kernel became one warp per env.  On those inputs, for walker2d, hopper
    and the mixed model, every output computed before the PGS sweeps is
    still torch.equal to the record: the contact outputs and overflow, and
    the b, lo, hi, mu, act, sel_slots, M and Jc blocks of `esc`.  The
    outputs downstream of the sweeps (dq_plus, lam_full, res and the lam_c
    block) moved with the sweeps' row sums, which are now the PGS kernel's
    lane-wise products and shuffle butterfly (csrc/pgs_row.h), and the
    residual's row sums: they are held within 1e-4 of max(1, |recorded|)."""
    import os
    import shutil

    from dartenv_tpu_torch.bench.throughput import make_task

    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    gold = np.load(os.path.join(os.path.dirname(__file__), "data",
                                "substep_host_golden.npz"))
    bounded = ("dq_plus", "lam_full", "res", "lam_c")
    for name in ("walker2d", "hopper", "mixed"):
        model = (_mixed_model() if name == "mixed"
                 else make_task(name, device="cpu").model)
        kern = ths.get_substep_kernel(model)
        ins = [torch.as_tensor(gold[f"{name}/in/{k}"])
               for k in ("q", "dq", "tau", "lam")]
        got = kern.run_host(*ins)
        assert set(got) == set(ths._OUT_FIELDS)
        rec = {f: torch.as_tensor(gold[f"{name}/out/{f}"])
               for f in ths._OUT_FIELDS}
        got, rec = (ths.output_blocks(kern.st, x) for x in (got, rec))
        for f, v in got.items():
            if f in bounded:
                assert rel_err(v, rec[f]) <= 1e-4, (name, f,
                                                    rel_err(v, rec[f]))
            else:
                assert torch.equal(v, rec[f]), (name, f)

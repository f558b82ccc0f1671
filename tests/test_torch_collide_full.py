"""PyTorch port, collision/narrowphase.py over the full collision matrix vs
the JAX package (float64, CPU): slot_layout and collide on every scene of
the JAX collision-matrix tests (bench/scenes.py builds them with either
package's builder) and on the self-pair scenes of the JAX self-collision
tests, at jittered poses of the dropped body, within 1e-12 (tied manifold
slots as in test_torch_support.close_manifold).  The JAX collide runs
vmapped, and jitted unless the model has an ellipsoid (see
test_torch_support)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.collision import narrowphase as jn
from dartenv_tpu.dynamics import batched as jb
from dartenv_tpu.engine import constraints as jc
from dartenv_tpu.model import skel_model as jsm
from dartenv_tpu.model.builder import ModelBuilder as JBuilder
from dartenv_tpu_torch.bench import scenes
from dartenv_tpu_torch.collision import narrowphase as tn
from dartenv_tpu_torch.engine import constraints as tc
from torch_port_util import N, T, port_model
from test_torch_primitives import _close
from test_torch_support import close_manifold

B = 6


def _jax_scene(name):
    jm = scenes.scene_builder(name, JBuilder).finalize(dtype=jnp.float64)
    return jm, port_model(jm)


def _poses(jm, seed, spread=0.03):
    """World body poses (R_w, p_w) of B jittered states (numpy), from the
    JAX kinematics."""
    rng = np.random.default_rng(seed)
    q = np.asarray(jm.q_init)[None] + rng.uniform(-spread, spread,
                                                  (B, jm.n))
    kin = jax.vmap(lambda qi: jb.bkin(jm, qi, jnp.zeros(jm.n)))(
        jnp.asarray(q))
    return np.asarray(kin.R_w), np.asarray(kin.p_w)


def _check_collide(jm, tm, R, p):
    fn = jax.vmap(lambda Ri, pi: jn.collide(jm, Ri, pi))
    if jsm.GEOM_ELLIPSOID not in np.asarray(jm.geom_type):
        fn = jax.jit(fn)        # (only an ellipsoid's SAT differs jitted)
    ref = fn(jnp.asarray(R), jnp.asarray(p))
    got = tn.collide(tm, T(R), T(p))
    assert tn.slot_layout(tm) == jn.slot_layout(jm)
    close_manifold((got.pos, got.normal, got.depth),
                   (ref.pos, ref.normal, ref.depth))
    for f in ("active", "friction", "restitution", "overflow"):
        _close(getattr(got, f), getattr(ref, f))
    return got


@pytest.mark.parametrize("name", scenes.SCENES)
def test_collide_matrix_scene(name):
    jm, tm = _jax_scene(name)
    # the drop pose lowered onto its rest height: live contacts
    rest, _ = scenes.REST[name]
    q0 = np.asarray(jm.q_init).copy()
    q0[1] = rest - 0.01
    jm = jm.replace(q_init=jnp.asarray(q0))
    R, p = _poses(jm, seed=len(name))
    got = _check_collide(jm, tm, R, p)
    assert float(N(got.active).sum()) > 0, "no live contact: vacuous"


def test_collide_contact_cap_two_boxes():
    """Two boxes on one body over a ground with contact_cap 2: the
    overflow count of the JAX test."""
    import dataclasses

    b = JBuilder(dt=0.002)
    b.add_body("b", None, jsm.TRANSLATIONAL, mass=1.0,
               q_init=[0.0, 0.095, 0.0])
    b.add_geom("b", jsm.GEOM_BOX, (0.1, 0.1, 0.1), pos=(-0.3, 0, 0))
    b.add_geom("b", jsm.GEOM_BOX, (0.1, 0.1, 0.1), pos=(0.3, 0, 0))
    b.add_ground()
    jm = b.finalize(dtype=jnp.float64)
    jm = jm.replace(solver=dataclasses.replace(jm.solver, contact_cap=2))
    tm = port_model(jm)
    R, p = _poses(jm, seed=3, spread=0.002)
    got = _check_collide(jm, tm, R, p)
    assert float(N(got.overflow).max()) > 0


def _self_scenes():
    out = {}
    b = JBuilder(dt=0.002, gravity=(0.0, 0.0, 0.0))   # two spheres
    b.add_body("a", None, jsm.WELD, mass=1.0)
    b.add_body("bb", None, jsm.PRISMATIC, axes=((1, 0, 0),), mass=1.0,
               pj_pos=(0.55, 0.0, 0.0))
    ga = b.add_geom("a", jsm.GEOM_SPHERE, (0.3,))
    gb = b.add_geom("bb", jsm.GEOM_SPHERE, (0.3,))
    b.add_self_pair(gb, ga)
    out["spheres"] = b.finalize(dtype=jnp.float64)
    b = JBuilder(dt=0.002, gravity=(0.0, 0.0, 0.0))   # crossed capsules
    b.add_body("a", None, jsm.WELD, mass=1.0)
    b.add_body("bb", None, jsm.TRANSLATIONAL, mass=1.0,
               pj_pos=(0.0, 0.35, 0.0))
    ga = b.add_geom("a", jsm.GEOM_CAPSULE, (0.2, 0.5))
    Ry = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])
    gb = b.add_geom("bb", jsm.GEOM_CAPSULE, (0.2, 0.5), rot=Ry)
    b.add_self_pair(gb, ga)
    out["capsules"] = b.finalize(dtype=jnp.float64)
    b = JBuilder(dt=0.002, gravity=(0.0, 0.0, 0.0))   # common ancestor
    b.add_body("root", None, jsm.PRISMATIC, axes=((1, 0, 0),), mass=1.0)
    b.add_body("c1", "root", jsm.PRISMATIC, axes=((0, 1, 0),), mass=1.0)
    b.add_body("c2", "root", jsm.PRISMATIC, axes=((0, 1, 0),), mass=1.0,
               pj_pos=(0.15, 0.0, 0.0))
    g1 = b.add_geom("c1", jsm.GEOM_SPHERE, (0.1,))
    g2 = b.add_geom("c2", jsm.GEOM_SPHERE, (0.1,))
    g3 = b.add_geom("c2", jsm.GEOM_CAPSULE, (0.05, 0.1), pos=(0, 0.1, 0))
    b.add_self_pair(g1, g2)
    b.add_self_pair(g3, g1)
    out["ancestor"] = b.finalize(dtype=jnp.float64)
    return out


@pytest.mark.parametrize("name", ["spheres", "capsules", "ancestor"])
def test_collide_self_pair_scenes(name):
    jm = _self_scenes()[name]
    tm = port_model(jm)
    R, p = _poses(jm, seed=11, spread=0.05)
    got = _check_collide(jm, tm, R, p)
    assert float(N(got.active).sum()) > 0
    # the signed slot mask: common ancestors cancel exactly
    jl, tl = jc.build_layout(jm), tc.build_layout(tm)
    np.testing.assert_array_equal(tl.slot_mask, np.asarray(jl.slot_mask))
    np.testing.assert_array_equal(tl.findex, jl.findex)
    assert tl.m == jl.m and tl.slot_body == jl.slot_body
    if name == "ancestor":
        np.testing.assert_array_equal(tl.slot_mask[0], [0.0, 1.0, -1.0])


@pytest.mark.parametrize("name", ["capsule_box", "capsule_box_edge"])
@pytest.mark.parametrize("box_first", [False, True])
def test_collide_self_pair_capsule_box(name, box_first):
    """collide_self_pair on one capsule-box pair, called directly, in both
    orientations (normals from geom b toward geom a): the same route as
    `collide`'s runs of such pairs."""
    jm, tm = _jax_scene(name)
    rest, _ = scenes.REST[name]
    q0 = np.asarray(jm.q_init).copy()
    q0[1] = rest - 0.01
    jm = jm.replace(q_init=jnp.asarray(q0))
    R, p = _poses(jm, seed=5)
    (gc, gbox), = [tuple(int(g) for g in pr) for pr in jm.self_pairs]
    ga, gb = (gbox, gc) if box_first else (gc, gbox)
    ba, bb = int(jm.geom_body[ga]), int(jm.geom_body[gb])

    def pose(R, p, g, bi, mod):
        Rb = R[:, bi]
        return (Rb @ mod.geom_rot[g],
                p[:, bi] + (Rb @ mod.geom_pos[g][..., None])[..., 0])

    Ra, pa = pose(jnp.asarray(R), jnp.asarray(p), ga, ba, jm)
    Rb, pb = pose(jnp.asarray(R), jnp.asarray(p), gb, bb, jm)
    ref = jax.vmap(lambda *x: jn.collide_self_pair(jm, ga, gb, *x))(
        Ra, pa, Rb, pb)
    got = tn.collide_self_pair(tm, ga, gb, *(T(np.asarray(x))
                                             for x in (Ra, pa, Rb, pb)))
    close_manifold(got, ref)
    assert float(np.asarray(ref[2]).max()) > 0, "no live contact: vacuous"

"""PyTorch port, collision/support.py (the swept-cloud SAT) vs the JAX
package's on the same numpy inputs (float64, CPU), within 1e-12: the
clouds of every geom type, the static feature directions, sat_pair on
random poses and on the JAX collision-matrix tests' edge-edge and
rim-rim cases, and collide_support_pair of every SAT type pair.

Depths and normals are compared slot by slot.  Positions are compared
slot by slot too, except among slots whose depths tie exactly (two
vertices of a face parallel to the support plane): their order falls on
the last bit of the cloud's 3-term products, which XLA may fuse into
multiply-adds, so those slots are compared as a set (`close_manifold`).

The JAX side runs vmapped but not jitted: under jit the reference's
feature_dirs sees the ellipsoid's size as a tracer and drops its hull
axes, which the port (like the reference on a concrete model) keeps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dartenv_tpu.collision import support as js
from dartenv_tpu.model import skel_model as jsm
from dartenv_tpu.model.builder import ModelBuilder as JBuilder
from dartenv_tpu_torch.collision import support as ts
from torch_port_util import N, T, port_model
from test_torch_primitives import _close, _rot


def close_manifold(got, ref, tol=1e-12):
    """(pos (..., k, 3), normal, depth (..., k)) against the reference:
    normals and depths slot by slot, positions slot by slot up to the
    order inside groups of exactly tied depths; a tied group that reaches
    the last slot may hold other points of the same depth (the tie runs
    past the k kept), so only its depths are compared."""
    _close(got[1], ref[1], tol)
    _close(got[2], ref[2], tol)
    pg, pr = N(got[0]), np.asarray(ref[0], np.float64)
    dep = np.asarray(ref[2], np.float64)
    k = dep.shape[-1]
    pg, pr, dep = pg.reshape(-1, k, 3), pr.reshape(-1, k, 3), dep.reshape(
        -1, k)
    for e in range(dep.shape[0]):
        grp = np.concatenate([[0], np.cumsum(np.abs(np.diff(dep[e]))
                                             > tol)])
        for g_id in np.unique(grp):
            rows = grp == g_id
            if rows[-1] and rows.sum() > 1:
                continue     # a tie across the cut: either pick is right
            key = lambda P: P[np.lexsort(np.round(P, 9).T[::-1])]
            np.testing.assert_allclose(key(pg[e][rows]), key(pr[e][rows]),
                                       rtol=tol, atol=tol)

B = 8


def _all_geoms_model():
    """One body per geom type (sphere, capsule, box, cylinder, ellipsoid,
    mesh), self pairs between them all: every cloud and every SAT pair."""
    b = JBuilder(dt=0.002)
    verts = np.random.default_rng(5).normal(size=(11, 3)) * [0.2, 0.1, 0.15]
    specs = [(jsm.GEOM_SPHERE, (0.12,)), (jsm.GEOM_CAPSULE, (0.08, 0.2)),
             (jsm.GEOM_BOX, (0.15, 0.1, 0.2)), (jsm.GEOM_CYLINDER, (0.2, 0.3)),
             (jsm.GEOM_ELLIPSOID, (0.15, 0.25, 0.2)), (None, verts)]
    gs = []
    for i, (t, size) in enumerate(specs):
        b.add_body(f"b{i}", None, jsm.FREE, mass=1.0)
        gs.append(b.add_mesh_geom(f"b{i}", size) if t is None
                  else b.add_geom(f"b{i}", t, size))
    for i in gs:
        for j in gs:
            if i < j:
                b.add_self_pair(i, j)
    b.add_ground()
    jm = b.finalize(dtype=jnp.float64)
    return jm, port_model(jm), gs


def _poses(seed):
    rng = np.random.default_rng(seed)
    return _rot(rng, B), rng.normal(size=(B, 3)) * 0.2


def test_clouds_and_feature_dirs():
    jm, tm, gs = _all_geoms_model()
    R, p = _poses(6)
    for g in gs:
        assert ts.cloud_size(tm, g) == js.cloud_size(jm, g)
        got = ts.swept_cloud(tm, g, T(R), T(p))
        ref = jax.vmap(lambda Ri, pi: js.swept_cloud(jm, g, Ri, pi))(
            jnp.asarray(R), jnp.asarray(p))
        _close(got[0], ref[0])
        _close(np.broadcast_to(N(got[1]), (B,)), ref[1])
        _close(np.broadcast_to(N(got[2]), N(ref[2]).shape), ref[2])
        for a, r in zip(ts.feature_dirs(tm, g), js.feature_dirs(jm, g)):
            np.testing.assert_allclose(a, r, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ts._GRID13, js._GRID13)
    np.testing.assert_array_equal(ts._icosphere12(), js._icosphere12())


@pytest.mark.parametrize("feat", [False, True])
def test_sat_pair_random(feat):
    jm, tm, gs = _all_geoms_model()
    rng = np.random.default_rng(7)
    for ga, gb in [(gs[2], gs[3]), (gs[5], gs[2]), (gs[4], gs[5]),
                   (gs[3], gs[3]), (gs[1], gs[4])]:
        Ra, Rb = _rot(rng, B), _rot(rng, B)
        pa = rng.normal(size=(B, 3)) * 0.15
        pb = np.zeros((B, 3))
        fa = js.feature_dirs(jm, ga) if feat else None
        fb = js.feature_dirs(jm, gb) if feat else None

        def ref_one(Ra_, pa_, Rb_, pb_):
            A = js.swept_cloud(jm, ga, Ra_, pa_)
            Bc = js.swept_cloud(jm, gb, Rb_, pb_)
            return js.sat_pair(*A, *Bc, Ra_, Rb_, featA=fa, featB=fb)

        ref = jax.vmap(ref_one)(*[jnp.asarray(x) for x in (Ra, pa, Rb, pb)])
        A = ts.swept_cloud(tm, ga, T(Ra), T(pa))
        Bc = ts.swept_cloud(tm, gb, T(Rb), T(pb))
        got = ts.sat_pair(*A, *Bc, T(Ra), T(Rb),
                          featA=ts.feature_dirs(tm, ga) if feat else None,
                          featB=ts.feature_dirs(tm, gb) if feat else None)
        close_manifold(got, ref)


def test_collide_support_pair_every_sat_pair():
    jm, tm, gs = _all_geoms_model()
    rng = np.random.default_rng(8)
    for ga, gb in jm.self_pairs:
        Ra, Rb = _rot(rng, B), _rot(rng, B)
        pa, pb = rng.normal(size=(B, 3)) * 0.15, np.zeros((B, 3))
        ref = jax.vmap(
            lambda a, b_, c, d: js.collide_support_pair(jm, ga, gb, a, b_,
                                                        c, d))(
            *[jnp.asarray(x) for x in (Ra, pa, Rb, pb)])
        got = ts.collide_support_pair(tm, ga, gb, T(Ra), T(pa), T(Rb), T(pb))
        close_manifold(got, ref)


def _Rx(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _Rz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def test_sat_edge_edge_and_rim_rim():
    """The JAX tests' exact-MTV cases: two box clouds crossing edge on
    edge, and two tilted cylinders rim on rim (with the feature axes)."""
    corners = np.array([[sx, sy, sz] for sx in (-1, 1)
                        for sy in (-1, 1) for sz in (-1, 1)], float)
    RA = _Rx(0.2) @ _Rz(0.15)
    pA = np.array([0.5, 0.0, 0.5]) + 0.12 * np.array([1, 0, 1]) / np.sqrt(2)
    ptsA, ptsB = pA + (corners * 0.1) @ RA.T, corners * 0.5
    one = np.ones(8)
    ref = js.sat_pair(jnp.asarray(ptsA), jnp.zeros(()), jnp.asarray(one),
                      jnp.asarray(ptsB), jnp.zeros(()), jnp.asarray(one),
                      jnp.asarray(RA), jnp.eye(3, dtype=jnp.float64))
    got = ts.sat_pair(T(ptsA)[None], T(0.0), T(one), T(ptsB)[None], T(0.0),
                      T(one), T(RA)[None], T(np.eye(3))[None])
    close_manifold([N(g)[0] for g in got], ref)

    b = JBuilder(dt=0.002)
    b.add_body("a", None, jsm.WELD, mass=1.0)
    g0 = b.add_geom("a", jsm.GEOM_CYLINDER, (0.3, 0.5))
    b.add_body("c", "a", jsm.TRANSLATIONAL, mass=1.0)
    g1 = b.add_geom("c", jsm.GEOM_CYLINDER, (0.3, 0.5))
    b.add_self_pair(g1, g0)
    jm = b.finalize(dtype=jnp.float64)
    tm = port_model(jm)
    RA, pA = _Rx(0.7) @ _Rz(0.4), np.array([0.25, 0.72, 0.1])
    ref = js.collide_support_pair(jm, g1, g0, jnp.asarray(RA),
                                  jnp.asarray(pA), jnp.eye(3,
                                                           dtype=jnp.float64),
                                  jnp.zeros(3))
    got = ts.collide_support_pair(tm, g1, g0, T(RA)[None], T(pA)[None],
                                  T(np.eye(3))[None], T(np.zeros((1, 3))))
    close_manifold([N(g)[0] for g in got], ref)
    assert float(N(got[2])[0, 0]) > 0.02          # rims penetrate

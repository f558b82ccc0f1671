"""PyTorch port, collision/primitives.py vs the JAX package's on the same
numpy inputs (float64, CPU): every primitive pair function on a batch of
random poses (the JAX function vmapped over it), slot by slot, within
1e-12 (relative above 1); plus the axis-aligned stack and the 45-degree
edge of the JAX collision-matrix scenes, where the manifold order rests
on ties."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dartenv_tpu.collision import primitives as jp
from dartenv_tpu_torch.collision import primitives as tp
from torch_port_util import N, T

TOL = 1e-12
B = 16


def _rot(rng, n):
    """n random rotation matrices (numpy)."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], 1)


def _close(got, ref, tol=TOL):
    got, ref = N(got), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    # absolute below 1, relative above (clipped points can be far out)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=tol, atol=tol)


def test_safe_unit_and_closest_on_box():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(B, 3))
    v[:3] = 0.0                              # the fallback branch
    fb = rng.normal(size=(B, 3))
    _close(tp._safe_unit(T(v), T(fb)),
           jax.vmap(jp._safe_unit)(jnp.asarray(v), jnp.asarray(fb)))
    h = np.array([0.3, 0.2, 0.4])
    c = rng.uniform(-0.6, 0.6, size=(B, 3))  # inside and outside the box
    c[:4] = rng.uniform(-0.15, 0.15, size=(4, 3))
    got = tp._closest_on_box(T(c), T(h))
    ref = jax.vmap(lambda ci: jp._closest_on_box(ci, jnp.asarray(h)))(
        jnp.asarray(c))
    for g, r in zip(got, ref):
        _close(g, r)


def test_cylinder_and_ellipsoid_halfspace():
    rng = np.random.default_rng(1)
    R, p = _rot(rng, B), rng.normal(size=(B, 3)) * 0.3
    R[0] = np.eye(3)[[0, 2, 1]] * [1, 1, -1]   # axis along the normal
    n = np.array([0.0, 1.0, 0.0])
    got = tp.cylinder_halfspace(T(p), T(R), T(0.3), T(0.5), T(n), 0.05)
    ref = jax.vmap(lambda pi, Ri: jp.cylinder_halfspace(
        pi, Ri, 0.3, 0.5, jnp.asarray(n), 0.05))(jnp.asarray(p),
                                                 jnp.asarray(R))
    for g, r in zip(got, ref):
        _close(g, r)
    radii = np.array([0.1, 0.3, 0.2])
    got = tp.ellipsoid_halfspace(T(p), T(R), T(radii), T(n), 0.05)
    ref = jax.vmap(lambda pi, Ri: jp.ellipsoid_halfspace(
        pi, Ri, jnp.asarray(radii), jnp.asarray(n), 0.05))(
        jnp.asarray(p), jnp.asarray(R))
    for g, r in zip(got, ref):
        _close(g, r)


def test_sphere_and_capsule_box():
    rng = np.random.default_rng(2)
    Rb, pb = _rot(rng, B), rng.normal(size=(B, 3)) * 0.1
    hb = np.array([0.3, 0.2, 0.25])
    c = pb + rng.normal(size=(B, 3)) * 0.25
    got = tp.sphere_box(T(c), T(0.12), T(Rb), T(pb), T(hb))
    ref = jax.vmap(lambda ci, Ri, pi: jp.sphere_box(
        ci, 0.12, Ri, pi, jnp.asarray(hb)))(jnp.asarray(c), jnp.asarray(Rb),
                                            jnp.asarray(pb))
    for g, r in zip(got, ref):
        _close(g, r)
    uc = _rot(rng, B)[:, :, 2]
    got = tp.capsule_box(T(c), T(uc), T(0.25), T(0.08), T(Rb), T(pb), T(hb))
    ref = jax.jit(jax.vmap(lambda ci, ui, Ri, pi: jp.capsule_box(
        ci, ui, 0.25, 0.08, Ri, pi, jnp.asarray(hb))))(
        jnp.asarray(c), jnp.asarray(uc), jnp.asarray(Rb), jnp.asarray(pb))
    for g, r in zip(got, ref):
        _close(g, r)


_box_box = jax.jit(jax.vmap(jp.box_box))


@pytest.mark.parametrize("case", ["random", "stack", "edge45", "offset"])
def test_box_box(case):
    rng = np.random.default_rng(3)
    ha = np.tile([0.15, 0.1, 0.15], (B, 1))
    hb = np.tile([0.5, 0.2, 0.5], (B, 1))
    Rb, pb = np.tile(np.eye(3), (B, 1, 1)), np.zeros((B, 3))
    if case == "random":
        Ra, Rb = _rot(rng, B), _rot(rng, B)
        pb = rng.normal(size=(B, 3)) * 0.05
        d = rng.normal(size=(B, 3))
        pa = pb + 0.45 * d / np.linalg.norm(d, axis=1, keepdims=True)
    elif case == "stack":                      # face on face, exact ties
        Ra = np.tile(np.eye(3), (B, 1, 1))
        pa = np.stack([np.zeros(B), 0.3 - np.linspace(0, 0.02, B),
                       np.zeros(B)], 1)
    elif case == "offset":                     # hangs over the edge
        Ra = np.tile(np.eye(3), (B, 1, 1))
        pa = np.stack([np.linspace(0.3, 0.6, B), np.full(B, 0.295),
                       np.zeros(B)], 1)
    else:                                      # an edge onto the face
        th = np.pi / 4
        Ra = np.tile(np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                               [0, np.sin(th), np.cos(th)]]), (B, 1, 1))
        ha = np.tile([0.15, 0.15, 0.15], (B, 1))
        pa = np.stack([np.zeros(B),
                       0.2 + 0.15 * np.sqrt(2) - np.linspace(0, 0.02, B),
                       np.zeros(B)], 1)
    got = tp.box_box(T(Ra), T(pa), T(ha), T(Rb), T(pb), T(hb))
    ref = _box_box(*[jnp.asarray(x) for x in (Ra, pa, ha, Rb, pb, hb)])
    for g, r in zip(got, ref):
        _close(g, r)
    assert (N(got[2]) > 0).any()                # contacts, not vacuous


def test_face_clip():
    rng = np.random.default_rng(4)
    Rr, Ri = _rot(rng, B), _rot(rng, B)
    pr = np.zeros((B, 3))
    pi = rng.normal(size=(B, 3)) * 0.2
    hr, hi = np.array([0.4, 0.3, 0.35]), np.array([0.2, 0.25, 0.15])
    sgn = np.sign(rng.normal(size=B))
    for k in range(3):
        got = tp._face_clip(T(Rr), T(pr), T(hr), k, T(sgn), T(Ri), T(pi),
                            T(hi))
        ref = jax.vmap(lambda a, b_, s, c, d: jp._face_clip(
            a, b_, jnp.asarray(hr), k, s, c, d, jnp.asarray(hi),
            jnp.float64))(*[jnp.asarray(x) for x in (Rr, pr, sgn, Ri, pi)])
        for g, r in zip(got, ref):
            _close(g, r)

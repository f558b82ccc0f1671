"""PyTorch port, the rest of math/spatial.py against the JAX package's on
the CPU in float64: quaternions, so3_log and mat_to_quat (each of its four
branches, the identity and rotations by pi and near it), rigid transforms
and the inverse-motion / force transforms, at 1e-12."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu.math import spatial as J
from dartenv_tpu_torch.math import spatial as P

TOL = 1e-12


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()))


def _unit(rng, k):
    v = rng.standard_normal((k, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _quats(rng, k):
    q = rng.standard_normal((k, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


T = lambda x: torch.tensor(np.array(x), dtype=torch.float64)


def test_quaternions():
    rng = np.random.default_rng(0)
    q, v = _quats(rng, 16), rng.standard_normal((16, 3))
    raw = rng.standard_normal((16, 4)) * 3.0
    ax, ang = _unit(rng, 16), rng.uniform(-4, 4, 16)
    assert torch.equal(P.quat_identity(torch.float64),
                       T(J.quat_identity(jnp.float64)))
    _close(P.quat_conj(T(q)), J.quat_conj(jnp.asarray(q)))
    _close(P.quat_normalize(T(raw)), J.quat_normalize(jnp.asarray(raw)))
    _close(P.quat_rotate(T(q), T(v)), J.quat_rotate(jnp.asarray(q),
                                                     jnp.asarray(v)))
    _close(P.quat_to_mat(T(q)), J.quat_to_mat(jnp.asarray(q)))
    _close(P.quat_from_axis_angle(T(ax), T(ang)),
           J.quat_from_axis_angle(jnp.asarray(ax), jnp.asarray(ang)))


def _rotations(rng):
    """Random rotations, the identity, and rotations whose largest of
    (trace, m00, m11, m22) selects each branch of mat_to_quat."""
    w = _unit(rng, 12) * rng.uniform(0.0, 3.0, (12, 1))
    w = np.concatenate([w, np.zeros((1, 3)),
                        # angle near pi about x, y, z: m00, m11, m22 largest
                        np.eye(3) * (np.pi - 1e-3),
                        np.eye(3) * 2.5, np.eye(3) * -2.9])
    return np.asarray(J.so3_exp(jnp.asarray(w)))


def test_mat_to_quat_every_branch_and_so3_log():
    R = _rotations(np.random.default_rng(1))
    tr = np.trace(R, axis1=1, axis2=2)
    d = np.diagonal(R, axis1=1, axis2=2)
    best = np.argmax(np.concatenate([tr[:, None], d], axis=1), axis=1)
    assert set(best) == {0, 1, 2, 3}
    _close(P.mat_to_quat(T(R)), J.mat_to_quat(jnp.asarray(R)))
    _close(P.so3_log(T(R)), J.so3_log(jnp.asarray(R)))
    # the identity: an exact zero rotation vector in both
    assert torch.equal(P.so3_log(torch.eye(3, dtype=torch.float64)),
                       torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("eps", [0.0, 1e-12, 1e-9, 1e-6])
def test_so3_log_at_and_near_pi(eps):
    """At angle pi the log is +-pi axis: the sign of the quaternion's w,
    a rounding of zero, picks the branch.  The port computes w in the same
    operations, so it takes the same branch; at and near pi the rotation
    vector agrees at 1e-12 and maps back onto R."""
    rng = np.random.default_rng(2)
    ax = np.concatenate([np.eye(3), _unit(rng, 5)])
    R = np.asarray(J.so3_exp(jnp.asarray(ax * (np.pi - eps))))
    got = P.so3_log(T(R))
    _close(got, J.so3_log(jnp.asarray(R)))
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1),
                               np.pi - eps, atol=1e-7)
    _close(P.so3_exp(got), R, tol=1e-7)


def test_transforms():
    rng = np.random.default_rng(3)
    Ra, Rb = _rotations(rng)[:12], _rotations(rng)[:12]
    pa, pb, x = (rng.standard_normal((12, 3)) for _ in range(3))
    v, f = rng.standard_normal((12, 6)), rng.standard_normal((12, 6))
    for got, ref in zip(P.t_compose(T(Ra), T(pa), T(Rb), T(pb)),
                        J.t_compose(*map(jnp.asarray, (Ra, pa, Rb, pb)))):
        _close(got, ref)
    for got, ref in zip(P.t_inv(T(Ra), T(pa)),
                        J.t_inv(jnp.asarray(Ra), jnp.asarray(pa))):
        _close(got, ref)
    _close(P.t_apply(T(Ra), T(pa), T(x)),
           J.t_apply(*map(jnp.asarray, (Ra, pa, x))))
    _close(P.xmotion_inv_apply(T(Ra), T(pa), T(v)),
           J.xmotion_inv_apply(*map(jnp.asarray, (Ra, pa, v))))
    _close(P.xforce_apply(T(Ra), T(pa), T(f)),
           J.xforce_apply(*map(jnp.asarray, (Ra, pa, f))))
    _close(P.xforce_mat(T(Ra), T(pa)),
           J.xforce_mat(jnp.asarray(Ra), jnp.asarray(pa)))
    # the inverse motion transform undoes the motion transform
    _close(P.xmotion_inv_apply(T(Ra), T(pa),
                               P.xmotion_apply(T(Ra), T(pa), T(v))), v)

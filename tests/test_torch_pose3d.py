"""Rotation3/Pose3d and the quaternion functions of the port against the JAX
package, on CPU: test_pose3d.py's three cases on the port, then parity of
every quaternion function and of Pose3d composition and inverse at 1e-6.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from visual_odometry_ros_tpu.utils import geometry as JG  # noqa: E402
from visual_odometry_ros_tpu.utils import pose3d as JP  # noqa: E402
from visual_odometry_ros_tpu_torch.utils import geometry as TG  # noqa: E402
from visual_odometry_ros_tpu_torch.utils.pose3d import Pose3d, Rotation3  # noqa: E402

# Both sides evaluate the same float32 formulas in another operation order:
# a few ulps of values of order 1.
TOL = 1e-6


def test_rotation_drift_stays_normalized():
    dq = Rotation3.from_rotvec(np.array([1e-4, -2e-4, 3e-4], np.float32))
    r = Rotation3()
    for _ in range(10_000):
        r = r * dq
    R = r.R.numpy()
    assert abs(np.linalg.det(R) - 1.0) < 1e-5
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert abs(float(torch.linalg.norm(r.q)) - 1.0) < 1e-6


def test_pose_compose_matches_matrix(rng):
    xa = rng.normal(0, 0.5, 6).astype(np.float32)
    xb = rng.normal(0, 0.5, 6).astype(np.float32)
    A, B = Pose3d.from_se3(xa), Pose3d.from_se3(xb)
    expect = (TG.se3_exp(torch.as_tensor(xa)) @ TG.se3_exp(torch.as_tensor(xb))).numpy()
    np.testing.assert_allclose((A * B).T.numpy(), expect, atol=1e-5)


def test_pose_inverse_and_point_map(rng):
    x = rng.normal(0, 0.5, 6).astype(np.float32)
    P = Pose3d.from_se3(x)
    p = rng.normal(0, 2.0, 3).astype(np.float32)
    np.testing.assert_allclose((P.inverse() * (P * p)).numpy(), p, atol=1e-5)
    np.testing.assert_allclose((P * P.inverse()).T.numpy(), np.eye(4), atol=1e-5)


def _rotations(rng):
    """Random rotations plus the cases where Shepperd's method branches:
    trace <= 0 with each diagonal term the largest, rotations by pi about
    each axis and a diagonal axis, ties between diagonal terms, identity."""
    rv = rng.normal(0, 1.5, (24, 3)).astype(np.float32)
    special = [[np.pi, 0, 0], [0, np.pi, 0], [0, 0, np.pi], [np.pi / np.sqrt(2), np.pi / np.sqrt(2), 0],
               [2.9, 0.1, 0.0], [0.1, 2.9, 0.0], [0.0, 0.1, 2.9], [0, 0, 0], [2.0, 2.0, 2.0 - 1e-3]]
    R = TG.so3_exp(torch.as_tensor(np.concatenate([rv, np.float32(special)])))
    # Exact ties: diag(1, -1, -1), diag(-1, 1, -1), diag(-1, -1, 1) and
    # (m00 = m11 > m22) with trace 0 from a pi/2 turn about z composed with x.
    exact = np.stack([np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0]),
                      np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]),
                      np.array([[-1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, -1.0, 0.0]])]).astype(np.float32)
    return np.concatenate([R.numpy(), exact])


def _sign_canonical(q):
    """q and -q are one rotation: flip to w > 0, or to the first nonzero
    component positive when w = 0."""
    q = np.array(q, np.float64)
    for row in q:
        lead = row[np.flatnonzero(np.abs(row) > 1e-7)[0]]
        row *= np.sign(lead)
    return q


def test_rotation_to_quat_matches_jax_branch_for_branch(rng):
    R = _rotations(rng)
    qt = TG.rotation_to_quat(torch.as_tensor(R)).numpy()
    qj = np.asarray(JG.rotation_to_quat(jnp.asarray(R)))
    # Same branch, same canonical sign: equal component by component.
    np.testing.assert_allclose(qt, qj, atol=TOL)
    # Round trip through the matrix, compared sign-invariantly.
    back = TG.rotation_to_quat(TG.quat_to_rotation(torch.as_tensor(qt))).numpy()
    np.testing.assert_allclose(_sign_canonical(back), _sign_canonical(qt), atol=1e-5)
    np.testing.assert_allclose(TG.quat_to_rotation(torch.as_tensor(qt)).numpy(), R, atol=1e-5)


@pytest.mark.parametrize("name", ["quat_multiply", "quat_conjugate", "quat_normalize", "quat_to_rotation",
                                  "rotvec_to_quat", "quat_to_rotvec"])
def test_quaternion_functions_match_jax(rng, name):
    q1 = rng.normal(0, 1, (32, 4)).astype(np.float32)
    q2 = rng.normal(0, 1, (32, 4)).astype(np.float32)
    rv = np.concatenate([rng.normal(0, 1, (30, 3)), [[0, 0, 0], [1e-7, -2e-7, 0]]]).astype(np.float32)
    if name == "quat_to_rotvec":  # so3_log is safe on [0, pi): keep away from pi
        q1 = q1 * np.float32([4.0, 1.0, 1.0, 1.0])
    args = {"quat_multiply": (q1, q2), "rotvec_to_quat": (rv,)}.get(name, (q1,))
    t = getattr(TG, name)(*(torch.as_tensor(a) for a in args)).numpy()
    j = np.asarray(getattr(JG, name)(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(t, j, atol=TOL * (10 if name == "quat_to_rotvec" else 1))


def test_pose3d_compose_inverse_and_map_match_jax(rng):
    xs = rng.normal(0, 0.5, (3, 6)).astype(np.float32)
    pts = rng.normal(0, 2.0, (5, 3)).astype(np.float32)
    tA, tB, tC = (Pose3d.from_se3(x) for x in xs)
    jA, jB, jC = (JP.Pose3d.from_se3(x) for x in xs)
    for t, j in (((tA * tB) * tC, (jA * jB) * jC), (tA.inverse(), jA.inverse()), (tB * tA.inverse(), jB * jA.inverse())):
        np.testing.assert_allclose(t.rot.q.numpy(), np.asarray(j.rot.q), atol=TOL)
        np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=1e-5)  # translations of order 1-2 m
        np.testing.assert_allclose(t.T.numpy(), np.asarray(j.T), atol=1e-5)
    np.testing.assert_allclose((tA * pts).numpy(), np.asarray(jA * pts), atol=1e-5)
    R = rng.normal(0, 1, 3).astype(np.float32)
    np.testing.assert_allclose(Rotation3.from_rotvec(R).R.numpy(), np.asarray(JP.Rotation3.from_rotvec(R).R), atol=TOL)
    Rm = TG.so3_exp(torch.as_tensor(R)).numpy()
    np.testing.assert_allclose(Rotation3.from_matrix(Rm).q.numpy(), np.asarray(JP.Rotation3.from_matrix(Rm).q),
                               atol=TOL)


def test_pose3d_device_follows_inputs_or_is_explicit():
    t = torch.zeros(3)
    P = Pose3d(Rotation3(torch.tensor([1.0, 0.0, 0.0, 0.0])), t)
    assert P.t.device == P.rot.device == t.device and P.t.dtype == torch.float32
    assert Pose3d().T.shape == (4, 4) and Pose3d(device="cpu").rot.device.type == "cpu"
    Q = Pose3d.from_matrix(np.eye(4), device="cpu")
    assert Q.rot.q.dtype == torch.float32
    np.testing.assert_array_equal((Q * np.ones(3, np.float32)).numpy(), np.ones(3, np.float32))

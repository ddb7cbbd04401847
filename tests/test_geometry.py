import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from vloam.geometry import Pose, so3


def random_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quat_multiply_and_rotate_match_scipy(rng):
    qa, qb = random_quats(rng, 64), random_quats(rng, 64)
    got = np.asarray(so3.quat_multiply(jnp.asarray(qa), jnp.asarray(qb)))
    want = (Rotation.from_quat(qa) * Rotation.from_quat(qb)).as_quat()
    sign = np.sign(np.sum(got * want, axis=-1, keepdims=True))
    np.testing.assert_allclose(got, want * sign, atol=1e-5)

    v = rng.normal(size=(64, 3))
    got_v = np.asarray(so3.quat_rotate(jnp.asarray(qa), jnp.asarray(v)))
    np.testing.assert_allclose(got_v, Rotation.from_quat(qa).apply(v), atol=1e-5)


def test_axis_angle_round_trip(rng):
    w = rng.normal(size=(128, 3)) * 2.0
    q = so3.quat_from_axis_angle(jnp.asarray(w, jnp.float64))
    want = Rotation.from_rotvec(w).as_quat()
    got = np.asarray(q)
    sign = np.sign(np.sum(got * want, axis=-1, keepdims=True))
    np.testing.assert_allclose(got, want * sign, atol=1e-6)
    back = np.asarray(so3.axis_angle_from_quat(q))
    np.testing.assert_allclose(Rotation.from_rotvec(back).as_matrix(),
                               Rotation.from_rotvec(w).as_matrix(), atol=1e-6)


def test_axis_angle_tiny_angles():
    w = jnp.asarray([[1e-10, 0, 0], [0.0, 0.0, 0.0]])
    q = so3.quat_from_axis_angle(w)
    np.testing.assert_allclose(np.asarray(q[:, 3]), 1.0, atol=1e-9)
    v = jnp.asarray([[1.0, 2.0, 3.0]] * 2)
    np.testing.assert_allclose(np.asarray(so3.rotate_axis_angle(w, v)), np.asarray(v), atol=1e-6)


def test_rotate_axis_angle_matches_scipy(rng):
    w = rng.normal(size=(64, 3))
    v = rng.normal(size=(64, 3))
    got = np.asarray(so3.rotate_axis_angle(jnp.asarray(w), jnp.asarray(v)))
    want = Rotation.from_rotvec(w).apply(v)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_matrix_round_trip(rng):
    q = random_quats(rng, 100)
    m = so3.quat_to_matrix(jnp.asarray(q))
    np.testing.assert_allclose(np.asarray(m), Rotation.from_quat(q).as_matrix(), atol=1e-6)
    q2 = np.asarray(so3.quat_from_matrix(m))
    sign = np.sign(np.sum(q2 * q, axis=-1, keepdims=True))
    np.testing.assert_allclose(q2, q * sign, atol=1e-5)


def test_slerp_identity_matches_scipy(rng):
    q = random_quats(rng, 32)
    s = 0.37
    got = np.asarray(so3.quat_slerp_identity(jnp.asarray(q, jnp.float64), s))
    key = Rotation.from_quat(q)
    want = Rotation.from_rotvec(key.as_rotvec() * s).as_quat()
    sign = np.sign(np.sum(got * want, axis=-1, keepdims=True))
    np.testing.assert_allclose(got, want * sign, atol=1e-6)


def test_pose_compose_inverse_apply(rng):
    qa, qb = random_quats(rng, 16), random_quats(rng, 16)
    ta, tb = rng.normal(size=(16, 3)), rng.normal(size=(16, 3))
    A = Pose(jnp.asarray(qa), jnp.asarray(ta))
    B = Pose(jnp.asarray(qb), jnp.asarray(tb))
    pts = rng.normal(size=(16, 3))

    ab = A.compose(B)
    want = Rotation.from_quat(qa).apply(Rotation.from_quat(qb).apply(pts) + tb) + ta
    np.testing.assert_allclose(np.asarray(ab.apply(jnp.asarray(pts))), want, atol=1e-5)

    ident = A.compose(A.inverse())
    np.testing.assert_allclose(np.asarray(ident.t), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.abs(np.asarray(ident.q[:, 3])), 1.0, atol=1e-5)


def test_pose_matrix_round_trip(rng):
    q = random_quats(rng, 8)
    t = rng.normal(size=(8, 3))
    P = Pose(jnp.asarray(q), jnp.asarray(t))
    M = np.asarray(P.matrix())
    P2 = Pose.from_matrix(jnp.asarray(M))
    pts = jnp.asarray(rng.normal(size=(8, 3)))
    np.testing.assert_allclose(np.asarray(P.apply(pts)), np.asarray(P2.apply(pts)), atol=1e-5)

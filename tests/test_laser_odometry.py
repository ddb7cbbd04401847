import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation as R

from vloam.config import LidarProfile, ScanRegistrationConfig, LaserOdometryConfig
from vloam.data import synthetic
from vloam.lidar import scan_registration as sr
from vloam.lidar.odometry import LaserOdometry

PROFILE = LidarProfile(name="t64", n_scans=64, minimum_range=2.0,
                       max_points=65536, ring_capacity=1024)
SR_CFG = ScanRegistrationConfig(sharp_cap=1024, less_sharp_cap=8192,
                                flat_cap=2048, less_flat_cap=16384)


def extract(scene, T, n_az=900, seed=0):
    pts = synthetic.simulate_scan(scene, T, n_scans=64, n_azimuth=n_az,
                                  noise=0.01, seed=seed)
    padded, n = synthetic.pad_scan(pts, PROFILE.max_points)
    return sr.register_scan(jnp.asarray(padded), jnp.int32(n), PROFILE, SR_CFG)


def test_lo_recovers_motion_two_frames():
    scene = synthetic.urban_scene(7)
    poses = synthetic.drive_trajectory(2, speed=1.2, yaw_rate=0.02)
    lo = LaserOdometry(LaserOdometryConfig())
    f0 = extract(scene, poses[0], seed=0)
    f1 = extract(scene, poses[1], seed=1)
    lo.step(f0)
    out = lo.step(f1)
    # ground truth f2f: T_last_curr maps current-frame points into last frame
    gt = np.linalg.inv(poses[0]) @ poses[1]
    got_t = out["t_f2f"]
    got_R = R.from_quat(out["q_f2f"]).as_matrix()
    np.testing.assert_allclose(got_t, gt[:3, 3], atol=0.06)
    rot_err = R.from_matrix(got_R.T @ gt[:3, :3]).magnitude()
    assert rot_err < 0.01, rot_err


def test_lo_sequence_accumulates_world_pose():
    scene = synthetic.urban_scene(11)
    n = 5
    poses = synthetic.drive_trajectory(n, speed=1.0, yaw_rate=0.015)
    lo = LaserOdometry(LaserOdometryConfig())
    for k in range(n):
        feats = extract(scene, poses[k], seed=k)
        out = lo.step(feats)
    gt = poses[-1]
    t_err = np.linalg.norm(out["t_w"] - gt[:3, 3])
    assert t_err < 0.25, t_err
    rot_err = R.from_matrix(
        R.from_quat(out["q_w"]).as_matrix().T @ gt[:3, :3]
    ).magnitude()
    assert rot_err < 0.02, rot_err


def test_lo_uses_prior_seed():
    """With a perfect prior the solve should stay at/near the prior."""
    scene = synthetic.urban_scene(3)
    poses = synthetic.drive_trajectory(2, speed=1.0, yaw_rate=0.0)
    lo = LaserOdometry(LaserOdometryConfig())
    lo.step(extract(scene, poses[0], seed=0))
    gt = np.linalg.inv(poses[0]) @ poses[1]
    q_prior = R.from_matrix(gt[:3, :3]).as_quat()
    out = lo.step(extract(scene, poses[1], seed=1), prior_q=q_prior, prior_t=gt[:3, 3])
    np.testing.assert_allclose(out["t_f2f"], gt[:3, 3], atol=0.05)

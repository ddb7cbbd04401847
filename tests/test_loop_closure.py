import numpy as np
from scipy.spatial.transform import Rotation as R

from vloam.backend.loop_closure import close_loops, find_loop_candidates
from vloam.data import synthetic

from test_pipeline import small_cfg


def test_find_loop_candidates_basic():
    t = np.zeros((100, 3))
    t[:, 0] = np.concatenate([np.arange(50), np.arange(50)[::-1]])  # out & back
    cands = find_loop_candidates(t, radius=2.0, min_gap=20, max_candidates=5)
    assert cands
    for i, j in cands:
        assert i - j > 20
        assert abs(t[i, 0] - t[j, 0]) < 2.0


def test_loop_closure_reduces_injected_drift():
    cfg = small_cfg()
    scene = synthetic.urban_scene(13)
    n = 24
    # drive a loop: forward then arc back to the start area
    poses = []
    T = np.eye(4)
    for k in range(n):
        poses.append(T.copy())
        yaw = 2 * np.pi / n
        c, s = np.cos(yaw), np.sin(yaw)
        dT = np.eye(4)
        dT[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        dT[0, 3] = 2.0
        T = T @ dT
    scans = {}

    def get_scan(k):
        if k not in scans:
            pts = synthetic.simulate_scan(scene, poses[k], n_scans=64,
                                          n_azimuth=900, seed=k)
            scans[k] = synthetic.pad_scan(pts, cfg.lidar.max_points)
        return scans[k]

    # ground-truth trajectory + injected linear drift
    gt_q = np.stack([R.from_matrix(p[:3, :3]).as_quat() for p in poses])
    gt_t = np.stack([p[:3, 3] for p in poses])
    drift = np.linspace(0, 1.0, n)[:, None] * np.array([1.0, 0.6, 0.0])
    bad_t = gt_t + drift

    out = close_loops(gt_q, bad_t, get_scan, cfg, radius=12.0, min_gap=10,
                      max_candidates=4, min_correspondences=50)
    assert out["loops"], "no loop closures found"
    opt_t = out["poses"][:, 4:]
    err_before = np.linalg.norm(bad_t - gt_t, axis=1).mean()
    err_after = np.linalg.norm(opt_t - gt_t, axis=1).mean()
    assert err_after < 0.6 * err_before, (err_before, err_after)

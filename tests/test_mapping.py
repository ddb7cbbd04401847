import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation as R

from vloam.config import (LaserMappingConfig, LaserOdometryConfig,
                              LidarProfile, ScanRegistrationConfig)
from vloam.data import synthetic
from vloam.lidar import scan_registration as sr
from vloam.lidar.gridmap import (SENTINEL, grid_create, grid_evict,
                                     grid_insert, grid_knn)
from vloam.lidar.mapping import LaserMapping, _cube_coord
from vloam.lidar.odometry import LaserOdometry

PROFILE = LidarProfile(name="t64", n_scans=64, minimum_range=2.0,
                       max_points=65536, ring_capacity=1024)
SR_CFG = ScanRegistrationConfig(sharp_cap=1024, less_sharp_cap=8192,
                                flat_cap=2048, less_flat_cap=16384)
MAP_CFG = LaserMappingConfig(cube_width=11, cube_height=11, cube_depth=5,
                             map_n_buckets=1 << 14,
                             corner_bucket_cap=16, surf_bucket_cap=16,
                             corner_stack_cap=2048, surf_stack_cap=4096)


def extract(scene, T, n_az=900, seed=0):
    pts = synthetic.simulate_scan(scene, T, n_scans=64, n_azimuth=n_az,
                                  noise=0.01, seed=seed)
    padded, n = synthetic.pad_scan(pts, PROFILE.max_points)
    return sr.register_scan(jnp.asarray(padded), jnp.int32(n), PROFILE, SR_CFG)


def test_cube_coord_matches_reference_semantics():
    # int((x+25)/50) with negative correction == floor
    pts = jnp.asarray([[0.0, 0, 0], [24.9, 0, 0], [25.1, 0, 0],
                       [-25.1, 0, 0], [-24.9, 0, 0], [75.0, 0, 0]])
    c = np.asarray(_cube_coord(pts, 50.0))
    np.testing.assert_array_equal(c[:, 0], [0, 0, 1, -1, 0, 2])


def test_grid_insert_dedups_by_voxel():
    g = grid_create(1 << 12, 8)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-20, 20, (256, 3)).astype(np.float32)
    g = grid_insert(g, jnp.asarray(pts), jnp.ones(256, bool), 2.0, 0.4)
    n1 = int(g.n_live)
    assert n1 > 200  # nearly all inserted (random points rarely share voxels)
    # re-inserting the same points must be a no-op (every voxel occupied)
    g2 = grid_insert(g, jnp.asarray(pts), jnp.ones(256, bool), 2.0, 0.4)
    assert int(g2.n_live) == n1
    # a jittered copy within the same voxels is also deduped
    g3 = grid_insert(g, jnp.asarray(pts + 0.01), jnp.ones(256, bool), 2.0, 0.4)
    assert int(g3.n_live) <= n1 + 50  # only boundary-straddlers add


def test_grid_knn_exact_within_radius():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-5, 5, (2000, 3)).astype(np.float32)
    g = grid_create(1 << 12, 32)
    g = grid_insert(g, jnp.asarray(pts), jnp.ones(len(pts), bool), 2.0, 0.05)
    queries = rng.uniform(-4, 4, (128, 3)).astype(np.float32)
    d, near = grid_knn(g, jnp.asarray(queries), 2.0, k=5)
    d = np.asarray(d)
    # brute-force reference
    dd = ((queries[:, None, :] - pts[None]) ** 2).sum(-1)
    ref = np.sort(dd, axis=1)[:, :5]
    # wherever the true k-th neighbor is within radius^2 = 1, exact match
    inside = ref[:, 4] < 1.0
    assert inside.sum() > 20
    np.testing.assert_allclose(d[inside], ref[inside], rtol=1e-4, atol=1e-5)


def test_grid_evict_keeps_box_and_compacts():
    pts = np.array([[0.5, 0.5, 0.5], [30.0, 0, 0], [0, 40.0, 0],
                    [1.5, 1.5, 1.5], [-2.0, 3.0, 0.0]], np.float32)
    g = grid_create(1 << 10, 4)
    g = grid_insert(g, jnp.asarray(pts), jnp.ones(5, bool), 2.0, 0.4)
    g2 = grid_evict(g, jnp.zeros(3), jnp.asarray([10.0, 10.0, 10.0]))
    assert int(g2.n_live) == 3
    cap = g2.cap
    live = np.asarray(g2.pts).reshape(-1, 3, cap).transpose(0, 2, 1).reshape(-1, 3)
    live = live[live[:, 0] < SENTINEL * 0.5]
    assert (np.abs(live) <= 10.0).all()
    # holes left by eviction are refilled by later inserts (no overflow)
    refill = np.array([[0.9, 0.2, 0.1], [28.9, 0.1, 0.2]], np.float32)
    g3 = grid_insert(g2, jnp.asarray(refill), jnp.ones(2, bool), 2.0, 0.4)
    assert int(g3.n_live) == 5
    live3 = np.asarray(g3.pts).reshape(-1, 3, cap).transpose(0, 2, 1).reshape(-1, 3)
    live3 = live3[live3[:, 0] < SENTINEL * 0.5]
    assert len(live3) == 5


def test_mapping_improves_or_tracks_lo():
    """Run LO + mapping over a short drive; the map-refined trajectory must
    stay at least as accurate as raw LO."""
    scene = synthetic.urban_scene(5)
    n = 6
    poses = synthetic.drive_trajectory(n, speed=1.0, yaw_rate=0.02)
    lo = LaserOdometry(LaserOdometryConfig())
    mo = LaserMapping(MAP_CFG)
    mo_err = lo_err = None
    for k in range(n):
        feats = extract(scene, poses[k], seed=k)
        out = lo.step(feats)
        res = mo.step(feats.less_sharp, feats.less_flat,
                      out["q_w"], out["t_w"], skip_frame=False)
        gt = poses[k]
        lo_err = np.linalg.norm(out["t_w"] - gt[:3, 3])
        mo_err = np.linalg.norm(res["t_w"] - gt[:3, 3])
    assert mo.last_stats["n_map_corner"] > 10
    assert mo.last_stats["n_map_surf"] > 50
    assert bool(mo.last_stats["solved"])
    assert mo_err < max(2.0 * lo_err, 0.3), (mo_err, lo_err)
    # the grid map should be populated around the vehicle
    assert int(mo.map.corner.n_live) > 100
    assert int(mo.map.surf.n_live) > 500


def test_mapping_solve_corrects_perturbed_prediction():
    """Feed mapping a deliberately biased odometry pose; the scan-to-map
    solve must pull it back toward ground truth."""
    scene = synthetic.urban_scene(9)
    poses = synthetic.drive_trajectory(3, speed=1.0, yaw_rate=0.0)
    lo = LaserOdometry(LaserOdometryConfig())
    mo = LaserMapping(MAP_CFG)
    for k in range(2):
        feats = extract(scene, poses[k], seed=k)
        out = lo.step(feats)
        mo.step(feats.less_sharp, feats.less_flat, out["q_w"], out["t_w"])
    feats = extract(scene, poses[2], seed=2)
    out = lo.step(feats)
    # bias the odometry input by 0.3 m
    biased_t = np.asarray(out["t_w"]) + np.array([0.3, 0.15, 0.0])
    res = mo.step(feats.less_sharp, feats.less_flat, out["q_w"], biased_t)
    gt = poses[2][:3, 3]
    err_biased = np.linalg.norm(biased_t + mo.t_wmap_wodom * 0 - gt)  # ~0.34
    err_mo = np.linalg.norm(res["t_w"] - gt)
    assert err_mo < 0.5 * err_biased, (err_mo, err_biased)

"""The mapping stage of a REAL sequence executed as distributed BA over an
8-device mesh (parallel/mesh_pipeline.py) must reproduce the single-device
production path (lidar.mapping.solve_mapping) — both one frame at a time
and over a whole drive (VERDICT r3 items 1 and 7)."""

import jax
import jax.numpy as jnp
import numpy as np

from vloam.config import (LaserMappingConfig, LidarProfile,
                              PipelineConfig, ScanRegistrationConfig)
from vloam.data import synthetic
from vloam.lidar.mapping import LaserMapping, solve_mapping
from vloam.lidar.odometry import LaserOdometry
from vloam.lidar.scan_registration import register_scan
from vloam.lidar.voxel import voxel_downsample
from vloam.parallel.mesh_pipeline import (MeshLaserMapping,
                                              mesh_solve_mapping,
                                              run_mesh_drive)
from vloam.parallel.sharded import data_mesh


def mesh_cfg():
    """Lean shapes: the flat-map ring k-NN is O(stacks x map-slots) per
    hop, so the CPU-mesh test keeps the grids small."""
    return PipelineConfig(
        lidar=LidarProfile(name="m32", n_scans=32, minimum_range=2.0,
                           max_points=32768, ring_capacity=1024),
        scanreg=ScanRegistrationConfig(sharp_cap=512, less_sharp_cap=4096,
                                       flat_cap=1024, less_flat_cap=8192),
        mapping=LaserMappingConfig(cube_width=11, cube_height=11,
                                   cube_depth=5, map_n_buckets=1 << 12,
                                   corner_bucket_cap=8, surf_bucket_cap=8,
                                   corner_stack_cap=1024,
                                   surf_stack_cap=2048),
    )


def _scan_frames(cfg, n_frames, seed=7):
    scene = synthetic.urban_scene(seed)
    poses = synthetic.drive_trajectory(n_frames, speed=1.2, yaw_rate=0.02)
    return [
        synthetic.simulate_scan(scene, T, n_scans=cfg.lidar.n_scans,
                                n_azimuth=600, seed=seed * 100 + k)
        for k, T in enumerate(poses)
    ]


def _run_single_device(cfg, scans):
    """The production single-device loop (scanreg + LO + LaserMapping)."""
    lo = LaserOdometry(cfg.lo)
    mo = LaserMapping(cfg.mapping)
    t_mo = []
    for pts in scans:
        padded, n = synthetic.pad_scan(pts, cfg.lidar.max_points)
        feats = register_scan(jnp.asarray(padded), jnp.int32(n), cfg.lidar,
                              cfg.scanreg)
        lo_out = lo.step(feats)
        mo_out = mo.step(feats.less_sharp, feats.less_flat,
                         lo_out["q_w"], lo_out["t_w"],
                         skip_frame=lo_out["skip_frame"])
        t_mo.append(np.asarray(mo_out["t_w"]))
    return np.stack(t_mo), mo


def test_mesh_drive_matches_single_device():
    """A synthetic drive whose mapping stage runs through
    sharded_map_alignment on the 8-device mesh matches the single-device
    solve_mapping trajectory to <= 1 cm ATE (VERDICT r3 item 1)."""
    cfg = mesh_cfg()
    scans = _scan_frames(cfg, 8)
    t_single, _ = _run_single_device(cfg, scans)
    res = run_mesh_drive(cfg, scans, data_mesh())
    t_mesh = res["t_w_mo"]
    assert np.isfinite(t_mesh).all()
    # real motion happened (the comparison is not vacuous)
    assert np.linalg.norm(t_single[-1] - t_single[0]) > 1.0
    ate = np.sqrt(np.mean(np.sum((t_mesh - t_single) ** 2, axis=-1)))
    assert ate <= 0.01, f"mesh vs single-device MO ATE {ate:.4f} m"


def test_mesh_solve_matches_solve_mapping_on_real_frame():
    """One mid-drive frame's REAL voxel-downsampled stacks + accumulated
    grid map: sharded_map_alignment (1-device and 8-device mesh) agrees
    with the production solve_mapping pose (VERDICT r3 item 7)."""
    cfg = mesh_cfg()
    scans = _scan_frames(cfg, 6, seed=11)
    # build a real map + bookkeeping by running the production path
    _, mo = _run_single_device(cfg, scans[:-1])
    # prepare the last frame exactly as LaserMapping.step does
    lo = LaserOdometry(cfg.lo)
    for pts in scans:  # replay LO to get the frame's odom pose
        padded, n = synthetic.pad_scan(pts, cfg.lidar.max_points)
        feats = register_scan(jnp.asarray(padded), jnp.int32(n), cfg.lidar,
                              cfg.scanreg)
        lo_out = lo.step(feats)
    from scipy.spatial.transform import Rotation as R

    q_pred = (R.from_quat(mo.q_wmap_wodom)
              * R.from_quat(np.asarray(lo_out["q_w"]))).as_quat()
    t_pred = mo.t_wmap_wodom + R.from_quat(mo.q_wmap_wodom).apply(
        np.asarray(lo_out["t_w"]))
    c_xyz, _, _, c_m = voxel_downsample(
        feats.less_sharp.xyz, feats.less_sharp.mask,
        cfg.mapping.line_resolution, cfg.mapping.corner_stack_cap)
    s_xyz, _, _, s_m = voxel_downsample(
        feats.less_flat.xyz, feats.less_flat.mask,
        cfg.mapping.plane_resolution, cfg.mapping.surf_stack_cap)
    q_pred = jnp.asarray(q_pred, jnp.float32)
    t_pred = jnp.asarray(t_pred, jnp.float32)

    _, q_ref, t_ref, stats = solve_mapping(
        mo.map, c_xyz, c_m, s_xyz, s_m, q_pred, t_pred, cfg.mapping)
    assert bool(stats["solved"])
    # the solve moved the prediction (the comparison is not vacuous)
    assert float(jnp.linalg.norm(t_ref - t_pred)) > 1e-4

    for mesh in (data_mesh(devices=jax.devices()[:1]), data_mesh()):
        _, q_m, t_m, st = mesh_solve_mapping(
            mesh, mo.map, c_xyz, c_m, s_xyz, s_m, q_pred, t_pred,
            cfg.mapping)
        assert st["solved"]
        np.testing.assert_allclose(np.asarray(t_m), np.asarray(t_ref),
                                   atol=2e-3)
        q_m, q_r = np.asarray(q_m, np.float64), np.asarray(q_ref, np.float64)
        dq = (R.from_quat(q_m / np.linalg.norm(q_m)).inv()
              * R.from_quat(q_r / np.linalg.norm(q_r))).magnitude()
        # residual divergence source: solve_mapping reuses its
        # prediction-pose candidate gather across outer rounds while the
        # mesh path re-runs the global k-NN each round — a boundary
        # candidate can differ in round 2 (documented in mapping.py)
        assert dq < 5e-4, dq


def test_mesh_laser_mapping_map_stays_in_lockstep():
    """MeshLaserMapping's map maintenance is identical to LaserMapping's:
    after a short drive the two grid maps hold the same live counts."""
    cfg = mesh_cfg()
    scans = _scan_frames(cfg, 4, seed=13)
    _, mo_single = _run_single_device(cfg, scans)

    lo = LaserOdometry(cfg.lo)
    mo_mesh = MeshLaserMapping(cfg.mapping, data_mesh())
    for pts in scans:
        padded, n = synthetic.pad_scan(pts, cfg.lidar.max_points)
        feats = register_scan(jnp.asarray(padded), jnp.int32(n), cfg.lidar,
                              cfg.scanreg)
        lo_out = lo.step(feats)
        mo_mesh.step(feats.less_sharp, feats.less_flat,
                     lo_out["q_w"], lo_out["t_w"],
                     skip_frame=lo_out["skip_frame"])
    n_c_single = int(mo_single.map.corner.n_live)
    n_c_mesh = int(mo_mesh.map.corner.n_live)
    n_s_single = int(mo_single.map.surf.n_live)
    n_s_mesh = int(mo_mesh.map.surf.n_live)
    assert n_c_single > 0 and n_s_single > 0
    assert abs(n_c_mesh - n_c_single) <= max(2, n_c_single // 100)
    assert abs(n_s_mesh - n_s_single) <= max(2, n_s_single // 100)

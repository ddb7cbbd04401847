import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation as R

from vloam.data import synthetic
from vloam.lidar.loam_step import LoamEngine, unpack_outputs
from vloam.lidar.odometry import LaserOdometry
from vloam.lidar.mapping import LaserMapping
from vloam.lidar import scan_registration as sr

from test_pipeline import small_cfg


def test_engine_matches_host_classes():
    """The fused device step must agree with the host-orchestrated classes."""
    cfg = small_cfg()
    scene = synthetic.urban_scene(21)
    n = 5
    poses = synthetic.drive_trajectory(n, speed=1.0, yaw_rate=0.02)
    scans = [synthetic.simulate_scan(scene, T, n_scans=64, n_azimuth=900,
                                     seed=k) for k, T in enumerate(poses)]

    # host path
    lo = LaserOdometry(cfg.lo)
    mo = LaserMapping(cfg.mapping)
    host_mo = []
    host_lo = []
    for k, pts in enumerate(scans):
        padded, cnt = synthetic.pad_scan(pts, cfg.lidar.max_points)
        feats = sr.register_scan(jnp.asarray(padded), jnp.int32(cnt),
                                 cfg.lidar, cfg.scanreg)
        out = lo.step(feats)
        res = mo.step(feats.less_sharp, feats.less_flat, out["q_w"],
                      out["t_w"], skip_frame=out["skip_frame"])
        host_lo.append(np.asarray(out["t_w"]))
        host_mo.append(np.asarray(res["t_w"]))

    # fused engine path
    eng = LoamEngine(cfg, chunk=2)
    for pts in scans:
        eng.push(pts)
    outs = unpack_outputs(eng.finish())
    assert outs["t_w_lo"].shape == (n, 3)
    np.testing.assert_allclose(outs["t_w_lo"], np.stack(host_lo), atol=5e-3)
    np.testing.assert_allclose(outs["t_w_mo"], np.stack(host_mo), atol=2e-2)
    # f32 on-device accumulation agrees with f64 recomposition at this length
    np.testing.assert_allclose(outs["t_w_lo32"], outs["t_w_lo"], atol=5e-3)
    gt = np.stack([T[:3, 3] for T in poses])
    assert np.linalg.norm(outs["t_w_mo"] - gt, axis=1).max() < 0.3


def test_polar_ingest_matches_xyz_ingest():
    """Quantized range-image ingest must track the xyz ingest: identical
    raycast, 5 mm quantization below the 10 mm sensor noise."""
    cfg = small_cfg()
    scene = synthetic.urban_scene(21)
    n = 4
    poses = synthetic.drive_trajectory(n, speed=1.0, yaw_rate=0.02)

    eng_xyz = LoamEngine(cfg, chunk=2)
    eng_pol = LoamEngine(cfg, chunk=2)
    for k, T in enumerate(poses):
        pts = synthetic.simulate_scan(scene, T, n_scans=64, n_azimuth=900,
                                      seed=k)
        img = synthetic.simulate_scan_polar(scene, T, n_scans=64,
                                            n_azimuth=900, seed=k)
        assert img.dtype == np.uint16 and img.shape == (64, 900)
        eng_xyz.push(pts)
        eng_pol.push_polar(img)
    o_xyz = unpack_outputs(eng_xyz.finish())
    o_pol = unpack_outputs(eng_pol.finish())
    np.testing.assert_allclose(o_pol["t_w_mo"], o_xyz["t_w_mo"], atol=3e-2)
    gt = np.stack([T[:3, 3] for T in poses])
    assert np.linalg.norm(o_pol["t_w_mo"] - gt, axis=1).max() < 0.3

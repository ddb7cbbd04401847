"""Degenerate-input robustness: the engines must survive empty scans,
single-return scans, and all-ground frames without NaNs or crashes
(production hardening beyond the reference's ROS_BREAK/NaN-guard set,
SURVEY.md §5)."""

import numpy as np

from vloam.data import synthetic
from vloam.lidar.loam_step import LoamEngine, unpack_outputs

from test_pipeline import small_cfg


def test_engine_survives_degenerate_scans():
    cfg = small_cfg()
    scene = synthetic.urban_scene(9)
    poses = synthetic.drive_trajectory(6, speed=0.8)
    eng = LoamEngine(cfg, chunk=2)
    rng = np.random.default_rng(0)
    for k, T in enumerate(poses):
        if k == 2:
            pts = np.zeros((0, 3), np.float32)  # empty scan
        elif k == 3:
            pts = np.asarray([[10.0, 0.0, 0.0]], np.float32)  # one return
        elif k == 4:
            # all-ground plane (no corners at all)
            xy = rng.uniform(5, 30, (4000, 2)).astype(np.float32)
            pts = np.concatenate(
                [xy, np.full((4000, 1), -1.73, np.float32)], axis=1)
        else:
            pts = synthetic.simulate_scan(scene, T, n_scans=64,
                                          n_azimuth=700, seed=k)
        eng.push(pts)
    raw = unpack_outputs(eng.finish())
    assert np.isfinite(raw["t_w_lo"]).all()
    assert np.isfinite(raw["t_w_mo"]).all()
    assert np.isfinite(raw["q_w_mo"]).all()
    # the degenerate frames must be flagged by the correspondence guard
    assert {2, 3}.issubset(set(raw["lo_degraded"].tolist()))
    # recovery: the last frame has real correspondences again
    assert raw["n_corner"][-1] + raw["n_surf"][-1] > 100


def test_vision_survives_blank_and_saturated_images():
    import jax.numpy as jnp

    from vloam.vision import features

    cfg = small_cfg().vo
    for img in (np.zeros((96, 320), np.float32),
                np.ones((96, 320), np.float32)):
        xy, score, mask = features.detect_keypoints(jnp.asarray(img), cfg)
        assert np.isfinite(np.asarray(xy)).all()
        desc = features.describe_keypoints(jnp.asarray(img), xy, cfg)
        assert np.isfinite(np.asarray(desc)).all()

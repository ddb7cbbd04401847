import numpy as np
import pytest

from vloam.config import (LaserMappingConfig, LidarProfile,
                              PipelineConfig, ScanRegistrationConfig,
                              VisualOdometryConfig)
from vloam.data import synthetic
from vloam.eval.kitti_metrics import kitti_metrics
from vloam.pipeline import VloamPipeline, run_sequence


def small_cfg(**kw):
    return PipelineConfig(
        lidar=LidarProfile(name="t64", n_scans=64, minimum_range=2.0,
                           max_points=65536, ring_capacity=1024),
        scanreg=ScanRegistrationConfig(sharp_cap=1024, less_sharp_cap=8192,
                                       flat_cap=2048, less_flat_cap=16384),
        mapping=LaserMappingConfig(cube_width=11, cube_height=11, cube_depth=5,
                                   map_n_buckets=1 << 14,
                                   corner_bucket_cap=16, surf_bucket_cap=16,
                                   corner_stack_cap=2048, surf_stack_cap=4096),
        vo=VisualOdometryConfig(img_width=320, img_height=96,
                                max_keypoints=256, max_matches=512,
                                shi_tomasi_min_distance=3.5,
                                shi_tomasi_quality=0.02, match_ratio=0.85),
        **kw,
    )


def synth_setup(n_frames, seed=0, use_cam=True):
    scene = synthetic.urban_scene(seed)
    cfg0 = small_cfg()
    K, _, _, velo_T_cam = synthetic.default_cam_calib(
        cfg0.vo.img_width, cfg0.vo.img_height)
    calib = synthetic.synthetic_calib(cfg0.vo.img_width, cfg0.vo.img_height)
    poses = synthetic.drive_trajectory(n_frames, speed=1.0, yaw_rate=0.015)

    def frames():
        for k, T in enumerate(poses):
            f = {"points": synthetic.simulate_scan(scene, T, n_scans=64,
                                                   n_azimuth=900, seed=k)}
            if use_cam:
                f["image"] = synthetic.render_camera(scene, T @ velo_T_cam, K,
                                                     320, 96)
            yield f

    T0 = poses[0] @ velo_T_cam
    gt = np.stack([(np.linalg.inv(T0) @ (T @ velo_T_cam))[:3, :] for T in poses])
    return calib, frames, gt


@pytest.mark.parametrize("mode", ["detached", "combined"])
def test_full_pipeline_synthetic(mode, tmp_path):
    n = 4
    calib, frames, gt = synth_setup(n)
    cfg = small_cfg(detach_VO_LO=(mode == "detached"))
    result = run_sequence(cfg, calib, frames(), out_dir=str(tmp_path))
    for which in ("VO", "LO", "MO"):
        assert result[which].shape == (n, 3, 4)
    # all three odometries should track the short ground-truth arc
    for which, tol in (("LO", 0.3), ("MO", 0.3)):
        m = kitti_metrics(gt, result[which], step=1)
        assert m["ate_rmse_m"] < tol, (which, m)
    m_vo = kitti_metrics(gt, result["VO"], step=1)
    # VO translation scale only comes from depth; allow looser bound
    assert m_vo["ate_rmse_m"] < 1.0, m_vo
    # txt files exist in the reference layout
    suffix = "1" if mode == "detached" else "0"
    for which in ("VO", "LO", "MO"):
        f = tmp_path / f"{which}{suffix}.txt"
        assert f.exists()
        data = np.loadtxt(f)
        assert data.shape == (n, 12)


def test_lidar_only_pipeline():
    n = 3
    calib, frames, gt = synth_setup(n, use_cam=False)
    cfg = small_cfg()
    result = run_sequence(cfg, calib,
                          ({"points": f["points"]} for f in frames()))
    m = kitti_metrics(gt, result["MO"], step=1)
    assert m["ate_rmse_m"] < 0.3, m

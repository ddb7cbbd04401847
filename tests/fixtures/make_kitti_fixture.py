"""Generate the checked-in KITTI-odometry-layout mini-fixture.

Writes tests/fixtures/kitti_mini/sequences/00/{velodyne/*.bin,
image_0/*.png, calib.txt, times.txt} — 5 tiny synthetic VLP-16-style
frames in the exact on-disk formats the reference consumes
(velodyne .bin: flat float32 x,y,z,reflectance, reference
point_cloud_util.cpp:118-146; odometry calib.txt: P0..P3 + Tr). The
fixture is the stand-in for the reference's checked-in results/*.txt
validation: tests/test_cli_kitti.py drives `cli run --odometry-root` over
it end-to-end.

Deterministic: re-running reproduces byte-identical .bin files.
"""

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from vloam.config import tiny_test_profile  # noqa: E402
from vloam.data import synthetic  # noqa: E402

N_FRAMES = 5
N_AZIMUTH = 360


def main(out_root=None):
    out = Path(out_root or Path(__file__).parent / "kitti_mini")
    seq = out / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True, exist_ok=True)
    (seq / "image_0").mkdir(parents=True, exist_ok=True)

    cfg = tiny_test_profile()
    scene = synthetic.urban_scene(7, extent=40.0)
    K, P_rect0, cam_T_velo, velo_T_cam = synthetic.default_cam_calib(
        cfg.vo.img_width, cfg.vo.img_height)
    poses = synthetic.drive_trajectory(N_FRAMES, speed=0.8, yaw_rate=0.015)

    gt = []
    for k, T in enumerate(poses):
        pts = synthetic.simulate_scan(scene, T, n_scans=cfg.lidar.n_scans,
                                      n_azimuth=N_AZIMUTH, noise=0.01, seed=k)
        arr = np.zeros((len(pts), 4), np.float32)
        arr[:, :3] = pts
        arr.tofile(seq / "velodyne" / f"{k:06d}.bin")

        img = synthetic.render_camera(scene, T @ velo_T_cam, K,
                                      cfg.vo.img_width, cfg.vo.img_height)
        from PIL import Image

        Image.fromarray((img * 255).astype(np.uint8), mode="L").save(
            seq / "image_0" / f"{k:06d}.png")
        # ground truth pose of cam0 at frame k in the cam0-start frame
        T_cam = T @ velo_T_cam
        gt.append(np.linalg.inv(poses[0] @ velo_T_cam) @ T_cam)

    # calib.txt: P0..P3 identical (grayscale-left only) + Tr = cam0_T_velo
    p_line = " ".join(f"{v:.12e}" for v in P_rect0.reshape(-1))
    tr = np.linalg.inv(velo_T_cam)[:3, :]
    with open(seq / "calib.txt", "w") as f:
        for name in ("P0", "P1", "P2", "P3"):
            f.write(f"{name}: {p_line}\n")
        f.write("Tr: " + " ".join(f"{v:.12e}" for v in tr.reshape(-1)) + "\n")
    with open(seq / "times.txt", "w") as f:
        for k in range(N_FRAMES):
            f.write(f"{0.1 * k:.6e}\n")
    # ground-truth trajectory (KITTI poses format) for metric checks
    with open(out / "poses_00.txt", "w") as f:
        for T in gt:
            f.write(" ".join(f"{v:.9e}" for v in T[:3, :].reshape(-1)) + "\n")
    print(f"wrote {N_FRAMES} frames under {seq}")


if __name__ == "__main__":
    main(*sys.argv[1:])

"""Loop-closure demonstration: a >=300-frame closed-loop synthetic drive,
LOAM MO trajectory with and without the pose-graph loop-closure backend
(VERDICT r2 item 6). Appends a section to RESULTS.md."""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from vloam.runtime.cache import enable_compile_cache, frame_cache_dir
from vloam.backend.loop_closure import close_loops
from vloam.config import kitti_hdl64
from vloam.data import synthetic
from vloam.eval.kitti_metrics import kitti_metrics
from vloam.geometry.np_pose import inv_T, qt_to_T
from vloam.lidar.loam_step import LoamEngine, unpack_outputs

CACHE = frame_cache_dir("loop")


def main(n_frames=320):
    enable_compile_cache()
    cfg = kitti_hdl64()
    # closed circle: comes back to the start (radius ~ speed/yaw ~ 51 m)
    yaw = 2.0 * np.pi / n_frames
    poses = synthetic.drive_trajectory(n_frames, speed=1.0, yaw_rate=yaw)
    scene = synthetic.urban_scene(5, extent=90.0, n_boxes=20, n_poles=40,
                                  scatter=40)
    CACHE.mkdir(exist_ok=True)
    scans = []
    t0 = time.time()
    # tag must change with the scene/trajectory params above (stale-cache
    # guard)
    for k, T in enumerate(poses):
        p = CACHE / f"w1_circle{n_frames}_s{k}.npy"
        if p.exists():
            scans.append(np.load(p))
        else:
            s = synthetic.simulate_scan(scene, T, n_scans=64, n_azimuth=1800,
                                        noise=0.01, seed=k)
            np.save(p, s)
            scans.append(s)
    print(f"frame gen: {time.time()-t0:.1f}s", flush=True)

    eng = LoamEngine(cfg, chunk=16)
    t0 = time.time()
    for s in scans:
        eng.push(s)
    raw = unpack_outputs(eng.finish())
    print(f"LOAM run: {time.time()-t0:.1f}s", flush=True)

    gt = np.stack([T[:3, :] for T in poses])

    def get_scan(k):
        return synthetic.pad_scan(scans[k], cfg.lidar.max_points)

    rows = []
    # loop-close the drifting LO chain AND the MO chain (MO drifts far
    # less, so LO shows the correction; both go through the same backend)
    for name, q_w, t_w in [("LO", raw["q_w_lo"], raw["t_w_lo"]),
                           ("MO", raw["q_w_mo"], raw["t_w_mo"])]:
        traj = qt_to_T(q_w, t_w)[:, :3, :]
        m_before = kitti_metrics(gt, traj, step=1)
        print(f"{name} without loop closure:", json.dumps(m_before))
        t0 = time.time()
        res = close_loops(np.asarray(q_w), np.asarray(t_w), get_scan, cfg,
                          radius=22.0, min_gap=40, max_candidates=12,
                          loop_weight=8.0)
        print(f"{name} loop closure: {time.time()-t0:.1f}s, "
              f"loops={res['loops']}", flush=True)
        opt = np.asarray(res["poses"], np.float64)
        lc_traj = qt_to_T(opt[:, :4], opt[:, 4:])
        lc_traj = np.einsum("ij,njk->nik", inv_T(lc_traj[0]),
                            lc_traj)[:, :3, :]
        m_after = kitti_metrics(gt, lc_traj, step=1)
        print(f"{name} with    loop closure:", json.dumps(m_after))
        rows.append((name, m_before, m_after, res["loops"]))

    out = Path(__file__).resolve().parents[1] / "RESULTS.md"
    with open(out, "a") as f:
        f.write(f"\n## Loop closure ({n_frames}-frame closed circle, "
                "lidar-only)\n\n")
        f.write("| run | ATE rmse m | ATE max m | loops |\n")
        f.write("|-----|------------|-----------|-------|\n")
        for name, mb, ma, loops in rows:
            f.write(f"| {name} (odometry only) | {mb['ate_rmse_m']:.3f} | "
                    f"{mb['ate_max_m']:.3f} | - |\n")
            f.write(f"| {name} + loop closure (--loop-close) | "
                    f"{ma['ate_rmse_m']:.3f} | {ma['ate_max_m']:.3f} | "
                    f"{len(loops)} |\n")
    print("appended to", out)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 320)

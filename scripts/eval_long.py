"""Long-drive stability run: N-frame (default 500, ~600 m) synthetic
S-curve through the lidar-only fused engine — the production-scale
analogue of a KITTI 00-length sequence (4,540 frames) scaled to this
environment's frame-generation budget. Checks: finite outputs end to end,
map recentering boundary crossings survived, steady throughput, KITTI
metrics. Appends a section to RESULTS.md."""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from vloam.runtime.cache import enable_compile_cache, frame_cache_dir
from vloam.config import kitti_hdl64
from vloam.data import synthetic
from vloam.eval.kitti_metrics import kitti_metrics
from vloam.lidar.loam_step import LoamEngine, unpack_outputs
from vloam.runtime.profiling import fence

CACHE = frame_cache_dir("long")


def build_frames(n_frames):
    """Polar frames over a long S-curve with the world built ALONG the
    trajectory (buildings flank the road by construction — a fixed street
    grid gets driven through once the S-curve wanders)."""
    k = np.arange(n_frames)
    period = 160
    yaw = np.where((k // period) % 2 == 0, 0.004, -0.004)
    poses = synthetic.drive_trajectory(n_frames, speed=1.2, yaw_rate=yaw)
    rng = np.random.default_rng(0)
    centers = np.stack([T[:3, 3] for T in poses])
    heads = np.stack([T[:3, 0] for T in poses])  # +x of the sensor frame
    boxes, poles = [], []
    for i in range(0, n_frames, 10):  # a building pair every ~12 m
        p = centers[i]
        n_vec = np.array([-heads[i][1], heads[i][0], 0.0])  # road normal
        for side in (-1.0, 1.0):
            off = rng.uniform(11.0, 18.0)
            c = p + side * off * n_vec
            w = rng.uniform(3.0, 7.0)
            d = rng.uniform(3.0, 7.0)
            boxes.append([c[0] - w, c[0] + w, c[1] - d, c[1] + d, -1.73,
                          rng.uniform(4.0, 12.0)])
        if i % 20 == 0:
            pp = p + rng.choice([-1.0, 1.0]) * rng.uniform(5.0, 8.0) * n_vec
            poles.append([pp[0], pp[1], rng.uniform(0.08, 0.2), -1.73,
                          rng.uniform(3.0, 6.0)])
    scene = synthetic.Scene(boxes=np.asarray(boxes, np.float64),
                            poles=np.asarray(poles, np.float64))
    # safety: the path must never enter a box
    for p in centers:
        for b in boxes:
            assert not (b[0] - 1 < p[0] < b[1] + 1
                        and b[2] - 1 < p[1] < b[3] + 1), (p, b)
    CACHE.mkdir(exist_ok=True)
    frames = []
    t0 = time.time()
    for i, T in enumerate(poses):
        p = CACHE / f"w2road_s{n_frames}_{i}.npy"
        if p.exists():
            frames.append(np.load(p))
        else:
            f = synthetic.simulate_scan_polar(scene, T, n_scans=64,
                                              n_azimuth=1800, seed=i)
            np.save(p, f)
            frames.append(f)
        if i % 50 == 0:
            print(f"frame {i} gen t={time.time()-t0:.0f}s", flush=True)
    gt = np.stack([T[:3, :] for T in poses])
    return frames, gt


def main(n_frames=500):
    enable_compile_cache()
    cfg = kitti_hdl64()
    frames, gt = build_frames(n_frames)

    eng = LoamEngine(cfg, chunk=16)
    warm = 16
    for f in frames[:warm]:
        eng.push_polar(f)
    fence(eng.state)
    t0 = time.perf_counter()
    for f in frames[warm:]:
        eng.push_polar(f)
    fence(eng.state)
    fps = (n_frames - warm) / (time.perf_counter() - t0)

    raw = unpack_outputs(eng.finish())
    assert np.isfinite(raw["t_w_mo"]).all(), "NaN in MO trajectory"
    assert np.isfinite(raw["t_w_lo"]).all(), "NaN in LO trajectory"
    dist = np.linalg.norm(np.diff(gt[:, :, 3], axis=0), axis=1).sum()
    crossings = int(dist // cfg.mapping.cube_size)
    from vloam.geometry.np_pose import qt_to_T

    mo = qt_to_T(raw["q_w_mo"], raw["t_w_mo"])[:, :3, :]
    lo = qt_to_T(raw["q_w_lo"], raw["t_w_lo"])[:, :3, :]
    m_mo = kitti_metrics(gt, mo, step=1)
    m_lo = kitti_metrics(gt, lo, step=1)
    print("long LO:", json.dumps(m_lo))
    print("long MO:", json.dumps(m_mo))
    print(f"steady fps {fps:.1f}, drive {dist:.0f} m, "
          f"~{crossings} map-recenter crossings, "
          f"degraded frames: {len(raw['lo_degraded'])}")

    out = Path(__file__).resolve().parents[1] / "RESULTS.md"
    with open(out, "a") as f:
        f.write(f"\n## Long drive ({n_frames} frames, {dist:.0f} m, "
                f"lidar-only, one chip)\n\n")
        f.write("| stream | t_rel % | r deg/m | ATE rmse m | fps | notes |\n")
        f.write("|--------|---------|---------|------------|-----|-------|\n")
        f.write(f"| LO | {m_lo['t_rel_percent']:.3f} | "
                f"{m_lo['r_deg_per_m']:.4f} | {m_lo['ate_rmse_m']:.3f} | "
                f"{fps:.1f} | |\n")
        f.write(f"| MO | {m_mo['t_rel_percent']:.3f} | "
                f"{m_mo['r_deg_per_m']:.4f} | {m_mo['ate_rmse_m']:.3f} | "
                f"{fps:.1f} | ~{crossings} recenter crossings, all outputs "
                f"finite, {len(raw['lo_degraded'])} degraded frames |\n")
    print("appended to", out)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 500)

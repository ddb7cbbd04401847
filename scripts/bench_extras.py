"""Secondary benchmarks: full VLOAM (camera+lidar) throughput and pose-graph
BA iteration rate (the BASELINE.json 'BA iters/sec' metric). Results go into
RESULTS.md; the primary metric stays in bench.py."""

import sys, time, json
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from vloam.runtime.cache import enable_compile_cache, frame_cache_dir
import numpy as np


def bench_vloam(n_chunks=4, chunk=8):
    import jax
    enable_compile_cache()
    from vloam.config import kitti_hdl64
    from vloam.data import synthetic
    from vloam.vloam_step import VloamEngine

    cfg = kitti_hdl64().replace(detach_VO_LO=False)
    scene = synthetic.urban_scene(0, extent=80.0)
    K, _, _, velo_T_cam = synthetic.default_cam_calib(
        cfg.vo.img_width, cfg.vo.img_height)
    calib = synthetic.synthetic_calib(cfg.vo.img_width, cfg.vo.img_height)
    n = chunk * (n_chunks + 1)
    poses = synthetic.drive_trajectory(n, speed=1.1, yaw_rate=0.01)
    cache = frame_cache_dir("bench") / "camera.npz"
    if cache.exists():
        data = np.load(cache)
        scans = [data[f"s{k}"] for k in range(n)]
        imgs = [data[f"i{k}"] for k in range(n)]
    else:
        scans, imgs = [], []
        for k, T in enumerate(poses):
            scans.append(synthetic.simulate_scan(scene, T, n_scans=64,
                                                 n_azimuth=1800, seed=k))
            imgs.append((synthetic.render_camera(scene, T @ velo_T_cam, K,
                                                 cfg.vo.img_width,
                                                 cfg.vo.img_height)
                         * 255).astype(np.uint8))
        np.savez(cache, **{f"s{k}": s for k, s in enumerate(scans)},
                 **{f"i{k}": i for k, i in enumerate(imgs)})
    from vloam.runtime.profiling import fence

    eng = VloamEngine(cfg, calib, chunk=chunk)
    for k in range(chunk):
        eng.push(scans[k], imgs[k])
    fence(eng.state)
    t0 = time.perf_counter()
    for k in range(chunk, n):
        eng.push(scans[k], imgs[k])
    fence(eng.state)
    fps = (n - chunk) / (time.perf_counter() - t0)
    print(json.dumps({"metric": "vloam_full_frames_per_sec",
                      "value": round(fps, 1)}))
    return fps


def bench_pgo(n_poses=256, n_iters=10):
    import jax
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation as R
    from vloam.parallel.pose_graph import build_odometry_graph, \
        optimize_pose_graph

    rng = np.random.default_rng(0)
    poses = []
    for k in range(n_poses):
        q = R.from_euler("z", 0.002 * k).as_quat()
        poses.append(np.concatenate([q, [0.5 * k, 0.001 * k * k, 0]]))
    g = build_odometry_graph(np.stack(poses),
                             loop_pairs=[(n_poses - 1, 0)])
    out = optimize_pose_graph(g, gn_iters=n_iters, cg_iters=32)
    out.block_until_ready()
    t0 = time.perf_counter()
    out = optimize_pose_graph(g, gn_iters=n_iters, cg_iters=32)
    out.block_until_ready()
    dt = time.perf_counter() - t0
    # one "BA iteration" = one GN step (linearize ~n_poses edges + 32 PCG)
    print(json.dumps({
        "metric": "pose_graph_gn_iters_per_sec",
        "value": round(n_iters / dt, 1),
        "n_poses": n_poses,
    }))
    return n_iters / dt


def bench_batch(batch=4, n_chunks=3, chunk=8, pack=False):
    """Aggregate throughput of BatchLoamEngine: B independent HDL-64
    sequences advanced concurrently on one chip (vmap over streams inside
    the frame scan). pack=True stages 12-bit packed range images at 3 cm
    quantization (loam_step.pack12), 25% fewer upload bytes than the
    uint16/5 mm staging of pack=False."""
    import numpy as np
    from vloam.config import kitti_hdl64
    from vloam.data import synthetic
    from vloam.lidar.loam_step import BatchLoamEngine
    from vloam.runtime.profiling import fence

    enable_compile_cache()
    cfg = kitti_hdl64()
    n = chunk * (n_chunks + 1)
    scale = 0.03 if pack else 0.005
    streams = []
    for b in range(batch):
        scene = synthetic.urban_scene(b, extent=80.0)
        poses = synthetic.drive_trajectory(n, speed=1.1,
                                           yaw_rate=0.01 + 0.002 * b)
        scans = [
            synthetic.simulate_scan_polar(scene, T, n_scans=64,
                                          n_azimuth=1800, seed=b * 1000 + k,
                                          range_scale=scale)
            for k, T in enumerate(poses)
        ]
        if pack:
            scans = [np.minimum(s, 4095).astype(np.uint16) for s in scans]
        streams.append(scans)
    # quantize_mm=5.0: int16 staging halves upload bytes; explicit because
    # the engine default is lossless 0.0
    eng = BatchLoamEngine(cfg, batch=batch, chunk=chunk, quantize_mm=5.0,
                          pack12=pack)
    for k in range(chunk):
        for b in range(batch):
            eng.push_polar(b, streams[b][k], range_scale=scale)
    fence(eng.states)
    import time

    t0 = time.perf_counter()
    for k in range(chunk, n):
        for b in range(batch):
            eng.push_polar(b, streams[b][k], range_scale=scale)
    fence(eng.states)
    dt = time.perf_counter() - t0
    agg = batch * (n - chunk) / dt
    print(json.dumps({"metric": "batch_loam_aggregate_frames_per_sec",
                      "value": round(agg, 1), "batch": batch,
                      "pack12": pack}))
    return agg


if __name__ == "__main__":
    bench_pgo()
    bench_vloam()
    bench_batch()
    bench_batch(pack=True)

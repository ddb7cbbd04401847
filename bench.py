"""Benchmark: fused device-resident LOAM pipeline throughput on one chip.

Runs the single-jit scanreg + frame-to-frame odometry + scan-to-map step
(vloam.lidar.loam_step) over KITTI-shaped synthetic HDL-64 frames
(64x1800 rays, ~105k returns each), chunked through lax.scan with all
recurrent state (feature clouds, grid map, poses) device-resident; poses are
downloaded once at the end. Ingest is the quantized polar range image
(uint16, 5 mm: 2 bytes/ray, ~3x fewer host->device bytes than xyz).

Baseline: the reference C++ stack budgets 100 ms/frame for the LOAM path
(lidar_odometry_mapping.cpp:150-153) and was evaluated at 0.33x real time,
i.e. ~10 frames/sec — vs_baseline is our fps / 10.

Prints JSON lines: {"metric", "value", "unit", "vs_baseline", ...} with the
device (platform, device_kind, count) and the card's name and power limit.
Exits non-zero on an unknown device or a failed phase.
"""

import json
import sys
import time


_FRAME_CACHE_VERSION = 2  # bump when the synthetic world code changes


def _cached_frames(key, params, gen):
    """Generate-or-load synthetic frames: frame generation is the slow half
    of the bench wall clock, and the frames are deterministic, so they are
    cached inside the checkout.

    `params` is the full tuple of generation inputs (scene seed/extent,
    n_scans, n_azimuth, noise, trajectory args, version tag); it is folded
    into the cache filename so ANY parameter change invalidates the cache
    instead of silently reusing stale frames."""
    import hashlib

    import numpy as np

    from vloam.runtime.cache import frame_cache_dir

    tag = hashlib.sha1(
        repr((_FRAME_CACHE_VERSION,) + tuple(params)).encode()).hexdigest()[:12]
    path = frame_cache_dir("bench") / f"{key}_{tag}.npz"
    if path.exists():
        with np.load(path) as z:
            return [z[k] for k in z.files]
    arrs = gen()
    np.savez(path, *arrs)
    return arrs


def _bench_combined(cfg, scene):
    """Secondary metric: full camera+lidar VLOAM throughput (VloamEngine,
    vision chunk + LOAM chunk per 8 frames). Reference full-callback budget
    is ~147 ms/frame = ~6.8 fps (34 ms image + 2.6 ms projection + 11 ms VO
    solve + 100 ms LOAM; src/vloam_main/README.md:115-119,
    lidar_odometry_mapping.cpp:150-153). Always runs; failures propagate
    and fail the run."""
    import time

    import numpy as np

    from vloam.data import synthetic
    from vloam.runtime.profiling import fence
    from vloam.vloam_step import VloamEngine

    cfg_c = cfg.replace(detach_VO_LO=False)
    K, _, _, velo_T_cam = synthetic.default_cam_calib(
        cfg_c.vo.img_width, cfg_c.vo.img_height)
    calib = synthetic.synthetic_calib(cfg_c.vo.img_width, cfg_c.vo.img_height)

    chunk = 8
    n_warm, n_meas = chunk, 5 * chunk  # 40 measured frames
    poses = synthetic.drive_trajectory(n_warm + n_meas, speed=1.1,
                                       yaw_rate=0.01)

    def gen():
        scans, imgs = [], []
        for k, T in enumerate(poses):
            scans.append(synthetic.simulate_scan_polar(
                scene, T, n_scans=cfg_c.lidar.n_scans, n_azimuth=1800,
                seed=k))
            imgs.append((synthetic.render_camera(
                scene, T @ velo_T_cam, K, cfg_c.vo.img_width,
                cfg_c.vo.img_height) * 255).astype(np.uint8))
        return scans + imgs

    arrs = _cached_frames(
        f"combined_{n_warm + n_meas}",
        (0, 80.0, cfg_c.lidar.n_scans, 1800, cfg_c.vo.img_width,
         cfg_c.vo.img_height, 1.1, 0.01), gen)
    scans, imgs = arrs[:len(poses)], arrs[len(poses):]
    eng = VloamEngine(cfg_c, calib, chunk=chunk)
    for k in range(n_warm):
        eng.push_polar(scans[k], imgs[k])
    fence(eng.state)
    # best window of 3, each TWO passes over the measured frames with one
    # fence at the end
    rates = []
    k0 = n_warm
    win = 2 * n_meas
    for _ in range(3):
        t0 = time.perf_counter()
        for k in range(k0, k0 + win):
            eng.push_polar(scans[k % (n_warm + n_meas)],
                           imgs[k % (n_warm + n_meas)])
        fence(eng.state)
        rates.append(win / (time.perf_counter() - t0))
        k0 += win
    return max(rates), sorted(rates)[1]


# Published peaks per device_kind as JAX reports it (NVIDIA H100 SXM data
# sheet, dense, at the 700 W power limit): float32 outside the tensor cores,
# TF32 tensor cores, HBM bytes/s. Every product on the main path runs at
# float32 precision ("highest"), so utilization divides by the float32 peak.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "tf32_flops": 495e12,
                              "hbm_bytes": 3.35e12},
}


def device_peaks(kind: str) -> dict:
    """Peak rates of a device kind; an unknown kind is an error."""
    if kind not in DEVICE_PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(DEVICE_PEAKS)}")
    return DEVICE_PEAKS[kind]


def _roofline(cfg, ranges, elev, fps):
    """Device-capability accounting for the fused LOAM chunk: XLA's compiled
    cost analysis gives FLOPs and device-memory bytes accessed per chunk;
    scaled by the measured frame rate this yields utilization against the
    device's peak memory bandwidth and float32 throughput.

    Both counts are lower bounds: the cost analysis counts each while-loop
    body once, whatever its trip count (the LM iterations, the selection's
    pick rounds), and cannot see inside the Triton selection kernel, a
    custom call whose cost estimate JAX's Triton lowering drops."""
    import jax
    import jax.numpy as jnp

    from vloam.lidar.loam_step import LoamState, loam_run_chunk_polar

    peaks = device_peaks(jax.devices()[0].device_kind)
    state = LoamState.create(cfg)
    f = ranges.shape[0]
    pq = jnp.zeros((f, 4), jnp.float32).at[:, 3].set(1.0)
    pt = jnp.zeros((f, 3), jnp.float32)
    up = jnp.zeros((f,), bool)
    compiled = loam_run_chunk_polar.lower(
        state, jnp.asarray(ranges), elev, pq, pt, up, cfg=cfg,
        scale=0.005).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    flops_per_frame = float(ca["flops"]) / f
    bytes_per_frame = float(ca["bytes accessed"]) / f
    return {
        "flops_per_frame": round(flops_per_frame, 1),
        "hbm_bytes_per_frame": round(bytes_per_frame, 1),
        "hbm_util": round(bytes_per_frame * fps / peaks["hbm_bytes"], 4),
        "fp32_util": round(flops_per_frame * fps / peaks["fp32_flops"], 4),
    }


def main():
    import jax
    import numpy as np

    from vloam.runtime.cache import enable_compile_cache
    from vloam.runtime.profiling import card_info

    enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    device_peaks(dev.device_kind)  # unknown device: fail before measuring

    from vloam.config import kitti_hdl64
    from vloam.data import synthetic
    from vloam.lidar.loam_step import LoamEngine, unpack_outputs
    from vloam.runtime.profiling import fence

    cfg = kitti_hdl64()
    scene = synthetic.urban_scene(0, extent=80.0)
    chunk = 16
    n_warm, n_meas = chunk, 6 * chunk  # 96 measured frames
    poses = synthetic.drive_trajectory(n_warm + n_meas, speed=1.1,
                                      yaw_rate=0.01)

    def gen():
        return [
            synthetic.simulate_scan_polar(scene, T,
                                          n_scans=cfg.lidar.n_scans,
                                          n_azimuth=1800, noise=0.01, seed=k)
            for k, T in enumerate(poses)
        ]

    frames = _cached_frames(
        f"lidar_{n_warm + n_meas}",
        (0, 80.0, cfg.lidar.n_scans, 1800, 0.01, 1.1, 0.01), gen)
    n_returns = [int((f > 0).sum()) for f in frames]

    eng = LoamEngine(cfg, chunk=chunk)
    # warmup (compile + first chunk)
    for k in range(n_warm):
        eng.push_polar(frames[k])

    fence(eng.state)
    # best window of 3; each window is a full pass over the 96 measured
    # frames with one fence at the end
    rates = []
    k0 = n_warm
    win = n_meas
    for _ in range(3):
        t0 = time.perf_counter()
        for k in range(k0, k0 + win):
            eng.push_polar(frames[k % (n_warm + n_meas)])
        fence(eng.state)
        rates.append(win / (time.perf_counter() - t0))
        k0 += win
    outs = unpack_outputs(eng.finish())
    assert np.isfinite(outs["t_w_mo"]).all()
    fps = max(rates)

    # device-only decomposition: time the chunk program on PRE-UPLOADED
    # range images (no host->device transfer in the window), so the JSON
    # separates device compute from host staging and upload
    import jax.numpy as jnp

    from vloam.lidar.loam_step import loam_run_chunk_polar

    dev_chunks = [jnp.asarray(np.stack(frames[i:i + chunk]))
                  for i in range(0, 4 * chunk, chunk)]
    st = eng.state
    f = dev_chunks[0].shape[0]
    pq = jnp.zeros((f, 4), jnp.float32).at[:, 3].set(1.0)
    pt = jnp.zeros((f, 3), jnp.float32)
    upb = jnp.zeros((f,), bool)
    fence(dev_chunks[-1])
    st, _ = loam_run_chunk_polar(st, dev_chunks[0], eng._elev, pq, pt, upb,
                                 eng.cfg, eng._polar_scale)
    fence(st)
    t0 = time.perf_counter()
    n_dev = 0
    for c in dev_chunks[1:]:
        st, _ = loam_run_chunk_polar(st, c, eng._elev, pq, pt, upb,
                                     eng.cfg, eng._polar_scale)
        n_dev += f
    fence(st)
    device_ms = (time.perf_counter() - t0) / n_dev * 1e3

    rec = {
        "metric": "loam_pipeline_frames_per_sec",
        "value": round(fps, 3),
        "unit": "frames/s (fused scanreg+LO+MO, ~%dk pts/frame)" % (
            int(np.mean(n_returns)) // 1000),
        "vs_baseline": round(fps / 10.0, 3),
        "value_median": round(sorted(rates)[1], 3),
        "window_rates": [round(r, 3) for r in rates],
        "window_frames": win,
        "device_ms_per_frame": round(device_ms, 3),
        "upload_ms_per_frame": round(
            max(0.0, 1000.0 / fps - device_ms), 3),
        "device": device,
        "card": card_info(),
    }
    # emit the primary metric NOW: if a caller's timeout lands during the
    # (slower-to-compile) combined stage below, the output tail still ends
    # with a parseable record; on success the final full line supersedes it
    print(json.dumps(rec), flush=True)
    rec.update(_roofline(cfg, np.stack(frames[:chunk]), eng._elev, fps))

    # secondary metric: full camera+lidar mode
    combined_fps, combined_med = _bench_combined(cfg, scene)
    # reference full-callback envelope ~147 ms/frame = ~6.8 fps
    rec["combined_fps"] = round(combined_fps, 3)
    rec["combined_vs_baseline"] = round(combined_fps / 6.8, 3)
    rec["combined_fps_median"] = round(combined_med, 3)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the VLOAM engine on an NVIDIA GPU at full KITTI HDL-64 width
(64 rings x 1800 azimuths, ring capacity 2560, 2^17 map buckets; 1242x375
camera, 2048 keypoints, 24 px ZNCC patches).

    python chip_smoke.py               # phases a-e on one GPU
    python chip_smoke.py --multi-gpu   # phase f only: the mesh mapping path
                                       # on 4 GPUs against one GPU

Phases (each prints its own lines; any failure exits non-zero):
  a. device: the first JAX device must be a GPU (there is no CPU fallback);
     prints device kind, count, JAX version, card name and power limit.
  b. kernels and precision at full width: the strict-selection Triton
     kernel against its XLA form on real ring layouts (bit-identical
     labels); the LO association against a float64 NumPy brute force; the
     memory analysis of the fused LOAM and vision chunk programs.
  c. lidar-only through the CLI (48 synthetic frames): MO ATE within
     ATE_BOUND_M, compile seconds, steady frames/s, peak device memory; the
     CLI run is repeated to record the run-to-run pose difference.
  d. camera + lidar through the CLI (24 frames): VO and MO finite, MO ATE
     within ATE_BOUND_M, compile seconds, steady frames/s, peak memory.
  e. the first 8 frames of c again on the CPU backend of the same process;
     the largest pose difference against the GPU run within CPU_GPU_TOL_M.
  g. the multi-drive batch runner (BatchLoamEngine, BATCH streams; scan
     registration and its selection kernel run vmapped) on the first 8
     frames: xyz ingest against c's single-stream run within BATCH_LO_TOL_M
     and BATCH_MO_TOL_M, polar ingest with MO ATE within ATE_BOUND_M.
  f. (--multi-gpu) the mapping stage sharded over a 4-GPU mesh for 16
     frames: the devices each map shard lives on, window_active_rows, and
     the MO difference against the single-GPU run of the same frames.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# Healthy short synthetic runs land below 0.05 m MO ATE; a broken mapping
# stage lands above 0.5 m. 0.1 m separates the two with margin.
ATE_BOUND_M = 0.1
# GPU vs CPU on the same frames: float32 sums run in another order and XLA
# picks other algorithms, so the LM iterates from slightly different
# normal equations, and a near-tie correspondence may flip; each moves a
# pose by far less than a centimetre over 8 frames.
CPU_GPU_TOL_M = 1e-2
# The LO association against float64: a pick may differ from the exact one
# only between candidates whose squared distances differ by less than this
# (float32 rounding at 80 m coordinates), and the 25 m^2 gate only within
# this of the gate.
NEAR_TIE_M2 = 1e-3
# The batch runner against single streams: the batch engine's CPU test
# holds LO to 1e-3 m and MO to 1e-2 m (its flat-batched map is a separate
# implementation of the single-stream map).
BATCH_LO_TOL_M = 1e-3
BATCH_MO_TOL_M = 1e-2

LIDAR_FRAMES = 48
COMBINED_FRAMES = 24
CPU_FRAMES = 8
MESH_FRAMES = 16
MESH_DEVICES = 4
BATCH = 2
CHUNK = 8


def require_gpu():
    """The JAX devices, if the first one is a GPU; raises otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs a GPU; JAX found {devs[0].platform} "
            f"({devs[0].device_kind})")
    return devs


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


def _synthetic_drive(cfg, n, camera=False):
    """The CLI's first n synthetic frames (same scene, trajectory, seeds):
    (points, images or None)."""
    from vloam.data import synthetic

    scene = synthetic.urban_scene(0)
    K, _, _, velo_T_cam = synthetic.default_cam_calib(cfg.vo.img_width,
                                                      cfg.vo.img_height)
    poses = synthetic.drive_trajectory(n, speed=1.1, yaw_rate=0.01)
    points = [synthetic.simulate_scan(scene, T, n_scans=cfg.lidar.n_scans,
                                      n_azimuth=1800, seed=k)
              for k, T in enumerate(poses)]
    images = ([synthetic.render_camera(scene, T @ velo_T_cam, K,
                                       cfg.vo.img_width, cfg.vo.img_height)
               for T in poses] if camera else None)
    return points, images


def _ground_truth(cfg, n):
    """The CLI's synthetic ground truth in the cam0-start frame [n, 3, 4]."""
    import numpy as np

    from vloam.data import synthetic

    _, _, _, velo_T_cam = synthetic.default_cam_calib(cfg.vo.img_width,
                                                      cfg.vo.img_height)
    poses = synthetic.drive_trajectory(n, speed=1.1, yaw_rate=0.01)
    T0 = poses[0] @ velo_T_cam
    return np.stack([(np.linalg.inv(T0) @ (T @ velo_T_cam))[:3, :]
                     for T in poses])


def _cfg(sensor, combined):
    from vloam.config import kitti_hdl64, tiny_test_profile

    base = kitti_hdl64() if sensor == "hdl64" else tiny_test_profile()
    # what cli.main builds for --mode {lidar-only, combined} --verbose 1
    return base.replace(detach_VO_LO=not combined, verbose_level=1)


def _run_cli(phase, sensor, n, mode, out):
    """One CLI run; returns the written trajectories {VO, LO, MO}."""
    from pathlib import Path

    from vloam import cli
    from vloam.eval.kitti_metrics import load_kitti_poses

    argv = ["run", "--synthetic", str(n), "--mode", mode, "--engine",
            "fused", "--sensor", sensor, "--chunk", str(CHUNK), "--out", out]
    log(phase, "cli: python -m vloam " + " ".join(argv))
    t0 = time.perf_counter()
    rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    log(phase, f"cli wall {time.perf_counter() - t0:.3f} s (frame "
        "generation included)")
    suffix = "0" if mode == "combined" else "1"
    return {w: load_kitti_poses(Path(out) / f"{w}{suffix}.txt")[:, :3, :]
            for w in ("VO", "LO", "MO") if (Path(out) / f"{w}{suffix}.txt"
                                            ).exists()}


def _ate(gt, pred):
    from vloam.eval.kitti_metrics import kitti_metrics

    return kitti_metrics(gt, pred, step=1)["ate_rmse_m"]


def _time_engine(phase, eng, push_all, card, dev):
    """Compile seconds (first chunk, compile included) and steady frames/s
    (three passes over the second chunk's frames), with peak device memory.
    Returns the engine's packed outputs; the first chunk's rows are a clean
    run of the drive's first frames."""
    import jax

    t0 = time.perf_counter()
    n = push_all(eng, first_chunk=True)
    jax.block_until_ready(eng.state)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_steady = sum(push_all(eng, first_chunk=False) for _ in range(3))
    jax.block_until_ready(eng.state)
    t_steady = time.perf_counter() - t0
    fps = n_steady / t_steady
    compile_s = t_first - n / fps
    log(phase, f"compile {compile_s:.3f} s (first chunk {t_first:.3f} s), "
        f"steady {fps:.3f} frames/s over {n_steady} frames, "
        f"peak_bytes_in_use {_peak_bytes(dev)} | card {card}")
    return eng.finish()


# ---------------------------------------------------------------- phase b


def check_selection_kernel(phase, cfg):
    """Triton strict selection vs the XLA strict form on the xyz (ring
    capacity) and polar (azimuth count) layouts of a synthetic frame."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vloam.data import synthetic
    from vloam.lidar import scan_registration as sr

    scene = synthetic.urban_scene(0)
    T = synthetic.drive_trajectory(1)[0]
    pts_xyz = synthetic.simulate_scan(scene, T, n_scans=cfg.lidar.n_scans,
                                      n_azimuth=1800, seed=0)
    padded, n = synthetic.pad_scan(pts_xyz, cfg.lidar.max_points)
    ranges = synthetic.simulate_scan_polar(scene, T, n_scans=cfg.lidar.n_scans,
                                           n_azimuth=1800, seed=0)
    elev = jnp.asarray(np.radians(synthetic.hdl64_elevations(
        cfg.lidar.n_scans)), jnp.float32)
    layouts = {
        "xyz": jax.jit(sr.scan_layout, static_argnums=2)(
            jnp.asarray(padded), jnp.int32(n), cfg.lidar),
        "polar": jax.jit(sr.polar_layout, static_argnums=2)(
            jnp.asarray(ranges), elev, cfg.lidar),
    }
    sel = cfg.scanreg
    xla = jax.jit(lambda p, c, k: jax.vmap(
        lambda p, c, k: sr._select_ring(p, c, k, sel))(p, c, k))
    kern = jax.jit(lambda p, c, k: sr._select_rings_kernel(p, c, k, sel))
    for name, (pts, _, counts) in layouts.items():
        curv = jax.jit(sr._curvature)(pts)
        ref_lab, ref_sel = xla(pts, curv, counts)
        got_lab, got_sel = kern(pts, curv, counts)
        bad = int(np.sum(np.asarray(ref_lab) != np.asarray(got_lab))
                  + np.sum(np.asarray(ref_sel) != np.asarray(got_sel)))
        times = {}
        for tag, fn in (("xla", xla), ("triton", kern)):
            jax.block_until_ready(fn(pts, curv, counts))
            t0 = time.perf_counter()
            for _ in range(20):
                out = fn(pts, curv, counts)
            jax.block_until_ready(out)
            times[tag] = (time.perf_counter() - t0) / 20 * 1e3
        log(phase, f"strict selection {name} layout {tuple(curv.shape)}: "
            f"{bad} label mismatches (tolerance 0, bit-identical); "
            f"labels 2/1/-1 = {[int(np.sum(np.asarray(got_lab) == v)) for v in (2, 1, -1)]}; "
            f"xla {times['xla']:.4f} ms, triton {times['triton']:.4f} ms")
        if bad:
            raise AssertionError(f"selection kernel differs on {name}")


def _assoc_brute(q, slab, nearby, mode):
    """float64 per-ring exact association: (d0, p0, d2, p2[, d3, p3])."""
    import numpy as np

    q = q.astype(np.float64)
    slab = slab.astype(np.float64)
    S, C, _ = slab.shape
    out = {k: [] for k in ("d0", "p0", "d2", "p2", "d3", "p3")}
    for lo in range(0, len(q), 256):
        qb = q[lo:lo + 256]
        d = np.sum((qb[:, None, None, :] - slab[None]) ** 2, -1)  # [B, S, C]
        amin = np.argmin(d, axis=2)
        dmin = np.take_along_axis(d, amin[:, :, None], 2)[:, :, 0]  # [B, S]
        ring0 = np.argmin(dmin, axis=1)
        b = np.arange(len(qb))
        out["d0"].append(dmin[b, ring0])
        out["p0"].append(slab[ring0, amin[b, ring0]])
        rings = np.arange(S)
        near = ((np.abs(rings[None, :] - ring0[:, None]) <= nearby)
                & (rings[None, :] != ring0[:, None]))
        d_other = np.where(near, dmin, np.inf)
        ring2 = np.argmin(d_other, axis=1)
        out["d2"].append(d_other[b, ring2])
        out["p2"].append(slab[ring2, amin[b, ring2]])
        if mode == "surf":
            row = d[b, ring0].copy()  # [B, C]
            row[b, amin[b, ring0]] = np.inf
            slot3 = np.argmin(row, axis=1)
            out["d3"].append(row[b, slot3])
            out["p3"].append(slab[ring0, slot3])
    return {k: np.concatenate(v) for k, v in out.items() if v}


def check_association(phase, cfg):
    """LO association (default impl) on two consecutive synthetic frames
    against the float64 brute force: identical picks except near-ties, and
    the same 25 m^2 gate except within NEAR_TIE_M2 of it."""
    import jax.numpy as jnp
    import numpy as np

    from vloam.data import synthetic
    from vloam.lidar.ring_assoc import ring_slab_assoc
    from vloam.lidar.scan_registration import register_scan

    scene = synthetic.urban_scene(0)
    feats = []
    for k, T in enumerate(synthetic.drive_trajectory(2, speed=1.1,
                                                     yaw_rate=0.01)):
        pts = synthetic.simulate_scan(scene, T, n_scans=cfg.lidar.n_scans,
                                      n_azimuth=1800, seed=k)
        padded, n = synthetic.pad_scan(pts, cfg.lidar.max_points)
        feats.append(register_scan(jnp.asarray(padded), jnp.int32(n),
                                   cfg.lidar, cfg.scanreg))
    last, cur = feats
    thr = cfg.lo.distance_sq_threshold
    for mode, cloud, slab in (("corner", cur.sharp, last.less_sharp_slab),
                              ("surf", cur.flat, last.less_flat_slab)):
        got = ring_slab_assoc(cloud.xyz, slab, cfg.lo.nearby_scan, mode=mode)
        got = {k: np.asarray(v, np.float64) for k, v in got.items()}
        m = np.asarray(cloud.mask)
        q = np.asarray(cloud.xyz, np.float64)[m]
        ref = _assoc_brute(q, np.asarray(slab.xyz), cfg.lo.nearby_scan, mode)
        got = {k: v[m] for k, v in got.items()}
        keys = ("0", "2", "3") if mode == "surf" else ("0", "2")
        exceptions = 0
        failures = 0
        worst = 0.0
        # p2 and p3 are searched relative to p0's ring and slot, so they
        # are compared only where p0 itself is the exact pick
        p0_same = np.all(got["p0"] == ref["p0"], axis=-1)
        for key in keys:
            d_ref = ref["d" + key]
            d_got = np.sum((q - got["p" + key]) ** 2, -1)  # float64
            live = d_ref < thr - NEAR_TIE_M2
            dep = p0_same if key != "0" else np.ones_like(p0_same)
            exceptions += int(np.sum(live & ~dep))
            live &= dep
            same = np.all(got["p" + key] == ref["p" + key], axis=-1)
            tie = np.abs(d_got - d_ref) < NEAR_TIE_M2
            exceptions += int(np.sum(live & ~same & tie))
            bad = live & ~same & ~tie
            failures += int(np.sum(bad))
            if bad.any():
                worst = max(worst, float(np.abs(d_got - d_ref)[bad].max()))
            gate_ref = d_ref < thr
            gate_got = got["d" + key] < thr
            near_gate = np.abs(d_ref - thr) < NEAR_TIE_M2
            flip = (gate_ref != gate_got) & dep
            exceptions += int(np.sum(flip & near_gate))
            failures += int(np.sum(flip & ~near_gate))
        log(phase, f"LO association {mode}: {len(q)} queries vs "
            f"{tuple(slab.xyz.shape)} slab; {exceptions} near-tie "
            f"exceptions (|dd| < {NEAR_TIE_M2} m^2, or p2/p3 after a "
            f"near-tie p0), {failures} failures (tolerance 0; worst "
            f"|dd| {worst:.3e} m^2)")
        if failures:
            raise AssertionError(f"association {mode} differs from float64")


def print_memory_analysis(phase, cfg):
    """memory_analysis of the fused LOAM chunk (F=16, as bench.py runs it)
    and the vision chunk (F=8) compiled at full width."""
    import jax.numpy as jnp
    import numpy as np

    from vloam.data import synthetic
    from vloam.lidar.loam_step import LoamState, loam_run_chunk_polar
    from vloam.vloam_step import (CamExtrinsics, VisionLoState,
                                  vision_lo_run_chunk_polar)

    S = cfg.lidar.n_scans
    elev = jnp.asarray(np.radians(synthetic.hdl64_elevations(S)),
                       jnp.float32)
    f = 16
    t0 = time.perf_counter()
    c = loam_run_chunk_polar.lower(
        LoamState.create(cfg), jnp.zeros((f, S, 1800), jnp.uint16), elev,
        jnp.zeros((f, 4)), jnp.zeros((f, 3)), jnp.zeros((f,), bool),
        cfg=cfg, scale=0.005).compile()
    log(phase, f"loam_run_chunk_polar F={f} compiled in "
        f"{time.perf_counter() - t0:.3f} s: {c.memory_analysis()}")
    cfg_c = cfg.replace(detach_VO_LO=False)
    f = 8
    t0 = time.perf_counter()
    c = vision_lo_run_chunk_polar.lower(
        VisionLoState.create(cfg_c), jnp.zeros((f, S, 1800), jnp.uint16),
        elev, jnp.zeros((f, cfg.vo.img_height, cfg.vo.img_width), jnp.uint8),
        CamExtrinsics.from_calib(synthetic.synthetic_calib(
            cfg.vo.img_width, cfg.vo.img_height)), cfg=cfg_c,
        scale=0.005).compile()
    log(phase, f"vision_lo_run_chunk_polar F={f} compiled in "
        f"{time.perf_counter() - t0:.3f} s: {c.memory_analysis()}")


# ------------------------------------------------------------ phases c-e


def run_lidar(phase, sensor, card, dev, n_frames=LIDAR_FRAMES):
    """Phase c. Returns the GPU engine's outputs for the first CPU_FRAMES
    frames."""
    import numpy as np

    from vloam.lidar.loam_step import LoamEngine, unpack_outputs

    cfg = _cfg(sensor, combined=False)
    points, _ = _synthetic_drive(cfg, 2 * CHUNK)

    def push_all(eng, first_chunk):
        frames = points[:CHUNK] if first_chunk else points[CHUNK:]
        for p in frames:
            eng.push(p)
        return len(frames)

    outs = _time_engine(phase, LoamEngine(cfg, chunk=CHUNK), push_all, card,
                        dev)
    ref = unpack_outputs(outs[:CPU_FRAMES])
    gt = _ground_truth(cfg, n_frames)

    runs = [_run_cli(phase, sensor, n_frames, "lidar-only",
                     f"results/chip_smoke/lidar_{i}") for i in range(2)]
    ate = _ate(gt, runs[0]["MO"])
    diff = float(np.max(np.abs(runs[0]["MO"] - runs[1]["MO"])))
    log(phase, f"MO ATE {ate:.6f} m over {n_frames} frames (bound "
        f"{ATE_BOUND_M} m); LO ATE {_ate(gt, runs[0]['LO']):.6f} m")
    log(phase, f"run-to-run: largest MO pose entry difference between two "
        f"identical runs {diff:.3e} (recorded, no bound)")
    if not np.all(np.isfinite(runs[0]["MO"])) or not ate <= ATE_BOUND_M:
        raise AssertionError(f"lidar-only MO ATE {ate} > {ATE_BOUND_M}")
    return ref


def run_combined(phase, sensor, card, dev, n_frames=COMBINED_FRAMES):
    """Phase d."""
    import numpy as np

    from vloam.data import synthetic
    from vloam.vloam_step import VloamEngine

    cfg = _cfg(sensor, combined=True)
    points, images = _synthetic_drive(cfg, 2 * CHUNK, camera=True)

    def push_all(eng, first_chunk):
        sl = slice(0, CHUNK) if first_chunk else slice(CHUNK, 2 * CHUNK)
        for p, im in zip(points[sl], images[sl]):
            eng.push(p, im)
        return CHUNK

    calib = synthetic.synthetic_calib(cfg.vo.img_width, cfg.vo.img_height)
    _time_engine(phase, VloamEngine(cfg, calib, chunk=CHUNK), push_all, card,
                 dev)
    gt = _ground_truth(cfg, n_frames)
    traj = _run_cli(phase, sensor, n_frames, "combined",
                    "results/chip_smoke/combined")
    for w in ("VO", "MO"):
        if not np.all(np.isfinite(traj[w])):
            raise AssertionError(f"combined {w} is not finite")
    ate = _ate(gt, traj["MO"])
    log(phase, f"VO and MO finite; MO ATE {ate:.6f} m over {n_frames} "
        f"frames (bound {ATE_BOUND_M} m); VO ATE {_ate(gt, traj['VO']):.6f} m")
    if not ate <= ATE_BOUND_M:
        raise AssertionError(f"combined MO ATE {ate} > {ATE_BOUND_M}")


def run_cpu(phase, sensor, gpu_ref):
    """Phase e: the first CPU_FRAMES frames of phase c on the CPU backend."""
    import jax
    import numpy as np

    from vloam.lidar.loam_step import LoamEngine, unpack_outputs

    cfg = _cfg(sensor, combined=False)
    points, _ = _synthetic_drive(cfg, CPU_FRAMES)
    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        eng = LoamEngine(cfg, chunk=CHUNK)
        for p in points:
            eng.push(p)
        cpu = unpack_outputs(eng.finish())
    diff = float(np.max(np.abs(cpu["t_w_mo"] - gpu_ref["t_w_mo"])))
    qdiff = float(np.max(np.abs(np.abs(np.sum(
        cpu["q_w_mo"] * gpu_ref["q_w_mo"], -1)) - 1.0)))
    log(phase, f"CPU run of {CPU_FRAMES} frames took "
        f"{time.perf_counter() - t0:.3f} s; largest MO translation "
        f"difference vs GPU {diff:.3e} m (tolerance {CPU_GPU_TOL_M} m), "
        f"largest 1-|q_cpu.q_gpu| {qdiff:.3e}")
    if not diff <= CPU_GPU_TOL_M:
        raise AssertionError(f"CPU vs GPU MO differs by {diff} m")


def run_batch(phase, sensor, card, dev, gpu_ref):
    """Phase g: BatchLoamEngine on BATCH copies of the first CPU_FRAMES
    frames, through xyz and through polar ingest."""
    import numpy as np

    from vloam.data import synthetic
    from vloam.lidar.loam_step import BatchLoamEngine, unpack_outputs

    cfg = _cfg(sensor, combined=False)
    points, _ = _synthetic_drive(cfg, CPU_FRAMES)
    scene = synthetic.urban_scene(0)
    poses = synthetic.drive_trajectory(CPU_FRAMES, speed=1.1, yaw_rate=0.01)
    ranges = [synthetic.simulate_scan_polar(scene, T, n_scans=cfg.lidar.n_scans,
                                            n_azimuth=1800, seed=k)
              for k, T in enumerate(poses)]
    gt = _ground_truth(cfg, CPU_FRAMES)
    for ingest, frames in (("xyz", points), ("polar", ranges)):
        eng = BatchLoamEngine(cfg, batch=BATCH, chunk=CHUNK)
        push = eng.push if ingest == "xyz" else eng.push_polar
        t0 = time.perf_counter()
        for frame in frames:
            for b in range(BATCH):
                push(b, frame)
        outs = eng.finish()
        wall = time.perf_counter() - t0
        res = [unpack_outputs(outs[b]) for b in range(BATCH)]
        if not all(np.all(np.isfinite(r["t_w_mo"])) for r in res):
            raise AssertionError(f"batch {ingest} MO is not finite")
        ates = [_ate(gt, _cam0(r, cfg)) for r in res]
        msg = (f"batch {ingest} B={BATCH} x {CPU_FRAMES} frames in {wall:.3f}"
               f" s (compile included); MO ATE per stream "
               f"{', '.join(f'{a:.6f}' for a in ates)} m (bound {ATE_BOUND_M}"
               f" m), peak_bytes_in_use {_peak_bytes(dev)} | card {card}")
        if ingest == "xyz":
            d_lo = max(float(np.max(np.abs(r["t_w_lo"] - gpu_ref["t_w_lo"])))
                       for r in res)
            d_mo = max(float(np.max(np.abs(r["t_w_mo"] - gpu_ref["t_w_mo"])))
                       for r in res)
            msg += (f"; vs single stream: LO {d_lo:.3e} m (tolerance "
                    f"{BATCH_LO_TOL_M} m), MO {d_mo:.3e} m (tolerance "
                    f"{BATCH_MO_TOL_M} m)")
            if not (d_lo <= BATCH_LO_TOL_M and d_mo <= BATCH_MO_TOL_M):
                raise AssertionError(f"batch xyz differs from single stream: "
                                     f"LO {d_lo} m, MO {d_mo} m")
        log(phase, msg)
        if not max(ates) <= ATE_BOUND_M:
            raise AssertionError(f"batch {ingest} MO ATE {max(ates)} > "
                                 f"{ATE_BOUND_M}")


def run_mesh(phase, sensor, card, devs, n_frames=MESH_FRAMES,
             n_dev=MESH_DEVICES):
    """Phase f: mesh-sharded mapping over n_dev devices vs one device."""
    import jax
    import numpy as np

    from vloam.lidar.loam_step import LoamEngine, unpack_outputs
    from vloam.parallel.sharded import data_mesh

    if len(devs) < n_dev:
        raise RuntimeError(f"--multi-gpu needs {n_dev} devices, found "
                           f"{len(devs)}")
    cfg = _cfg(sensor, combined=False)
    points, _ = _synthetic_drive(cfg, n_frames)
    gt = _ground_truth(cfg, n_frames)
    outs = {}
    for name, mesh in (("mesh", data_mesh(devs[:n_dev])), ("single", None)):
        eng = LoamEngine(cfg, chunk=CHUNK, mesh=mesh)
        t0 = time.perf_counter()
        for p in points:
            eng.push(p)
        outs[name] = unpack_outputs(eng.finish())
        log(phase, f"{name}: {n_frames} frames in "
            f"{time.perf_counter() - t0:.3f} s (compile included)")
        if mesh is None:
            continue
        cube = eng._map_state.cube
        leaves, _ = jax.tree_util.tree_flatten_with_path(cube)
        for path, arr in leaves:
            shards = [(s.device.id, s.index[0] if s.index else ())
                      for s in arr.addressable_shards]
            log(phase, f"map {jax.tree_util.keystr(path)} "
                f"{tuple(arr.shape)} {arr.sharding.spec}: (device, rows) "
                f"{shards}")
        active, cap = eng.window_active_rows
        log(phase, f"window_active_rows {active} / {cap}")
        for grid in (cube.corner.pts, cube.surf.pts):
            rows = {(s.device.id, s.index[0].start)
                    for s in grid.addressable_shards}
            if len({d for d, _ in rows}) != n_dev or len(rows) != n_dev:
                raise AssertionError(f"map rows not spread over {n_dev} "
                                     f"devices: {sorted(rows)}")
        if not 0 < active <= cap:
            raise AssertionError(f"window_active_rows {active} / {cap}")
    d = float(np.max(np.abs(outs["mesh"]["t_w_mo"]
                            - outs["single"]["t_w_mo"])))
    log(phase, f"MO translation difference mesh vs single {d:.3e} m; MO ATE "
        f"mesh {_ate(gt, _cam0(outs['mesh'], cfg)):.6f} m, single "
        f"{_ate(gt, _cam0(outs['single'], cfg)):.6f} m | card {card}")
    if not np.all(np.isfinite(outs["mesh"]["t_w_mo"])):
        raise AssertionError("mesh MO is not finite")


def _cam0(raw, cfg):
    """MO world poses exported to the cam0-start frame, as the CLI does."""
    import numpy as np

    from vloam.data import synthetic
    from vloam.fusion.frame_chain import FrameChain
    from vloam.geometry.np_pose import inv_T, qt_to_T

    calib = synthetic.synthetic_calib(cfg.vo.img_width, cfg.vo.img_height)
    B = FrameChain(np.asarray(calib.imu_T_velo, np.float64),
                   np.asarray(calib.imu_T_cam0, np.float64)).base_T_cam0
    X = np.einsum("ij,njk,kl->nil", np.linalg.inv(B),
                  qt_to_T(raw["q_w_mo"], raw["t_w_mo"]), B)
    return np.einsum("ij,njk->nik", inv_T(X[0]), X)[:, :3, :]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only phase f: the mesh mapping path on "
                         f"{MESH_DEVICES} GPUs against one GPU")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    devs = require_gpu()
    import jax

    from vloam.runtime.cache import enable_compile_cache
    from vloam.runtime.profiling import card_info

    enable_compile_cache()
    card = card_info()
    dev = devs[0]
    log("a", f"platform {dev.platform}, device_kind {dev.device_kind}, "
        f"count {len(devs)}, jax {jax.__version__}")
    print(card, flush=True)
    card = card.splitlines()[0]

    if args.multi_gpu:
        run_mesh("f", "hdl64", card, devs)
    else:
        from vloam.config import kitti_hdl64

        cfg = kitti_hdl64()
        check_selection_kernel("b", cfg)
        check_association("b", cfg)
        print_memory_analysis("b", cfg)
        gpu_ref = run_lidar("c", "hdl64", card, dev)
        run_combined("d", "hdl64", card, dev)
        run_cpu("e", "hdl64", gpu_ref)
        run_batch("g", "hdl64", card, dev, gpu_ref)
    log("done", f"all phases passed in {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command-line driver.

Replaces the reference's actionlib server + rosbag feed
(vloam_main_node.cpp:182-222, action schema {date, seq, start_frame,
end_frame}): sequences are driven directly from KITTI files (or the built-in
synthetic world), trajectories are written in the same
results/<run>/{VO,LO,MO}{0,1}.txt layout, and progress is reported on
stdout (the actionlib feedback analogue).

Usage:
  python -m vloam run --synthetic 20 --out results/synth
  python -m vloam run --odometry-root /data/kitti --seq 00 --mode combined
  python -m vloam run --raw-root /data/kitti_raw --date 2011_09_26 --drive 0001
  python -m vloam eval --gt gt.txt --pred results/synth/MO1.txt
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _add_run(sub):
    p = sub.add_parser("run", help="run the VLOAM pipeline on a sequence")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="run N synthetic frames instead of a dataset")
    p.add_argument("--odometry-root", help="KITTI odometry dataset root")
    p.add_argument("--seq", default="00")
    p.add_argument("--raw-root", help="KITTI raw dataset root")
    p.add_argument("--date", default="2011_09_26")
    p.add_argument("--drive", default="0001")
    p.add_argument("--start-frame", type=int, default=0)
    p.add_argument("--end-frame", type=int, default=-1)
    p.add_argument("--mode", choices=["combined", "detached", "lidar-only"],
                   default="detached")
    p.add_argument("--sensor", choices=["hdl64", "hdl32", "vlp16", "tiny"],
                   default="hdl64",
                   help="lidar sensor profile (reference launch variants "
                        "loam_velodyne_{HDL_64,HDL_32,VLP_16}.launch; tiny = "
                        "small-shape test profile for CI fixtures)")
    p.add_argument("--engine", choices=["fused", "host"], default="fused",
                   help="fused: single-jit device-resident chunks (fast); "
                        "host: per-stage host orchestration (debuggable)")
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--polar-ingest", action="store_true",
                   help="native bin->range-image projection + uint16 upload "
                        "(smallest host->device bytes; lidar-only fused "
                        "engine)")
    p.add_argument("--out", default=None, help="output directory for txt files")
    p.add_argument("--profile", default=None, help="write a jax trace here")
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--viz", default=None, metavar="DIR",
                   help="dump match/depth debug PNGs every 10 frames "
                        "(host engine only; the reference's visualize_* "
                        "image topics; with --optical-flow dumps flow "
                        "arrows instead of matches)")
    p.add_argument("--optical-flow", action="store_true",
                   help="match features by pyramidal LK optical flow "
                        "instead of descriptors (reference "
                        "optical_flow_match, vloam_main.launch:10)")
    p.add_argument("--init-state", default=None, metavar="NPZ",
                   help="restore full device state (map + pose chain) from "
                        "a checkpoint before the run")
    p.add_argument("--save-state", default=None, metavar="NPZ",
                   help="save full device state after the run (resume long "
                        "drives / reuse maps across sessions)")
    p.add_argument("--save-map", default=None, metavar="DIR",
                   help="export the accumulated map every map_pub_number "
                        "frames as npz under DIR (reference /laser_cloud_map "
                        "publisher analogue)")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="run the mapping stage as distributed BA over an "
                        "N-device mesh (sharded scan stacks + map blocks, "
                        "windowed ring k-NN, psum'd normal equations). "
                        "With --engine fused this is the shard_map'd "
                        "mapping chunk inside the production engines "
                        "(parallel/mesh_fused.py); with --engine host the "
                        "per-frame MeshLaserMapping path")
    p.add_argument("--reference-exact", action="store_true",
                   help="roll every accuracy-motivated default divergence "
                        "back to the reference's values "
                        "(config.reference_exact) for parity runs")
    p.add_argument("--compare-ref", default=None, metavar="DIR",
                   help="after the run, compare each produced "
                        "{VO,LO,MO}{suffix}.txt stream against the "
                        "same-named file in DIR (the reference's "
                        "results/<date>_drive_<seq>/ layout, "
                        "vloam_main_node.cpp:79-111) and print ATE/RPE per "
                        "stream — the one-command KITTI parity harness")
    p.add_argument("--loop-close", action="store_true",
                   help="after the sequence, detect loop closures (scan "
                        "re-matching) and re-optimize the MO trajectory "
                        "with the pose-graph backend; writes MO<d>_loop.txt")
    p.add_argument("--loop-radius", type=float, default=10.0)
    p.add_argument("--loop-min-gap", type=int, default=50)


def _add_eval(sub):
    p = sub.add_parser("eval", help="KITTI metrics between two pose files")
    p.add_argument("--gt", required=True)
    p.add_argument("--pred", required=True)


def _fit_cfg_to_images(cfg, ds, start_frame, mode):
    """Compile the vision path for the dataset's native image size (KITTI
    sizes vary per sequence: 1241x376, 1226x370, 1242x375, ...). Falls back
    to the config default when no images exist."""
    if mode == "lidar-only" or not getattr(ds, "img_files", None):
        return cfg
    import dataclasses

    from .data.kitti import load_image_gray

    h, w = load_image_gray(ds.img_files[min(start_frame,
                                            len(ds.img_files) - 1)]).shape
    if (h, w) == (cfg.vo.img_height, cfg.vo.img_width):
        return cfg
    return cfg.replace(vo=dataclasses.replace(cfg.vo, img_height=h,
                                              img_width=w))


def _dataset_get_points(ds, start_frame, cfg):
    """Scan-by-index accessor for the loop-closure backend."""
    from .data.kitti import load_velodyne_bin
    from .data.synthetic import pad_scan

    def get_points(k):
        pts = load_velodyne_bin(ds.velo_files[start_frame + k])
        return pad_scan(pts, cfg.lidar.max_points)

    return get_points


def _run_loop_closure(result, calib, cfg, get_points, args):
    """Post-sequence loop closure + pose-graph re-optimization of the MO
    trajectory (new-scope backend; reference drifts without bound)."""
    from scipy.spatial.transform import Rotation as Rot

    from .backend.loop_closure import close_loops
    from .fusion.frame_chain import FrameChain
    from .geometry.np_pose import inv_T, qt_to_T

    chain = FrameChain(np.asarray(calib.imu_T_velo, np.float64),
                       np.asarray(calib.imu_T_cam0, np.float64))
    B = chain.base_T_cam0
    Binv = np.linalg.inv(B)
    mo = np.asarray(result["MO"], np.float64)  # [N, 3, 4] cam0-start
    bottom = np.broadcast_to(np.asarray([[0.0, 0, 0, 1]]), (len(mo), 1, 4))
    X = np.concatenate([mo, bottom], axis=1)
    W = np.einsum("ij,njk,kl->nil", B, X, Binv)  # world_T_base per frame
    q_w = Rot.from_matrix(W[:, :3, :3]).as_quat()
    t_w = W[:, :3, 3]

    res = close_loops(q_w, t_w, get_points, cfg, radius=args.loop_radius,
                      min_gap=args.loop_min_gap)
    print(f"loop closure: {len(res['loops'])} loop(s) accepted "
          f"{res['loops']}")
    opt = np.asarray(res["poses"], np.float64)
    Wo = qt_to_T(opt[:, :4], opt[:, 4:])
    Xo = np.einsum("ij,njk,kl->nil", Binv, Wo, B)
    traj = np.einsum("ij,njk->nik", inv_T(Xo[0]), Xo)[:, :3, :]
    result["MO_loop"] = traj
    if args.out is not None:
        from pathlib import Path

        from .fusion.frame_chain import write_kitti_pose_line

        suffix = str(int(cfg.detach_VO_LO))
        with open(Path(args.out) / f"MO{suffix}_loop.txt", "w") as f:
            for T34 in traj:
                write_kitti_pose_line(f, T34)


def _compare_against_reference(result, cfg, ref_dir):
    """Per-stream ATE/RPE of this run's trajectories vs a reference results
    directory holding the upstream framework's {VO,LO,MO}{0,1}.txt files
    (reference layout: src/vloam_main/results/<date>_drive_<seq>/, pose
    format vloam_tf.cpp:93-99). Streams whose file is absent are skipped.
    Returns {stream: metrics-dict} and prints one JSON line per stream."""
    from pathlib import Path

    from .eval.kitti_metrics import kitti_metrics, load_kitti_poses

    suffix = str(int(cfg.detach_VO_LO))
    report = {}
    for which in ("VO", "LO", "MO"):
        if which not in result or not len(result[which]):
            continue
        ref_file = Path(ref_dir) / f"{which}{suffix}.txt"
        if not ref_file.exists():
            print(f"compare-ref: {ref_file.name} not present in {ref_dir}, "
                  "skipped")
            continue
        ref = load_kitti_poses(ref_file)
        pred = np.asarray(result[which], np.float64)
        n = min(len(ref), len(pred))
        if n < 2:
            continue
        m = kitti_metrics(ref[:n], pred[:n], step=1)
        m["n_frames"] = int(n)
        report[which] = m
        print(f"compare-ref {which}{suffix}: {json.dumps(m)}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vloam")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_run(sub)
    _add_eval(sub)
    args = ap.parse_args(argv)

    if args.cmd == "eval":
        from .eval.kitti_metrics import kitti_metrics, load_kitti_poses

        m = kitti_metrics(load_kitti_poses(args.gt), load_kitti_poses(args.pred))
        print(json.dumps(m, indent=2))
        return 0

    # cmd == run
    from .config import HDL32, VLP16, PipelineConfig, kitti_hdl64, \
        tiny_test_profile
    from .pipeline import run_sequence, run_sequence_fused
    from .runtime.profiling import summarize_timings

    if args.reference_exact:
        from .config import reference_exact

        if args.sensor != "hdl64":
            ap.error("--reference-exact is the HDL-64 KITTI parity profile")
        cfg = reference_exact()
    else:
        cfg = {
            "hdl64": kitti_hdl64,
            "hdl32": lambda: PipelineConfig(lidar=HDL32),
            "vlp16": lambda: PipelineConfig(lidar=VLP16),
            "tiny": tiny_test_profile,
        }[args.sensor]()
    cfg = cfg.replace(
        detach_VO_LO=(args.mode != "combined"), verbose_level=args.verbose
    )
    if args.optical_flow:
        import dataclasses

        cfg = cfg.replace(vo=dataclasses.replace(cfg.vo,
                                                 optical_flow_match=True))

    gt_poses = None
    if args.synthetic:
        from .data import synthetic

        scene = synthetic.urban_scene(0)
        K, _, _, velo_T_cam = synthetic.default_cam_calib(
            cfg.vo.img_width, cfg.vo.img_height)
        calib = synthetic.synthetic_calib(cfg.vo.img_width, cfg.vo.img_height)
        poses = synthetic.drive_trajectory(args.synthetic, speed=1.1,
                                           yaw_rate=0.01)
        use_cam = args.mode != "lidar-only"

        def frames():
            for k, T in enumerate(poses):
                f = {"points": synthetic.simulate_scan(
                    scene, T, n_scans=cfg.lidar.n_scans, n_azimuth=1800,
                    seed=k)}
                if use_cam:
                    f["image"] = synthetic.render_camera(
                        scene, T @ velo_T_cam, K, cfg.vo.img_width,
                        cfg.vo.img_height)
                yield f

        frame_iter = frames()

        def get_points(k):
            pts = synthetic.simulate_scan(
                scene, poses[k], n_scans=cfg.lidar.n_scans, n_azimuth=1800,
                seed=k)
            return synthetic.pad_scan(pts, cfg.lidar.max_points)

        # ground truth in cam0-start-frame for metrics
        T0 = poses[0] @ velo_T_cam
        gt_poses = np.stack([
            (np.linalg.inv(T0) @ (T @ velo_T_cam))[:3, :] for T in poses
        ])
    elif args.odometry_root:
        from .data.kitti import KittiOdometrySequence

        ds = KittiOdometrySequence(args.odometry_root, args.seq,
                                   polar_ingest=args.polar_ingest,
                                   polar_scans=cfg.lidar.n_scans)
        calib = ds.calib
        end = len(ds) if args.end_frame < 0 else min(args.end_frame + 1, len(ds))
        frame_iter = (ds.frame(i) for i in range(args.start_frame, end))
        cfg = _fit_cfg_to_images(cfg, ds, args.start_frame, args.mode)
        get_points = _dataset_get_points(ds, args.start_frame, cfg)
    elif args.raw_root:
        from .data.kitti import KittiRawDrive

        ds = KittiRawDrive(args.raw_root, args.date, args.drive,
                           polar_ingest=args.polar_ingest,
                           polar_scans=cfg.lidar.n_scans)
        calib = ds.calib
        end = len(ds) if args.end_frame < 0 else min(args.end_frame + 1, len(ds))
        frame_iter = (ds.frame(i) for i in range(args.start_frame, end))
        cfg = _fit_cfg_to_images(cfg, ds, args.start_frame, args.mode)
        get_points = _dataset_get_points(ds, args.start_frame, cfg)
    else:
        ap.error("one of --synthetic / --odometry-root / --raw-root required")

    if args.mode == "lidar-only":
        frame_iter = (
            {"polar": f["polar"]} if "polar" in f else {"points": f["points"]}
            for f in frame_iter
        )

    def progress(k, info):
        if args.verbose:
            print(f"frame {k}: {info['t_frame_ms']:.1f} ms "
                  f"(scanreg {info.get('t_scanreg_ms', 0):.1f}, "
                  f"lo {info.get('t_lo_ms', 0):.1f}, "
                  f"mo {info.get('t_mo_ms', 0):.1f})", flush=True)

    ctx = None
    if args.profile:
        from .runtime.profiling import device_trace

        ctx = device_trace(args.profile)
        ctx.__enter__()
    mesh = None
    if args.mesh:
        import jax

        from .parallel.sharded import data_mesh

        devs = jax.devices()
        if len(devs) < args.mesh:
            ap.error(f"--mesh {args.mesh}: only {len(devs)} device(s) "
                     "visible (use XLA_FLAGS=--xla_force_host_platform_"
                     "device_count=N JAX_PLATFORMS=cpu for a virtual mesh)")
        mesh = data_mesh(devs[:args.mesh])
    try:
        if args.engine == "fused":
            result = run_sequence_fused(cfg, calib, frame_iter,
                                        out_dir=args.out, chunk=args.chunk,
                                        lidar_only=(args.mode == "lidar-only"),
                                        verbose=args.verbose,
                                        save_map=args.save_map,
                                        init_state=args.init_state,
                                        save_state_path=args.save_state,
                                        mesh=mesh)
        else:
            result = run_sequence(cfg, calib, frame_iter, out_dir=args.out,
                                  progress=progress, viz_dir=args.viz,
                                  mesh=mesh)
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)

    if "timings" in result:
        print("timing summary (ms):",
              json.dumps(summarize_timings(result["timings"]), indent=2))
    if "fps" in result:
        print(f"throughput: {result['fps']:.1f} frames/s")
    if args.loop_close and "MO" in result and len(result["MO"]) > 2:
        _run_loop_closure(result, calib, cfg, get_points, args)
    if args.compare_ref:
        _compare_against_reference(result, cfg, args.compare_ref)
    if gt_poses is not None:
        from .eval.kitti_metrics import kitti_metrics

        for which in ("VO", "LO", "MO", "MO_loop"):
            if which in result and len(result[which]):
                m = kitti_metrics(gt_poses, result[which], step=1)
                print(which, json.dumps(m))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""VO accuracy diagnostics (VERDICT r2 item 4): per-stage error breakdown
on the synthetic eval drive.

For each frame pair: match quality vs ground truth (reprojection of
gt-depth points under the gt motion), depth-association quality, and the
f2f solve error — then ablations over matching mode / LM iterations /
gates. Run on CPU (JAX_PLATFORMS=cpu ok) with the cached eval frames."""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation as R

from vloam.runtime.cache import frame_cache_dir
from vloam.config import kitti_hdl64
from vloam.data import synthetic
from vloam.vision import features
from vloam.vision.depth_map import build_depth_grid, query_depth
from vloam.vision.vo import solve_vo

CACHE = frame_cache_dir("synth")


def load_frames(n):
    frames = []
    for k in range(n):
        d = np.load(CACHE / f"f{k}_1_1242.npz")
        frames.append({"points": d["points"], "image": d["image"]})
    return frames


def main(n_pairs=10):
    cfg = kitti_hdl64().replace(detach_VO_LO=False)
    vo = cfg.vo
    K, P_rect0, cam_T_velo, velo_T_cam = synthetic.default_cam_calib(
        vo.img_width, vo.img_height)
    P_velo_to_img = P_rect0 @ np.linalg.inv(velo_T_cam)
    poses = synthetic.drive_trajectory(n_pairs + 1, speed=1.2, yaw_rate=0.008)
    frames = load_frames(n_pairs + 1)
    Kj = jnp.asarray(K, jnp.float32)

    for label, vo_cfg in [
        ("base(zncc,bf,knn,32it)", vo),
        ("lk-flow", vo.__class__(**{**vo.__dict__, "optical_flow_match": True})),
    ]:
        stats = []
        for k in range(n_pairs):
            img0 = jnp.asarray(frames[k]["image"], jnp.float32)
            img1 = jnp.asarray(frames[k + 1]["image"], jnp.float32)
            xy0, sc0, m0 = features.detect_keypoints(img0, vo_cfg)
            xy1, sc1, m1 = features.detect_keypoints(img1, vo_cfg)
            if vo_cfg.optical_flow_match:
                from vloam.vision.optical_flow import lk_flow

                xy1m, status = lk_flow(img0, img1, xy0, vo_cfg)
                prev_uv, curr_uv, valid = xy0, xy1m, m0 & status
            else:
                d0 = features.describe_keypoints(img0, xy0, vo_cfg)
                d1 = features.describe_keypoints(img1, xy1, vo_cfg)
                idx1, ok = features.match_descriptors(
                    d0, m0, d1, m1, vo_cfg.match_ratio,
                    matcher=vo_cfg.matcher, select=vo_cfg.match_select)
                prev_uv, curr_uv, valid = xy0, xy1[idx1], ok

            pts0 = frames[k]["points"]
            grid0 = build_depth_grid(
                jnp.asarray(pts0, jnp.float32),
                jnp.ones(len(pts0), bool), jnp.asarray(P_velo_to_img,
                                                       jnp.float32), vo_cfg)

            # ground-truth f2f cam motion (maps frame-k cam pts to k+1)
            T_prev = poses[k] @ velo_T_cam
            T_curr = poses[k + 1] @ velo_T_cam
            T_gt = np.linalg.inv(T_curr) @ T_prev

            # match quality: reproject prev pixel at queried depth with gt
            pv = np.trunc(np.asarray(prev_uv))
            cv = np.trunc(np.asarray(curr_uv))
            dep = np.asarray(query_depth(grid0, jnp.asarray(pv), vo_cfg))
            v = np.asarray(valid)
            hd = v & (dep > 0)
            bear = np.linalg.solve(K, np.concatenate(
                [pv, np.ones((len(pv), 1))], 1).T).T
            X0 = bear * (dep / np.maximum(bear[:, 2], 1e-9))[:, None]
            X1 = (T_gt[:3, :3] @ X0.T).T + T_gt[:3, 3]
            uv1 = (K @ X1.T).T
            uv1 = uv1[:, :2] / np.maximum(uv1[:, 2:], 1e-9)
            reproj = np.linalg.norm(uv1 - cv, axis=1)
            med_rep = float(np.median(reproj[hd])) if hd.any() else np.nan
            in2 = float((reproj[hd] < 2).mean()) if hd.any() else np.nan

            a, t, n32, n22 = solve_vo(
                jnp.asarray(prev_uv), jnp.asarray(curr_uv), jnp.asarray(v),
                grid0, Kj, jnp.zeros(3, jnp.float32),
                jnp.zeros(3, jnp.float32), vo_cfg)
            T_est = np.eye(4)
            T_est[:3, :3] = R.from_rotvec(np.asarray(a, float)).as_matrix()
            T_est[:3, 3] = np.asarray(t, float)
            dT = np.linalg.inv(T_gt) @ T_est
            rot_err = R.from_matrix(dT[:3, :3]).magnitude() * 1e3  # mrad
            t_err = np.linalg.norm(dT[:3, 3]) * 1e3  # mm
            stats.append((int(v.sum()), int(n32), int(n22), med_rep, in2,
                          rot_err, t_err))
        arr = np.asarray(stats, float)
        print(f"\n== {label} ==")
        print("  valid matches: %.0f   n32: %.0f   n22: %.0f" %
              tuple(arr[:, :3].mean(0)))
        print("  match reproj med: %.2f px   inlier<2px: %.2f" %
              tuple(np.nanmean(arr[:, 3:5], 0)))
        print("  f2f err: rot %.2f mrad   trans %.0f mm  (gt step 1200 mm)" %
              tuple(arr[:, 5:7].mean(0)))
        print("  per-frame trans err mm:",
              np.round(arr[:, 6]).astype(int).tolist())


def ablate(n_pairs=8):
    """Grid of config tweaks -> mean f2f errors."""
    import dataclasses
    cfg = kitti_hdl64()
    vo = cfg.vo
    variants = {
        "base": {},
        "kp2048_q01": {"max_keypoints": 2048, "shi_tomasi_quality": 0.01},
        "kp2048_q01_r85": {"max_keypoints": 2048, "shi_tomasi_quality": 0.01,
                           "match_ratio": 0.85},
        "ratio85": {"match_ratio": 0.85},
        "ratio90": {"match_ratio": 0.9},
        "depth_nb5": {"min_depth_neighbors": 5},
        "depth_r3": {"depth_search_radius": 3},
        "iters64": {"max_iterations": 64},
        "nms_on": {"keypoint_nms": True, "nms_max_total": 1024,
                   "max_keypoints": 2048, "shi_tomasi_quality": 0.01},
    }
    K, P_rect0, cam_T_velo, velo_T_cam = synthetic.default_cam_calib(
        vo.img_width, vo.img_height)
    P_velo_to_img = P_rect0 @ np.linalg.inv(velo_T_cam)
    poses = synthetic.drive_trajectory(n_pairs + 1, speed=1.2, yaw_rate=0.008)
    frames = load_frames(n_pairs + 1)
    Kj = jnp.asarray(K, jnp.float32)
    for name, kw in variants.items():
        vo_cfg = dataclasses.replace(vo, **kw)
        errs = []
        for k in range(n_pairs):
            img0 = jnp.asarray(frames[k]["image"], jnp.float32)
            img1 = jnp.asarray(frames[k + 1]["image"], jnp.float32)
            xy0, sc0, m0 = features.detect_keypoints(img0, vo_cfg)
            xy1, sc1, m1 = features.detect_keypoints(img1, vo_cfg)
            if vo_cfg.keypoint_nms:
                m0 = features.bucket_nms(xy0, sc0, m0, vo_cfg.img_width,
                                         vo_cfg.img_height, vo_cfg.nms_bucket,
                                         vo_cfg.nms_bucket, vo_cfg.nms_max_total)
                m1 = features.bucket_nms(xy1, sc1, m1, vo_cfg.img_width,
                                         vo_cfg.img_height, vo_cfg.nms_bucket,
                                         vo_cfg.nms_bucket, vo_cfg.nms_max_total)
            d0 = features.describe_keypoints(img0, xy0, vo_cfg)
            d1 = features.describe_keypoints(img1, xy1, vo_cfg)
            idx1, ok = features.match_descriptors(
                d0, m0, d1, m1, vo_cfg.match_ratio,
                matcher=vo_cfg.matcher, select=vo_cfg.match_select)
            prev_uv, curr_uv, valid = xy0, xy1[idx1], ok
            pts0 = frames[k]["points"]
            grid0 = build_depth_grid(jnp.asarray(pts0, jnp.float32),
                                     jnp.ones(len(pts0), bool),
                                     jnp.asarray(P_velo_to_img, jnp.float32),
                                     vo_cfg)
            T_prev = poses[k] @ velo_T_cam
            T_curr = poses[k + 1] @ velo_T_cam
            T_gt = np.linalg.inv(T_curr) @ T_prev
            a, t, n32, n22 = solve_vo(
                jnp.asarray(prev_uv), jnp.asarray(curr_uv), jnp.asarray(valid),
                grid0, Kj, jnp.zeros(3, jnp.float32),
                jnp.zeros(3, jnp.float32), vo_cfg)
            T_est = np.eye(4)
            T_est[:3, :3] = R.from_rotvec(np.asarray(a, float)).as_matrix()
            T_est[:3, 3] = np.asarray(t, float)
            dT = np.linalg.inv(T_gt) @ T_est
            errs.append((R.from_matrix(dT[:3, :3]).magnitude() * 1e3,
                         np.linalg.norm(dT[:3, 3]) * 1e3,
                         int(n32), int(n22)))
        arr = np.asarray(errs, float)
        print(f"{name:22s} rot {arr[:,0].mean():6.2f} mrad  trans "
              f"{arr[:,1].mean():5.0f} mm  n32 {arr[:,2].mean():5.0f}  "
              f"n22 {arr[:,3].mean():5.0f}", flush=True)


def error_anatomy(n_pairs=8):
    """Decompose the f2f translation error into camera-frame components
    (z = forward/scale) and test gt-depth substitution to isolate the
    depth-association contribution."""
    cfg = kitti_hdl64()
    vo = cfg.vo
    K, P_rect0, cam_T_velo, velo_T_cam = synthetic.default_cam_calib(
        vo.img_width, vo.img_height)
    P_velo_to_img = P_rect0 @ np.linalg.inv(velo_T_cam)
    poses = synthetic.drive_trajectory(n_pairs + 1, speed=1.2, yaw_rate=0.008)
    frames = load_frames(n_pairs + 1)
    Kj = jnp.asarray(K, jnp.float32)
    scene = synthetic.urban_scene(0, extent=140.0, n_boxes=24, n_poles=32)

    errs, errs_gtd = [], []
    for k in range(n_pairs):
        img0 = jnp.asarray(frames[k]["image"], jnp.float32)
        img1 = jnp.asarray(frames[k + 1]["image"], jnp.float32)
        xy0, sc0, m0 = features.detect_keypoints(img0, vo)
        xy1, sc1, m1 = features.detect_keypoints(img1, vo)
        d0 = features.describe_keypoints(img0, xy0, vo)
        d1 = features.describe_keypoints(img1, xy1, vo)
        idx1, ok = features.match_descriptors(d0, m0, d1, m1, vo.match_ratio,
                                              matcher=vo.matcher,
                                              select=vo.match_select)
        prev_uv, curr_uv, valid = xy0, xy1[idx1], ok
        pts0 = frames[k]["points"]
        grid0 = build_depth_grid(jnp.asarray(pts0, jnp.float32),
                                 jnp.ones(len(pts0), bool),
                                 jnp.asarray(P_velo_to_img, jnp.float32), vo)
        T_prev = poses[k] @ velo_T_cam
        T_curr = poses[k + 1] @ velo_T_cam
        T_gt = np.linalg.inv(T_curr) @ T_prev

        def solve_with(grid):
            a, t, n32, n22 = solve_vo(
                jnp.asarray(prev_uv), jnp.asarray(curr_uv), jnp.asarray(valid),
                grid, Kj, jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32),
                vo)
            T_est = np.eye(4)
            T_est[:3, :3] = R.from_rotvec(np.asarray(a, float)).as_matrix()
            T_est[:3, 3] = np.asarray(t, float)
            dT = np.linalg.inv(T_gt) @ T_est
            return dT[:3, 3] * 1e3

        errs.append(solve_with(grid0))

        # gt-depth grid: raycast the true depth at each bucket center
        from vloam.vision.depth_map import DepthGrid
        g = grid0
        u = np.asarray(g.u).ravel(); v = np.asarray(g.v).ravel()
        cnt = np.asarray(g.cnt).ravel()
        live = cnt > 0
        bear = np.linalg.solve(K, np.stack(
            [u, v, np.ones_like(u)])).T
        bear /= np.linalg.norm(bear, axis=1, keepdims=True)
        Rc = T_prev[:3, :3]; tc = T_prev[:3, 3]
        dirs = bear @ Rc.T
        org = np.broadcast_to(tc, dirs.shape)
        rng_t = synthetic._ray_scene_range(org, dirs, scene)
        zt = np.where(np.isfinite(rng_t), rng_t * bear[:, 2], 0.0)
        z_gt = np.where(live & (zt > 0), zt, 0.0).astype(np.float32)
        g2 = DepthGrid(u=g.u, v=g.v, z=jnp.asarray(z_gt.reshape(g.z.shape)),
                       cnt=g.cnt)
        errs_gtd.append(solve_with(g2))

    for name, e in [("lidar depth", np.asarray(errs)),
                    ("gt-ray depth", np.asarray(errs_gtd))]:
        print(f"{name}: mean err vec (x,y,z mm) = "
              f"{np.round(e.mean(0), 1).tolist()}  |e| mean "
              f"{np.linalg.norm(e, axis=1).mean():.0f} mm")


def family_ablation(n_pairs=8):
    """Isolate residual families and the truncation quirk."""
    import dataclasses
    cfg = kitti_hdl64()
    vo = cfg.vo
    K, P_rect0, cam_T_velo, velo_T_cam = synthetic.default_cam_calib(
        vo.img_width, vo.img_height)
    P_velo_to_img = P_rect0 @ np.linalg.inv(velo_T_cam)
    poses = synthetic.drive_trajectory(n_pairs + 1, speed=1.2, yaw_rate=0.008)
    frames = load_frames(n_pairs + 1)
    Kj = jnp.asarray(K, jnp.float32)
    variants = {
        "base": (vo, None),
        "subpixel": (dataclasses.replace(vo, subpixel=True), None),
        "only32": (vo, "32"),
        "only22": (vo, "22"),
        "subpix_only32": (dataclasses.replace(vo, subpixel=True), "32"),
    }
    for name, (vo_cfg, fam) in variants.items():
        errs = []
        for k in range(n_pairs):
            img0 = jnp.asarray(frames[k]["image"], jnp.float32)
            img1 = jnp.asarray(frames[k + 1]["image"], jnp.float32)
            xy0, sc0, m0 = features.detect_keypoints(img0, vo_cfg)
            xy1, sc1, m1 = features.detect_keypoints(img1, vo_cfg)
            d0 = features.describe_keypoints(img0, xy0, vo_cfg)
            d1 = features.describe_keypoints(img1, xy1, vo_cfg)
            idx1, ok = features.match_descriptors(d0, m0, d1, m1,
                                                  vo_cfg.match_ratio,
                                                  matcher=vo_cfg.matcher,
                                                  select=vo_cfg.match_select)
            prev_uv, curr_uv, valid = xy0, xy1[idx1], np.asarray(ok)
            pts0 = frames[k]["points"]
            grid0 = build_depth_grid(jnp.asarray(pts0, jnp.float32),
                                     jnp.ones(len(pts0), bool),
                                     jnp.asarray(P_velo_to_img, jnp.float32),
                                     vo_cfg)
            if fam is not None:
                dep = np.asarray(query_depth(
                    grid0, jnp.trunc(jnp.asarray(prev_uv)), vo_cfg))
                if fam == "32":
                    valid = valid & (dep > 0)
                else:
                    valid = valid & ~(dep > 0)
            T_prev = poses[k] @ velo_T_cam
            T_curr = poses[k + 1] @ velo_T_cam
            T_gt = np.linalg.inv(T_curr) @ T_prev
            a, t, n32, n22 = solve_vo(
                jnp.asarray(prev_uv), jnp.asarray(curr_uv), jnp.asarray(valid),
                grid0, Kj, jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32),
                vo_cfg)
            T_est = np.eye(4)
            T_est[:3, :3] = R.from_rotvec(np.asarray(a, float)).as_matrix()
            T_est[:3, 3] = np.asarray(t, float)
            dT = np.linalg.inv(T_gt) @ T_est
            errs.append(np.concatenate([dT[:3, 3] * 1e3,
                                        [R.from_matrix(dT[:3, :3]).magnitude() * 1e3,
                                         float(n32), float(n22)]]))
        e = np.asarray(errs)
        print(f"{name:14s} err(x,y,z)mm {np.round(e[:, :3].mean(0), 1).tolist()}"
              f"  |t| {np.linalg.norm(e[:, :3], axis=1).mean():4.0f} mm"
              f"  rot {e[:, 3].mean():5.2f} mrad  n32 {e[:, 4].mean():4.0f}"
              f"  n22 {e[:, 5].mean():4.0f}", flush=True)


def improve_ablation(n_pairs=8):
    """Candidate accuracy improvements: subpixel corners, depth-spread
    gate, combinations."""
    import dataclasses
    cfg = kitti_hdl64()
    vo = cfg.vo
    K, P_rect0, cam_T_velo, velo_T_cam = synthetic.default_cam_calib(
        vo.img_width, vo.img_height)
    P_velo_to_img = P_rect0 @ np.linalg.inv(velo_T_cam)
    poses = synthetic.drive_trajectory(n_pairs + 1, speed=1.2, yaw_rate=0.008)
    frames = load_frames(n_pairs + 1)
    Kj = jnp.asarray(K, jnp.float32)
    variants = {
        "base": {},
        "subpix": {"subpixel": True},
        "spread1": {"max_depth_spread": 1.0},
        "spread2": {"max_depth_spread": 2.0},
        "spread05": {"max_depth_spread": 0.5},
        "subpix+spread1": {"subpixel": True, "max_depth_spread": 1.0},
        "subpix+spread1+kp2048": {"subpixel": True, "max_depth_spread": 1.0,
                                  "max_keypoints": 2048,
                                  "shi_tomasi_quality": 0.01},
    }
    for name, kw in variants.items():
        vo_cfg = dataclasses.replace(vo, **kw)
        errs = []
        for k in range(n_pairs):
            img0 = jnp.asarray(frames[k]["image"], jnp.float32)
            img1 = jnp.asarray(frames[k + 1]["image"], jnp.float32)
            xy0, sc0, m0 = features.detect_keypoints(img0, vo_cfg)
            xy1, sc1, m1 = features.detect_keypoints(img1, vo_cfg)
            d0 = features.describe_keypoints(img0, xy0, vo_cfg)
            d1 = features.describe_keypoints(img1, xy1, vo_cfg)
            idx1, ok = features.match_descriptors(d0, m0, d1, m1,
                                                  vo_cfg.match_ratio,
                                                  matcher=vo_cfg.matcher,
                                                  select=vo_cfg.match_select)
            prev_uv, curr_uv, valid = xy0, xy1[idx1], ok
            pts0 = frames[k]["points"]
            grid0 = build_depth_grid(jnp.asarray(pts0, jnp.float32),
                                     jnp.ones(len(pts0), bool),
                                     jnp.asarray(P_velo_to_img, jnp.float32),
                                     vo_cfg)
            T_prev = poses[k] @ velo_T_cam
            T_curr = poses[k + 1] @ velo_T_cam
            T_gt = np.linalg.inv(T_curr) @ T_prev
            a, t, n32, n22 = solve_vo(
                jnp.asarray(prev_uv), jnp.asarray(curr_uv), jnp.asarray(valid),
                grid0, Kj, jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32),
                vo_cfg)
            T_est = np.eye(4)
            T_est[:3, :3] = R.from_rotvec(np.asarray(a, float)).as_matrix()
            T_est[:3, 3] = np.asarray(t, float)
            dT = np.linalg.inv(T_gt) @ T_est
            errs.append(np.concatenate([dT[:3, 3] * 1e3,
                                        [R.from_matrix(dT[:3, :3]).magnitude() * 1e3,
                                         float(n32), float(n22)]]))
        e = np.asarray(errs)
        print(f"{name:24s} err(x,y,z)mm {np.round(e[:, :3].mean(0), 1).tolist()}"
              f"  |t| {np.linalg.norm(e[:, :3], axis=1).mean():4.0f} mm"
              f"  rot {e[:, 3].mean():5.2f} mrad  n32 {e[:, 4].mean():4.0f}"
              f"  n22 {e[:, 5].mean():4.0f}", flush=True)


def improve_ablation2(n_pairs=8, variants=None):
    import dataclasses
    cfg = kitti_hdl64()
    vo = cfg.vo
    K, P_rect0, cam_T_velo, velo_T_cam = synthetic.default_cam_calib(
        vo.img_width, vo.img_height)
    P_velo_to_img = P_rect0 @ np.linalg.inv(velo_T_cam)
    poses = synthetic.drive_trajectory(n_pairs + 1, speed=1.2, yaw_rate=0.008)
    frames = load_frames(n_pairs + 1)
    Kj = jnp.asarray(K, jnp.float32)
    variants = variants or {
        "subpix": {"subpixel": True},
        "subpix_h05": {"subpixel": True, "huber_delta": 0.05},
        "subpix_h02": {"subpixel": True, "huber_delta": 0.02},
        "subpix_nn": {"subpixel": True, "match_select": "nn"},
        "subpix_r75": {"subpixel": True, "match_ratio": 0.75},
        "subpix_patch24": {"subpixel": True, "descriptor_patch": 24},
    }
    for name, kw in variants.items():
        vo_cfg = dataclasses.replace(vo, **kw)
        errs = []
        for k in range(n_pairs):
            img0 = jnp.asarray(frames[k]["image"], jnp.float32)
            img1 = jnp.asarray(frames[k + 1]["image"], jnp.float32)
            xy0, sc0, m0 = features.detect_keypoints(img0, vo_cfg)
            xy1, sc1, m1 = features.detect_keypoints(img1, vo_cfg)
            d0 = features.describe_keypoints(img0, xy0, vo_cfg)
            d1 = features.describe_keypoints(img1, xy1, vo_cfg)
            idx1, ok = features.match_descriptors(d0, m0, d1, m1,
                                                  vo_cfg.match_ratio,
                                                  matcher=vo_cfg.matcher,
                                                  select=vo_cfg.match_select)
            prev_uv, curr_uv, valid = xy0, xy1[idx1], ok
            pts0 = frames[k]["points"]
            grid0 = build_depth_grid(jnp.asarray(pts0, jnp.float32),
                                     jnp.ones(len(pts0), bool),
                                     jnp.asarray(P_velo_to_img, jnp.float32),
                                     vo_cfg)
            T_prev = poses[k] @ velo_T_cam
            T_curr = poses[k + 1] @ velo_T_cam
            T_gt = np.linalg.inv(T_curr) @ T_prev
            a, t, n32, n22 = solve_vo(
                jnp.asarray(prev_uv), jnp.asarray(curr_uv), jnp.asarray(valid),
                grid0, Kj, jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32),
                vo_cfg)
            T_est = np.eye(4)
            T_est[:3, :3] = R.from_rotvec(np.asarray(a, float)).as_matrix()
            T_est[:3, 3] = np.asarray(t, float)
            dT = np.linalg.inv(T_gt) @ T_est
            errs.append(np.concatenate([dT[:3, 3] * 1e3,
                                        [R.from_matrix(dT[:3, :3]).magnitude() * 1e3,
                                         float(n32), float(n22)]]))
        e = np.asarray(errs)
        print(f"{name:18s} err(x,y,z)mm {np.round(e[:, :3].mean(0), 1).tolist()}"
              f"  |t| {np.linalg.norm(e[:, :3], axis=1).mean():4.0f} mm"
              f"  rot {e[:, 3].mean():5.2f} mrad  n32 {e[:, 4].mean():4.0f}"
              f"  n22 {e[:, 5].mean():4.0f}", flush=True)


if __name__ == "__main__":
    t0 = time.time()
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 10)
    print(f"\n{time.time()-t0:.0f}s")

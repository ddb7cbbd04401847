"""Depth-enhanced visual odometry (DEMO residuals) as fixed-shape JAX.

Reimplements reference src/visual_odometry/src/visual_odometry.cpp
solveNlsAll() (:254-450) and the active cost functors
(ceres_cost_function.h):

- CostFunctor32 (:54-96): 3D-2D residual (R X0 + t)_xy - (R X0 + t)_z x1bar
  for matches whose previous-frame pixel has lidar depth,
- CostFunctor22 (:147-185): epipolar residual x1bar . (t x R x0bar) for the
  rest,
- Huber(0.1), angle-axis + translation parameterization (plain Euclidean
  params like Ceres), LM in jit.

Quirk preserved: the reference truncates keypoint pixel coordinates to int
before depth lookup and residual construction (visual_odometry.cpp:283-307);
we do the same for parity.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import VisualOdometryConfig
from ..geometry import so3
from ..solver.lm import ResidualFamily, lm_solve
from .depth_map import DepthGrid, build_depth_grid, query_depth
from . import features
from .optical_flow import lk_flow


@partial(jax.jit, static_argnames=("cfg",))
def solve_vo(
    prev_uv: jnp.ndarray,  # [M, 2] float pixels in frame 0
    curr_uv: jnp.ndarray,  # [M, 2] float pixels in frame 1
    valid: jnp.ndarray,  # [M]
    grid0: DepthGrid,  # depth grid of frame 0
    K: jnp.ndarray,  # [3, 3] P_rect0[:, :3]
    angles0: jnp.ndarray,  # [3] init (from LO prior or zero)
    t0: jnp.ndarray,  # [3]
    cfg: VisualOdometryConfig,
):
    """Returns (angles, t, n32, n22): cam0_curr_T_cam0_last as angle-axis +
    translation (maps frame-0 points into frame 1)."""
    # int truncation quirk (reference :291-303); cfg.subpixel keeps the
    # subpixel coordinates in the residuals (depth bucket lookup still
    # truncates either way)
    p_int = jnp.trunc(prev_uv)
    p_uv = prev_uv if cfg.subpixel else p_int
    c_uv = curr_uv if cfg.subpixel else jnp.trunc(curr_uv)

    if cfg.remove_VO_outlier > 0:
        disp = jnp.sum((p_uv - c_uv) ** 2, axis=-1)
        valid = valid & (disp <= cfg.remove_VO_outlier**2)

    depth0 = query_depth(grid0, p_int, cfg)

    Kinv = jnp.linalg.inv(K)
    ones = jnp.ones((p_uv.shape[0], 1), p_uv.dtype)
    bear0 = jnp.matmul(jnp.concatenate([p_uv, ones], axis=1), Kinv.T,
                       precision="highest")
    bear1 = jnp.matmul(jnp.concatenate([c_uv, ones], axis=1), Kinv.T,
                       precision="highest")
    x0_bar = bear0[:, :2] / bear0[:, 2:3]
    x1_bar = bear1[:, :2] / bear1[:, 2:3]
    X0 = bear0 * depth0[:, None] / bear0[:, 2:3]  # 3D point at depth0

    has_depth = depth0 > 0
    m32 = valid & has_depth
    m22 = valid & ~has_depth

    # ONE fused residual family over the match rows (each row is EITHER a
    # 3D-2D CostFunctor32 block or a 2D-2D CostFunctor22 block; the
    # epipolar scalar rides in slot 0 with a zero-padded slot 1 —
    # identical Huber block norms, half the serialized ops per LM
    # iteration on latency-bound hardware)
    w_rows = (m32 | m22).astype(jnp.float32)
    sel32 = m32[:, None]

    def make_families(x):
        def fused_fn(delta):
            w = x[:3] + delta[:3]
            t = x[3:] + delta[3:]
            Xp = so3.rotate_axis_angle(jnp.broadcast_to(w, X0.shape), X0) + t
            r32 = Xp[:, :2] - Xp[:, 2:3] * x1_bar
            b0 = jnp.concatenate([x0_bar, jnp.ones_like(x0_bar[:, :1])], axis=1)
            b1 = jnp.concatenate([x1_bar, jnp.ones_like(x1_bar[:, :1])], axis=1)
            Rb0 = so3.rotate_axis_angle(jnp.broadcast_to(w, b0.shape), b0)
            tx = jnp.cross(jnp.broadcast_to(t, Rb0.shape), Rb0)
            r22 = jnp.sum(b1 * tx, axis=-1)
            e0 = jnp.asarray([1.0, 0.0], r32.dtype)
            return jnp.where(sel32, r32, r22[:, None] * e0)

        return [ResidualFamily(fused_fn, w_rows)]

    x0 = jnp.concatenate([angles0, t0]).astype(jnp.float32)
    x = lm_solve(make_families, lambda x, d: x + d, x0, dim=6,
                 iterations=cfg.max_iterations, huber_delta=cfg.huber_delta)
    return x[:3], x[3:], jnp.sum(m32.astype(jnp.int32)), jnp.sum(m22.astype(jnp.int32))


class VisualOdometry:
    """Host-side VO pipeline with the reference's 2-slot ring buffer
    (visual_odometry.h:86-90): detect/describe/match (or LK flow), build the
    depth grid, solve. Mirrors VisualOdometry::{processImage,
    processPointCloud, solveNlsAll}."""

    def __init__(self, cfg: VisualOdometryConfig, K: np.ndarray,
                 P_velo_to_img: np.ndarray):
        self.cfg = cfg
        self.K = jnp.asarray(K, jnp.float32)
        self.P_velo_to_img = jnp.asarray(P_velo_to_img, jnp.float32)
        self.count = -1
        self.kp = [None, None]
        self.desc = [None, None]
        self.kp_mask = [None, None]
        self.grids = [None, None]
        self.images = [None, None]
        self.angles = np.zeros(3)
        self.t = np.zeros(3)
        self.stats = {}

    def reset(self):
        self.count += 1
        self.i = self.count % 2

    def process_image(self, img: np.ndarray):
        """img: [H, W] float32 in [0,1] (reference processImage :92-130)."""
        i = self.i
        im = jnp.asarray(img, jnp.float32)
        if self.cfg.clahe:
            im = features.clahe(im)
        self.images[i] = im
        xy, score, mask = features.detect_keypoints(im, self.cfg)
        if self.cfg.keypoint_nms:
            mask = features.bucket_nms(
                xy, score, mask, self.cfg.img_width, self.cfg.img_height,
                self.cfg.nms_bucket, self.cfg.nms_bucket,
                self.cfg.nms_max_total)
        self.kp[i] = xy
        self.kp_mask[i] = mask
        if not self.cfg.optical_flow_match:
            self.desc[i] = features.describe_keypoints(im, xy, self.cfg)

    def process_point_cloud(self, pts_velo: np.ndarray, mask: np.ndarray):
        """Build the frame's depth grid (reference processPointCloud
        :157-186)."""
        self.grids[self.i] = build_depth_grid(
            jnp.asarray(pts_velo, jnp.float32), jnp.asarray(mask),
            self.P_velo_to_img, self.cfg,
        )

    def solve(self, prior_angles=None, prior_t=None):
        """Frame-to-frame solve (reference solveNlsAll :254-450). Returns
        (angles, t) for cam0_curr_T_cam0_last."""
        i, j = self.i, 1 - self.i
        if self.count < 1:
            return self.angles, self.t
        if self.cfg.optical_flow_match:
            xy1, status = lk_flow(self.images[j], self.images[i],
                                  self.kp[j], self.cfg)
            prev_uv, curr_uv = self.kp[j], xy1
            valid = self.kp_mask[j] & status
        else:
            idx1, ok = features.match_descriptors(
                self.desc[j], self.kp_mask[j], self.desc[i], self.kp_mask[i],
                self.cfg.match_ratio, matcher=self.cfg.matcher,
                select=self.cfg.match_select,
            )
            prev_uv = self.kp[j]
            curr_uv = self.kp[i][idx1]
            valid = ok

        if self.cfg.reset_VO_to_identity or prior_angles is None:
            a0, t0 = jnp.zeros(3), jnp.zeros(3)
        else:
            a0 = jnp.asarray(prior_angles, jnp.float32)
            t0 = jnp.asarray(prior_t, jnp.float32)
        angles, t, n32, n22 = solve_vo(
            prev_uv, curr_uv, valid, self.grids[j], self.K, a0, t0, self.cfg
        )
        self.angles = np.asarray(angles, np.float64)
        self.t = np.asarray(t, np.float64)
        self.stats = {"n32": int(n32), "n22": int(n22)}
        # kept for the debug-image renderers (reference visualize_* flags)
        self.last_matches = (np.asarray(prev_uv), np.asarray(curr_uv),
                             np.asarray(valid))
        return self.angles, self.t

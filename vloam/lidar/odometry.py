"""Frame-to-frame laser odometry (A-LOAM laserOdometry) as fixed-shape JAX.

Reimplements reference src/lidar_odometry_mapping/src/laser_odometry.cpp
solveLO() (:187-536): two outer rounds of {correspondence search, 4 LM
iterations} over point-to-line (LidarEdgeFactor, lidarFactor.hpp:14-56) and
point-to-plane (LidarPlaneFactor, lidarFactor.hpp:58-106) residuals, with
Huber(0.1) loss and a quaternion-local parameterization.

Device mapping:
- KD-tree NN + ring-directional scans -> EXACT per-ring-min reduction over
  sentinel-padded ring slabs (ring_assoc.ring_slab_assoc): every reference
  pick is a function of per-ring distance minima, fused so the [Q, C]
  distance matrix never reaches device memory,
- Ceres LM -> solver.lm batched IRLS-LM with jacfwd Jacobians,
- DISTORTION=false (laser_odometry.h:90): TransformToStart applies the full
  transform (s=1), so the slerp fraction drops out.

The (q, t) parameters transform a current-frame point into the last frame:
lp = R(q) p + t (TransformToStart, :149-167).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import LaserOdometryConfig
from ..geometry import so3
from ..solver.lm import ResidualFamily, lm_solve
from .ring_assoc import RingSlab, ring_slab_assoc
from .types import FeatureCloud, ScanFeatures

_EPS = 1e-9


def _pack(q, t):
    return jnp.concatenate([q, t])


def _unpack(x):
    return x[:4], x[4:]


def _retract(x, delta):
    q, t = _unpack(x)
    qn = so3.quat_normalize(so3.quat_multiply(q, so3.quat_from_axis_angle(delta[:3])))
    return _pack(qn, t + delta[3:])


def _deskew_fraction(cloud: FeatureCloud, cfg: LaserOdometryConfig):
    """Interpolation fraction s per point (reference TransformToStart,
    laser_odometry.cpp:149-158): rel_time/scan_period when DISTORTION,
    else 1."""
    if cfg.distortion:
        return jnp.clip(cloud.rel_time, 0.0, 1.0)[:, None]
    return None  # s == 1: full transform, skip the slerp


def _transform_to_start(q, t, pts, s):
    """Apply slerp(I, q, s), s*t per point (lidarFactor.hpp:29-32);
    s=None means s==1 (DISTORTION=false fast path)."""
    if s is None:
        return so3.quat_rotate(q, pts) + t
    w = so3.axis_angle_from_quat(q)
    q_s = so3.quat_from_axis_angle(s * w)
    return so3.quat_rotate(q_s, pts) + s * t


def associate_corners(
    sharp: FeatureCloud, corner_last: RingSlab, x, cfg: LaserOdometryConfig
):
    """Edge correspondences: nearest last-frame corner + nearest corner on a
    different nearby ring (reference :266-350)."""
    q, t = _unpack(x)
    p_hat = _transform_to_start(q, t, sharp.xyz, _deskew_fraction(sharp, cfg))
    res = ring_slab_assoc(p_hat, corner_last, cfg.nearby_scan, mode="corner")
    thr = cfg.distance_sq_threshold
    valid = sharp.mask & (res["d0"] < thr) & (res["d2"] < thr)
    a = res["p0"]
    b = res["p2"]
    de = jnp.linalg.norm(a - b, axis=-1)
    valid = valid & (de > 1e-6)
    return a, b, de, valid


def associate_surfs(
    flat: FeatureCloud, surf_last: RingSlab, x, cfg: LaserOdometryConfig
):
    """Plane correspondences: nearest j + same-ring l + other-ring m
    (reference :353-444)."""
    q, t = _unpack(x)
    p_hat = _transform_to_start(q, t, flat.xyz, _deskew_fraction(flat, cfg))
    res = ring_slab_assoc(p_hat, surf_last, cfg.nearby_scan, mode="surf")
    thr = cfg.distance_sq_threshold
    valid = (
        flat.mask & (res["d0"] < thr) & (res["d2"] < thr) & (res["d3"] < thr)
    )
    pj = res["p0"]
    pl = res["p3"]  # same ring
    pm = res["p2"]  # neighboring ring
    n = jnp.cross(pj - pl, pj - pm)
    nn = jnp.linalg.norm(n, axis=-1, keepdims=True)
    valid = valid & (nn[:, 0] > 1e-6)
    n_hat = n / jnp.maximum(nn, _EPS)
    return pj, n_hat, valid


@partial(jax.jit, static_argnames=("cfg",))
def solve_lo(
    sharp: FeatureCloud,
    flat: FeatureCloud,
    corner_last: RingSlab,
    surf_last: RingSlab,
    q_init: jnp.ndarray,
    t_init: jnp.ndarray,
    cfg: LaserOdometryConfig,
):
    """Two rounds x 4 LM iterations; returns (q_last_curr, t_last_curr,
    n_corner_corr, n_plane_corr)."""
    x = _pack(q_init, t_init)
    n_c = jnp.int32(0)
    n_s = jnp.int32(0)
    B_c = sharp.xyz.shape[0]
    is_edge = (jnp.arange(B_c + flat.xyz.shape[0]) < B_c)[:, None]
    cp = jnp.concatenate([sharp.xyz, flat.xyz])
    for _ in range(cfg.outer_rounds):
        a, b, de, v_c = associate_corners(sharp, corner_last, x, cfg)
        pj, n_hat, v_s = associate_surfs(flat, surf_last, x, cfg)
        n_c = jnp.sum(v_c.astype(jnp.int32))
        n_s = jnp.sum(v_s.astype(jnp.int32))
        if cfg.distortion:
            s = jnp.concatenate([_deskew_fraction(sharp, cfg),
                                 _deskew_fraction(flat, cfg)])
        else:
            s = None
        # ONE fused residual family [B_c + B_s, 3]: plane residuals ride in
        # slot 0 with zero-padded slots 1-2 (identical Huber block norms;
        # lidarFactor.hpp's edge residual is 3-vector, plane is scalar).
        # One family = one residual eval + one jacfwd + one cost per LM
        # iteration instead of two of each — the LM loop is a serialized
        # latency chain of small ops on this hardware, not FLOP-bound.
        A = jnp.concatenate([a, jnp.zeros_like(pj)])
        Bp = jnp.concatenate([b, jnp.zeros_like(pj)])
        DE = jnp.concatenate([de, jnp.ones(pj.shape[0], de.dtype)])
        PJ = jnp.concatenate([jnp.zeros_like(a), pj])
        NH = jnp.concatenate([jnp.zeros_like(a), n_hat])
        w = jnp.concatenate([v_c, v_s]).astype(jnp.float32)

        def make_families(xx):
            qq, tt = _unpack(xx)

            def fused_fn(delta):
                qd = so3.quat_multiply(qq, so3.quat_from_axis_angle(delta[:3]))
                td = tt + delta[3:]
                lp = _transform_to_start(qd, td, cp, s)
                r_edge = jnp.cross(lp - A, lp - Bp) / jnp.maximum(
                    DE, _EPS)[:, None]
                r_plane = jnp.sum((lp - PJ) * NH, axis=-1)
                e0 = jnp.asarray([1.0, 0.0, 0.0], lp.dtype)
                return jnp.where(is_edge, r_edge, r_plane[:, None] * e0)

            return [ResidualFamily(fused_fn, w)]

        x = lm_solve(make_families, _retract, x, dim=6,
                     iterations=cfg.gn_iterations, huber_delta=cfg.huber_delta)
    q, t = _unpack(x)
    return q, t, n_c, n_s


class LaserOdometry:
    """Host-side wrapper holding the frame chain state (reference
    LaserOdometry class fields, laser_odometry.h:96-146). World pose is
    accumulated in float64 on host to avoid drift over thousands of frames."""

    def __init__(self, cfg: LaserOdometryConfig):
        import numpy as np

        self.cfg = cfg
        self.np = np
        self.initialized = False
        self.corner_last: RingSlab | None = None
        self.surf_last: RingSlab | None = None
        self.q_w = np.array([0.0, 0.0, 0.0, 1.0])
        self.t_w = np.zeros(3)
        self.q_f2f = np.array([0.0, 0.0, 0.0, 1.0])
        self.t_f2f = np.zeros(3)
        self.frame_count = 0
        self.n_corner = 0
        self.n_surf = 0

    def step(self, feats: ScanFeatures, prior_q=None, prior_t=None):
        """Process one frame's features. prior_(q,t): optional VO seed
        (reference :223-236, used when detach_VO_LO=false)."""
        np = self.np
        if not self.initialized:
            self.initialized = True
        else:
            if prior_q is not None:
                q0 = jnp.asarray(prior_q, jnp.float32)
                t0 = jnp.asarray(prior_t, jnp.float32)
            else:
                q0 = jnp.asarray(self.q_f2f, jnp.float32)
                t0 = jnp.asarray(self.t_f2f, jnp.float32)
            q, t, n_c, n_s = solve_lo(
                feats.sharp, feats.flat, self.corner_last, self.surf_last,
                q0, t0, self.cfg,
            )
            q = np.asarray(q, np.float64)
            t = np.asarray(t, np.float64)
            self.n_corner, self.n_surf = int(n_c), int(n_s)
            if self.n_corner + self.n_surf < self.cfg.min_correspondences:
                import logging

                logging.getLogger("vloam").warning(
                    "less correspondence! %d corner + %d surf < %d at "
                    "frame %d (reference laser_odometry.cpp:452-455)",
                    self.n_corner, self.n_surf,
                    self.cfg.min_correspondences, self.frame_count)
            self.q_f2f, self.t_f2f = q, t
            # world accumulation (reference :477-478)
            from scipy.spatial.transform import Rotation as R

            rw = R.from_quat(self.q_w)
            self.t_w = self.t_w + rw.apply(t)
            self.q_w = (rw * R.from_quat(q)).as_quat()
        # swap feature clouds into "last" (reference :511-526)
        self.corner_last = feats.less_sharp_slab
        self.surf_last = feats.less_flat_slab
        self.frame_count += 1
        skip_frame = ((self.frame_count - 1) % self.cfg.mapping_skip_frame) != 0
        return {
            "q_f2f": self.q_f2f,
            "t_f2f": self.t_f2f,
            "q_w": self.q_w,
            "t_w": self.t_w,
            "skip_frame": skip_frame,
        }

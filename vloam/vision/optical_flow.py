"""Pyramidal Lucas-Kanade optical flow, vectorized over keypoints.

Fixed-shape replacement for cv::calcOpticalFlowPyrLK (reference
image_util.cpp:351-372: window 15x15, maxLevel 2, 10 iterations).
The per-keypoint iteration is a fori_loop; keypoints are vmapped; patch
sampling is bilinear gather. Gradients are taken on the first image
(classic KLT), so the iteration matrix G is computed once per level.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import VisualOdometryConfig


def _bilinear(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Sample img [H, W] at float coords (x, y) arrays."""
    h, w = img.shape
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, h - 2)
    fx = jnp.clip(x - x0, 0.0, 1.0)
    fy = jnp.clip(y - y0, 0.0, 1.0)
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return (
        i00 * (1 - fx) * (1 - fy)
        + i01 * fx * (1 - fy)
        + i10 * (1 - fx) * fy
        + i11 * fx * fy
    )


def build_pyramid(img: jnp.ndarray, levels: int) -> list[jnp.ndarray]:
    """Gaussian-ish pyramid by 2x2 average pooling per level."""
    pyr = [img]
    cur = img
    for _ in range(levels - 1):
        h, w = cur.shape
        h2, w2 = h // 2 * 2, w // 2 * 2
        cur = cur[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3))
        pyr.append(cur)
    return pyr


@partial(jax.jit, static_argnames=("cfg",))
def lk_flow(
    img0: jnp.ndarray,
    img1: jnp.ndarray,
    xy0: jnp.ndarray,  # [K, 2] keypoints in img0
    cfg: VisualOdometryConfig,
):
    """Track xy0 from img0 into img1. Returns (xy1 [K,2], status [K])."""
    levels = cfg.flow_levels
    win = cfg.flow_window
    r = win // 2
    offs = jnp.arange(win) - r
    oy, ox = jnp.meshgrid(offs, offs, indexing="ij")
    ox = ox.astype(jnp.float32).reshape(-1)
    oy = oy.astype(jnp.float32).reshape(-1)

    pyr0 = build_pyramid(img0, levels)
    pyr1 = build_pyramid(img1, levels)

    def track_level(p0_lvl, p1_lvl, xy_level0, guess, scale, check_bounds):
        """xy_level0: keypoint in level-0 coords; guess: current flow estimate
        in level-0 coords; returns refined guess + validity."""
        kp = xy_level0 / scale

        def one(kp_i, g_i):
            x0 = kp_i[0] + ox
            y0 = kp_i[1] + oy
            t = _bilinear(p0_lvl, x0, y0)
            gx = 0.5 * (_bilinear(p0_lvl, x0 + 1, y0) - _bilinear(p0_lvl, x0 - 1, y0))
            gy = 0.5 * (_bilinear(p0_lvl, x0, y0 + 1) - _bilinear(p0_lvl, x0, y0 - 1))
            gxx = jnp.sum(gx * gx)
            gxy = jnp.sum(gx * gy)
            gyy = jnp.sum(gy * gy)
            det = gxx * gyy - gxy * gxy
            ok = det > 1e-6
            inv = jnp.where(ok, 1.0 / jnp.maximum(det, 1e-12), 0.0)

            def body(_, g):
                x1 = kp_i[0] + g[0] / scale + ox
                y1 = kp_i[1] + g[1] / scale + oy
                diff = t - _bilinear(p1_lvl, x1, y1)
                bx = jnp.sum(diff * gx)
                by = jnp.sum(diff * gy)
                dx = inv * (gyy * bx - gxy * by)
                dy = inv * (-gxy * bx + gxx * by)
                return g + jnp.stack([dx, dy]) * scale

            g = jax.lax.fori_loop(0, cfg.flow_iterations, body, g_i)
            h, w = p1_lvl.shape
            x1 = kp_i[0] + g[0] / scale
            y1 = kp_i[1] + g[1] / scale
            # Bounds only matter at the finest level (coarse levels clamp);
            # rejecting at every level would discard most of a short image.
            inside = (x1 > r) & (x1 < w - r - 1) & (y1 > r) & (y1 < h - r - 1)
            return g, ok & (inside | jnp.logical_not(check_bounds))

        return jax.vmap(one)(kp, guess)

    guess = jnp.zeros_like(xy0)
    status = jnp.ones(xy0.shape[0], bool)
    for lvl in range(levels - 1, -1, -1):
        scale = float(2**lvl)
        guess, ok = track_level(pyr0[lvl], pyr1[lvl], xy0, guess, scale,
                                jnp.bool_(lvl == 0))
        status = status & ok
    return xy0 + guess, status

"""LiDAR -> camera depth association (DEMO-style).

Reimplements reference src/visual_odometry/src/point_cloud_util.cpp:
- projectPointCloud (:148-174): X_tilde * camTvelo^T * rect0Tcam^T * P^T,
  front-filter depth > 0.1,
- downsamplePointCloud (:205-260): 5-px bucket grid averaging (the reference
  uses a quirky incremental update that overweights late points; we compute
  the true bucket mean — the difference is sub-pixel noise),
- queryDepth (:302-407): gather the (2r+1)^2 bucket window, require >= 10
  non-empty neighbors, inverse-distance-weight the 3 nearest:
  z = sum_i z_i * prod_{j != i} d_j / (1e-4 + sum_i prod_{j != i} d_j).

All ops are scatter/gather over a fixed [W/g, H/g] grid — jit-native.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import VisualOdometryConfig


class DepthGrid(NamedTuple):
    u: jnp.ndarray  # [GW, GH] mean pixel x per bucket
    v: jnp.ndarray  # [GW, GH]
    z: jnp.ndarray  # [GW, GH] mean depth
    cnt: jnp.ndarray  # [GW, GH] int32


def grid_shape(cfg: VisualOdometryConfig) -> tuple[int, int]:
    g = cfg.downsample_grid_size
    return (-(-cfg.img_width // g), -(-cfg.img_height // g))


@partial(jax.jit, static_argnames=("cfg",))
def build_depth_grid(
    pts_velo: jnp.ndarray,  # [N, 3] velodyne-frame points
    mask: jnp.ndarray,  # [N]
    P_velo_to_img: jnp.ndarray,  # [3, 4] = P_rect0 @ rect0_T_cam @ cam_T_velo
    cfg: VisualOdometryConfig,
) -> DepthGrid:
    gw, gh = grid_shape(cfg)
    g = cfg.downsample_grid_size
    ph = (jnp.matmul(pts_velo, P_velo_to_img[:, :3].T, precision="highest")
          + P_velo_to_img[:, 3])
    z = ph[:, 2]
    front = mask & (z > cfg.min_depth)
    u = ph[:, 0] / jnp.where(front, z, 1.0)
    v = ph[:, 1] / jnp.where(front, z, 1.0)
    ix = jnp.floor(u / g).astype(jnp.int32)
    iy = jnp.floor(v / g).astype(jnp.int32)
    ok = front & (ix >= 0) & (ix < gw) & (iy >= 0) & (iy < gh)
    ix = jnp.where(ok, ix, gw)  # out-of-range -> dropped
    iy = jnp.where(ok, iy, gh)
    w = ok.astype(jnp.float32)
    # ONE 4-channel scatter-add instead of four. Duplicate indices make the
    # sums' order (atomics) vary from run to run on a GPU.
    vals = jnp.stack([u * w, v * w, z * w, w], axis=1)  # [N, 4]
    acc = jnp.zeros((gw + 1, gh + 1, 4), jnp.float32).at[ix, iy].add(
        vals, mode="drop")
    denom = jnp.maximum(acc[..., 3], 1.0)
    return DepthGrid(
        u=(acc[..., 0] / denom)[:gw, :gh],
        v=(acc[..., 1] / denom)[:gw, :gh],
        z=(acc[..., 2] / denom)[:gw, :gh],
        cnt=acc[:gw, :gh, 3].astype(jnp.int32),
    )


@partial(jax.jit, static_argnames=("cfg",))
def query_depth(
    grid: DepthGrid, xy: jnp.ndarray, cfg: VisualOdometryConfig
) -> jnp.ndarray:
    """Vectorized queryDepth over [Q, 2] pixel coords. Returns [Q] depth,
    -1 where the neighborhood is too sparse (reference :336-338).

    The (2r+1)^2 bucket window is fetched with ONE batched flat gather of
    [Q, win^2, 4] (all four planes interleaved in the minor dim — separate
    per-plane gathers pay the index lookups 4x; a vmapped dynamic_slice
    form serializes thousands of tiny slices)."""
    g = cfg.downsample_grid_size
    r = cfg.depth_search_radius
    win = 2 * r + 1
    gw, gh = grid.u.shape
    ph = gh + 2 * r

    pad = ((r, r), (r, r))
    planes = jnp.stack([
        jnp.pad(grid.u, pad), jnp.pad(grid.v, pad), jnp.pad(grid.z, pad),
        jnp.pad(grid.cnt.astype(jnp.float32), pad),
    ], axis=-1).reshape(-1, 4)

    x, y = xy[:, 0], xy[:, 1]
    ix = jnp.clip(jnp.floor(x / g).astype(jnp.int32), 0, gw - 1)
    iy = jnp.clip(jnp.floor(y / g).astype(jnp.int32), 0, gh - 1)
    dx, dy = jnp.meshgrid(jnp.arange(win), jnp.arange(win), indexing="ij")
    off = (dx.reshape(-1) * ph + dy.reshape(-1)).astype(jnp.int32)
    flat = (ix * ph + iy)[:, None] + off[None, :]  # [Q, win^2]

    wall = planes[flat]  # [Q, win^2, 4]
    wu, wv, wz = wall[..., 0], wall[..., 1], wall[..., 2]
    # padding cells have cnt == 0, replicating the reference's bounds check
    ok = wall[..., 3] > 0
    n_ok = jnp.sum(ok.astype(jnp.int32), axis=1)
    dist = jnp.sqrt((x[:, None] - wu) ** 2 + (y[:, None] - wv) ** 2)
    dist = jnp.where(ok, dist, jnp.inf)
    nd, ni = jax.lax.top_k(-dist, 3)
    d3 = -nd  # [Q, 3]
    z3 = jnp.take_along_axis(wz, ni, axis=1)
    num = (
        z3[:, 0] * d3[:, 1] * d3[:, 2]
        + z3[:, 1] * d3[:, 0] * d3[:, 2]
        + z3[:, 2] * d3[:, 0] * d3[:, 1]
    )
    den = (1e-4 + d3[:, 1] * d3[:, 2] + d3[:, 0] * d3[:, 2]
           + d3[:, 0] * d3[:, 1])
    z = num / den
    ok_q = n_ok >= cfg.min_depth_neighbors
    if cfg.max_depth_spread > 0:
        # reject depth-discontinuity neighborhoods: blending buckets
        # from different surfaces biases X0 and tilts the 3D-2D solve
        spread = jnp.max(z3, axis=1) - jnp.min(z3, axis=1)
        ok_q = ok_q & (spread <= cfg.max_depth_spread)
    return jnp.where(ok_q, z, -1.0)

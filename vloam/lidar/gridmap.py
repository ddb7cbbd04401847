"""Incremental hashed cell-slab map (the fixed-shape replacement for the reference's
21x21x11 cube array + per-cube pcl::VoxelGrid + KdTreeFLANN, reference
src/lidar_odometry_mapping/src/laser_mapping.cpp:207-440,477,543,688-702).

The key idea: the map's STORAGE LAYOUT is the k-NN acceleration structure,
maintained incrementally — nothing is rebuilt per frame.

- Points live in PLANAR bucket slabs `[3, n_buckets, cap]` (x/y/z planes);
  a point's bucket is a hash of its `cell`-sized grid cell. Planar layout
  matters: with xyz in the minor dimension every distance op strides over a
  3-wide axis; planar puts the 8*cap candidate axis in the contiguous minor
  dimension. Slabs are SENTINEL-padded so queries
  need no mask gathers: sentinel distances ~1e12 lose every comparison and
  fail the 1 m acceptance gate naturally.
- INSERT (per frame, reference :638-686) sorts only the ~4-16k NEW stack
  points by bucket (not the ~300k-point neighborhood), drops any point whose
  map-resolution voxel is already occupied in its bucket (first observation
  wins), and scatters the rest into the buckets' free slots. This
  subsumes the reference's per-cube voxel re-filter (:688-702): the map
  holds at most one point per voxel BY CONSTRUCTION. Difference vs pcl
  VoxelGrid: the kept point is the first-observed sample, not the running
  centroid — below the association noise floor at 0.4/0.8 m resolutions.
- QUERY (the KdTreeFLANN 5-NN at :477,:543) probes the 8 cells that can
  contain any neighbor within radius cell/2 (per axis, the query's own cell
  plus the nearer neighbor cell), gathers 8 slab rows per query per plane,
  and top-k's the <=8*cap candidates. With cell >= 2 * search radius this is
  EXACT within the radius gate.
- EVICT (the reference's cube-shift recentering, :207-402) runs only when
  the pose crosses a cube boundary: one elementwise pass marks points
  outside the reference's window extent (w/2, h/2, d/2 cubes from center)
  as sentinels. Slots are never compacted — insert fills holes via a
  per-row free-slot scan — so eviction is one elementwise pass, not the
  per-bucket sort/scatter compaction of the full map.

Hash collisions only ADD candidates (two far cells sharing a bucket), never
remove them; a bucket shared by k live cells effectively splits its
capacity k ways (points beyond capacity are dropped, as the reference drops
points beyond its cube bounds).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

# far-away but finite: squared distances stay ~1e12 (no inf-inf NaN traps)
SENTINEL = 1.0e6


def _hash_cell(ix, iy, iz, n_buckets):
    u = jnp.uint32
    h = (ix.astype(u) * u(73856093)) + (iy.astype(u) * u(19349669)) + (
        iz.astype(u) * u(83492791))
    h = h ^ (h >> u(16))
    h = h * u(0x85EBCA6B)
    h = h ^ (h >> u(13))
    return (h & u(n_buckets - 1)).astype(jnp.int32)


class FeatureGrid(NamedTuple):
    """One feature class's map: SENTINEL-padded bucket rows + a global live
    count. Slots are not kept contiguous (evict leaves holes; insert fills
    them); `n_live` is the total number of live points, used only for the
    'enough map' gates and stats (a per-bucket count array would cost two
    O(n_buckets) bincount scatters per insert just to maintain).

    Row layout is INTERLEAVED: row b = [x_0..x_cap | y_0..y_cap | z_0..z_cap]
    so one row gather fetches all three coordinate planes of a bucket. The
    8-cell probe gather fetches 8 rows per query instead of the planar
    [3, nb, cap] layout's 24."""

    pts: jnp.ndarray  # [n_buckets, 3*cap] f32 interleaved x|y|z blocks
    n_live: jnp.ndarray  # [] int32 total live points

    @property
    def cap(self) -> int:
        return self.pts.shape[1] // 3


def grid_create(n_buckets: int, cap: int) -> FeatureGrid:
    return FeatureGrid(
        pts=jnp.full((n_buckets, 3 * cap), SENTINEL, jnp.float32),
        n_live=jnp.int32(0),
    )


def _bucket_of(p: jnp.ndarray, cell: float, n_buckets: int) -> jnp.ndarray:
    c = jnp.floor(p / cell).astype(jnp.int32)
    return _hash_cell(c[..., 0], c[..., 1], c[..., 2], n_buckets)


@partial(jax.jit, static_argnames=("cell", "res"))
def grid_insert(g: FeatureGrid, p: jnp.ndarray, mask: jnp.ndarray,
                cell: float, res: float) -> FeatureGrid:
    """Insert world points `p [B,3]` (mask [B]) with voxel dedup at `res`.

    `cell` must be an integer multiple of `res` (so a voxel never straddles
    a cell boundary and the per-bucket dup check is complete)."""
    nb, cap = g.pts.shape[0], g.cap
    B = p.shape[0]
    b = _bucket_of(p, cell, nb)  # [B]
    v = jnp.floor(p.T / res).astype(jnp.int32)  # [3, B]
    rows = g.pts[b]  # [B, 3*cap] (one interleaved gather)
    slab = jnp.stack([rows[:, 0 * cap:1 * cap], rows[:, 1 * cap:2 * cap],
                      rows[:, 2 * cap:3 * cap]])  # [3, B, cap]
    sv = jnp.floor(slab / res).astype(jnp.int32)
    dup = jnp.any(jnp.all(sv == v[:, :, None], axis=0), axis=-1)
    keep = mask & ~dup
    key = jnp.where(keep, b, nb)
    order = jnp.argsort(key)  # stable
    ks = key[order]
    # within-bucket rank straight from the sorted keys (segment starts via
    # cummax over boundary positions) — O(frame); the previous
    # bincount/cumsum-over-buckets form cost two O(n_buckets) passes
    idx = jnp.arange(B, dtype=jnp.int32)
    boundary = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    seg_start = jax.lax.cummax(jnp.where(boundary, idx, -1))
    rank = idx - seg_start
    # destination = (rank+1)-th FREE slot of the bucket row. Buckets may
    # have holes (grid_evict only marks sentinels, never compacts — O(map)
    # compaction; this per-row scan is O(frame)).
    free = slab[0][order] > SENTINEL * 0.5  # [B, cap]
    fcsum = jnp.cumsum(free, axis=1).astype(jnp.int32)
    ge = fcsum >= (rank + 1)[:, None]
    pos = jnp.argmax(ge, axis=1).astype(jnp.int32)
    ok = (ks < nb) & (rank < fcsum[:, -1])
    dest_b = jnp.where(ok, ks, nb)  # nb = out of bounds -> dropped
    cols = jnp.stack([pos, pos + cap, pos + 2 * cap], axis=1)  # [B, 3]
    pts = g.pts.at[dest_b[:, None], cols].set(p[order], mode="drop")
    return FeatureGrid(pts=pts,
                       n_live=g.n_live + jnp.sum(ok, dtype=jnp.int32))


@jax.jit
def grid_evict(g: FeatureGrid, center: jnp.ndarray,
               radius: jnp.ndarray) -> FeatureGrid:
    """Drop points outside the box center +- radius (both [3], meters):
    one elementwise pass marking sentinels. Slots are NOT compacted —
    grid_insert fills holes — so eviction is one elementwise pass instead
    of a per-bucket compaction (sort or scatter) of the full map."""
    cap = g.cap
    xyz = g.pts.reshape(-1, 3, cap)  # [nb, 3, cap]
    live = xyz[:, 0] < SENTINEL * 0.5
    inside = jnp.all(
        jnp.abs(xyz - center[None, :, None]) <= radius[None, :, None],
        axis=1)  # [nb, cap]
    keep = live & inside
    pts = jnp.where(keep[:, None, :], xyz, SENTINEL).reshape(-1, 3 * cap)
    return FeatureGrid(pts=pts, n_live=jnp.sum(keep, dtype=jnp.int32))


@partial(jax.jit, static_argnames=("cell",))
def grid_gather(g: FeatureGrid, queries: jnp.ndarray, cell: float):
    """Gather each query's 8-cell probe candidates: [3, Q, 8*cap] planar.
    The gather is the expensive half of a k-NN query (random bucket rows
    from HBM); callers that re-select under a slightly moved pose can reuse
    one gather across solver rounds (see mapping.solve_mapping)."""
    nb, cap = g.pts.shape[0], g.cap
    q = queries.shape[0]
    s = queries / cell
    c = jnp.floor(s).astype(jnp.int32)
    off = jnp.where(s - c < 0.5, -1, 1).astype(jnp.int32)  # [Q, 3]
    hs = []
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                hs.append(_hash_cell(c[:, 0] + sx * off[:, 0],
                                     c[:, 1] + sy * off[:, 1],
                                     c[:, 2] + sz * off[:, 2], nb))
    buckets = jnp.stack(hs, axis=1)  # [Q, 8]
    rows = g.pts[buckets]  # [Q, 8, 3*cap] — 8 interleaved row gathers/query
    planar = rows.reshape(q, 8, 3, cap)
    return jnp.moveaxis(planar, 2, 0).reshape(3, q, 8 * cap)


def knn_among_planar(cand: jnp.ndarray, queries: jnp.ndarray, k: int = 5):
    """k-NN among pre-gathered planar candidates [3, Q, C].
    Returns (d_sq [Q,k] ascending, near [3, Q, k] PLANAR); sentinel-padded
    slots return d_sq ~1e12 and lose every comparison. Consumers should
    stay in the planar layout: transposing to [Q, k, 3] materializes a
    copy with a 3-wide minor axis."""
    diff = cand - queries.T[:, :, None]
    d = jnp.sum(diff * diff, axis=0)  # [Q, C], lanes on candidates
    nd, ni = jax.lax.top_k(-d, k)
    near = jnp.take_along_axis(cand, ni[None, :, :], axis=2)  # [3, Q, k]
    return -nd, near


def knn_among(cand: jnp.ndarray, queries: jnp.ndarray, k: int = 5):
    """knn_among_planar with the xyz-minor [Q, k, 3] output (interactive /
    test convenience; hot paths use the planar form directly)."""
    d, near = knn_among_planar(cand, queries, k)
    return d, jnp.moveaxis(near, 0, 2)


@partial(jax.jit, static_argnames=("cell", "k"))
def grid_knn(g: FeatureGrid, queries: jnp.ndarray, cell: float, k: int = 5):
    """k-NN among points within the 8-cell probe — exact for true neighbors
    closer than cell/2. Returns (d_sq [Q,k] ascending, near [Q,k,3]); slots
    beyond the candidate count return sentinel points with d_sq ~1e12."""
    return knn_among(grid_gather(g, queries, cell), queries, k)


@jax.jit
def grid_flat_points(g: FeatureGrid):
    """All map slots as a flat device array [n_buckets*cap, 3] + live mask
    (sentinel slots masked False). This is the 'map blocks' view the
    mesh-distributed mapping path shards over devices: consecutive slot
    ranges = consecutive hash buckets = spatial cell blocks
    (parallel/mesh_pipeline.py); no download, just a reshape."""
    cap = g.cap
    xyz = g.pts.reshape(-1, 3, cap)  # [nb, 3, cap]
    pts = jnp.moveaxis(xyz, 1, 2).reshape(-1, 3)
    live = pts[:, 0] < SENTINEL * 0.5
    return pts, live


def grid_export(g: FeatureGrid, max_points: int | None = None):
    """Download live points as a numpy [M, 3] array (one masked download)."""
    import numpy as np

    cap = g.cap
    pts = np.asarray(g.pts).reshape(-1, 3, cap).transpose(0, 2, 1).reshape(-1, 3)
    live = pts[:, 0] < SENTINEL * 0.5
    out = pts[live]
    return out[:max_points] if max_points is not None else out

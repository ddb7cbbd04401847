"""Voxel-grid downsampling with static shapes (fixed-shape replacement for
pcl::VoxelGrid, reference scan_registration.cpp:433-439 and
laser_mapping.cpp:432-440, 688-702).

Strategy: quantize -> hash -> sort by hash -> segment mean -> compact.
Everything is O(N log N) XLA sort + segment ops; no data-dependent shapes.
Voxels are identified by a 32-bit hash of the integer cell coords (plus an
optional partition id, e.g. the scan ring); hash collisions merge far-apart
points into one centroid, which is statistically negligible at these sizes
(~1e-3 expected collisions per 100k points) and harmless downstream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_P1, _P2, _P3, _P4 = 73856093, 19349669, 83492791, 2654435761


def _hash_cells(ix, iy, iz, part):
    """Murmur3-finalized spatial hash: the plain xor-of-products hash has
    ~40% collisions on small coordinate ranges; the avalanche finalizer
    brings it to the ~N^2/2^32 birthday bound."""
    u = jnp.uint32
    h = (
        (ix.astype(u) * u(_P1))
        + (iy.astype(u) * u(_P2))
        + (iz.astype(u) * u(_P3))
        + (part.astype(u) * u(_P4))
    )
    h = h ^ (h >> u(16))
    h = h * u(0x85EBCA6B)
    h = h ^ (h >> u(13))
    h = h * u(0xC2B2AE35)
    h = h ^ (h >> u(16))
    return h


def _segment_tail(hs, xs, es, ps, ms, out_cap, n_extra, dtype):
    """Shared post-sort reduction: segment-mean runs of equal hash keys.
    Inputs are hash-sorted flat arrays (equal keys adjacent; valid points
    form a prefix because invalid hashes sort to the global tail).

    SCATTER-FREE: a scatter-add with duplicate indices serializes on the
    colliding slots (and is nondeterministic with atomics), and
    jnp.searchsorted lowers to a while loop of gathers. Since equal keys are
    adjacent and valid
    segments are contiguous from position 0, segment j's sum is the
    difference of the inclusive prefix sum at consecutive segment ENDS:
    cumsum + ONE compaction sort (key = segment id at end elements, +inf
    elsewhere) + adjacent difference — all dense vector/sort ops.
    Coordinates are centered on the valid-point mean before the prefix sum
    so the f32 difference-of-prefix error stays ~1e-4 m (a raw cumsum of
    80 m coordinates over 32k points would lose ~0.25 m to cancellation)."""
    is_start = jnp.concatenate([jnp.ones((1,), bool), hs[1:] != hs[:-1]]) & ms
    seg_id = jnp.cumsum(is_start.astype(jnp.int32)) - 1  # -1 until first valid
    n_seg = jnp.max(jnp.where(ms, seg_id + 1, 0))
    nxt_start = jnp.concatenate([is_start[1:], jnp.ones((1,), bool)])
    nxt_ms = jnp.concatenate([ms[1:], jnp.zeros((1,), bool)])
    is_end = ms & (nxt_start | ~nxt_ms)  # last element of each segment

    ones = ms.astype(dtype)
    cnt_valid = jnp.maximum(jnp.sum(ones), 1.0)
    center = jnp.sum(xs * ones[:, None], axis=0) / cnt_valid  # [3]
    chans = [ones, (xs[:, 0] - center[0]) * ones,
             (xs[:, 1] - center[1]) * ones, (xs[:, 2] - center[2]) * ones]
    chans += [es[:, j] * ones for j in range(n_extra)]
    cs = [jnp.cumsum(c) for c in chans]

    key = jnp.where(is_end, seg_id, jnp.int32(2**30))
    sorted2 = jax.lax.sort((key, *cs, ps), num_keys=1)
    m = min(out_cap, key.shape[0])
    pad = out_cap - m
    ends_cs = [jnp.pad(o[:m], (0, pad)) for o in sorted2[1:1 + len(cs)]]
    prev = [jnp.concatenate([jnp.zeros((1,), c.dtype), c[:-1]])
            for c in ends_cs]
    sums = jnp.stack([c - p for c, p in zip(ends_cs, prev)], axis=1)
    occupied = jnp.arange(out_cap) < jnp.minimum(n_seg, out_cap)
    sums = jnp.where(occupied[:, None], sums, 0.0)
    counts = sums[:, 0]
    denom = jnp.maximum(counts, 1.0)[:, None]
    out_xyz = sums[:, 1:4] / denom + jnp.where(
        occupied[:, None], center[None, :], 0.0)
    out_extra = sums[:, 4:4 + n_extra] / denom if n_extra else None

    # partition id of the voxel = any member's (constant within a voxel
    # when partition participates in the hash, modulo collisions).
    out_part = jnp.where(occupied, jnp.pad(sorted2[-1][:m], (0, pad)),
                         0).astype(jnp.int32)

    return out_xyz, out_extra, out_part, occupied


def voxel_downsample(
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    leaf: float,
    out_cap: int,
    partition: jnp.ndarray | None = None,
    extra: jnp.ndarray | None = None,
):
    """Centroid-downsample masked points into `out_cap` voxel centroids.

    partition: optional int32 [N]; points in different partitions never merge
      (used to reproduce the reference's per-ring VoxelGrid invocation).
    extra: optional [N, E] float features averaged alongside xyz.

    Returns (out_xyz [out_cap,3], out_extra [out_cap,E] or None,
             out_part [out_cap], out_mask [out_cap]).
    """
    n = xyz.shape[0]
    part = jnp.zeros((n,), jnp.int32) if partition is None else partition
    cell = jnp.floor(xyz / leaf).astype(jnp.int32)
    h = _hash_cells(cell[:, 0], cell[:, 1], cell[:, 2], part)
    # Invalid points hash to the max key so they sort to the tail.
    h = jnp.where(mask, h, jnp.uint32(0xFFFFFFFF))

    # Multi-operand lax.sort carries the payload through the sort network —
    # no post-sort gathers.
    n_extra = 0 if extra is None else extra.shape[1]
    operands = (h, xyz[:, 0], xyz[:, 1], xyz[:, 2],
                *(extra[:, j] for j in range(n_extra)),
                part, mask.astype(jnp.int32))
    sorted_ops = jax.lax.sort(operands, num_keys=1)
    hs = sorted_ops[0]
    xs = jnp.stack(sorted_ops[1:4], axis=1)
    es = (jnp.stack(sorted_ops[4:4 + n_extra], axis=1) if n_extra else None)
    ps = sorted_ops[4 + n_extra]
    ms = sorted_ops[5 + n_extra] > 0
    return _segment_tail(hs, xs, es, ps, ms, out_cap, n_extra, xyz.dtype)


def voxel_downsample_rows_slab(
    pts: jnp.ndarray,  # [S, R, 3] per-ring layout
    mask: jnp.ndarray,  # [S, R]
    leaf: float,
    ring_cap: int,
    extra: jnp.ndarray | None = None,  # [S, R, E]
):
    """Per-ring voxel downsample that KEEPS the per-ring slab layout:
    returns (xyz [S, ring_cap, 3], extra [S, ring_cap, E] | None,
    mask [S, ring_cap]) where row s holds ring s's voxel centroids as a
    dense prefix. This is the natural input layout for the per-ring
    association kernel (ring_assoc.py); rings with more than ring_cap
    voxels drop the tail (the flat variant's global cap truncates the same
    way, just globally)."""
    S, R = pts.shape[0], pts.shape[1]
    part = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[:, None], (S, R))
    cell = jnp.floor(pts / leaf).astype(jnp.int32)
    h = _hash_cells(cell[..., 0], cell[..., 1], cell[..., 2], part)
    h = jnp.where(mask, h, jnp.uint32(0xFFFFFFFF))

    n_extra = 0 if extra is None else extra.shape[2]
    operands = (h, pts[..., 0], pts[..., 1], pts[..., 2],
                *(extra[..., j] for j in range(n_extra)),
                mask.astype(jnp.int32))
    sorted_ops = jax.lax.sort(operands, num_keys=1, dimension=1)
    hs = sorted_ops[0]
    ms = sorted_ops[4 + n_extra] > 0
    # row-local segment ids: seg[s, j] = index of point j's voxel within
    # ring s. Valid points form each row's prefix (invalid hashes sort to
    # the row tail), so valid segments are contiguous runs from column 0 —
    # segment j's sum is the difference of the row-wise inclusive prefix
    # sum at consecutive segment ENDS, compacted to the row prefix by ONE
    # extra row-wise sort. SCATTER-FREE: the previous
    # segment_sum-into-32k-slots scatter serialized on duplicate indices,
    # and jnp.searchsorted is a binary-search while loop of gathers.
    # Coordinates are centered per row
    # before the prefix sum to keep the f32 difference-of-prefix error
    # ~1e-4 m.
    is_start = jnp.concatenate(
        [jnp.ones((S, 1), bool), hs[:, 1:] != hs[:, :-1]], axis=1) & ms
    seg = jnp.cumsum(is_start.astype(jnp.int32), axis=1) - 1
    n_seg = jnp.max(jnp.where(ms, seg, -1), axis=1) + 1  # [S]
    nxt_start = jnp.concatenate(
        [is_start[:, 1:], jnp.ones((S, 1), bool)], axis=1)
    nxt_ms = jnp.concatenate([ms[:, 1:], jnp.zeros((S, 1), bool)], axis=1)
    is_end = ms & (nxt_start | ~nxt_ms)

    ones = ms.astype(pts.dtype)
    cnt_valid = jnp.maximum(jnp.sum(ones, axis=1), 1.0)  # [S]
    center = jnp.stack(
        [jnp.sum(sorted_ops[1 + a] * ones, axis=1) / cnt_valid
         for a in range(3)], axis=1)  # [S, 3]
    chans = [ones] + [(sorted_ops[1 + a] - center[:, a:a + 1]) * ones
                      for a in range(3)]
    chans += [sorted_ops[4 + j] * ones for j in range(n_extra)]
    cs = [jnp.cumsum(c, axis=1) for c in chans]  # each [S, R]

    key = jnp.where(is_end, seg, jnp.int32(2**30))
    sorted2 = jax.lax.sort((key, *cs), num_keys=1, dimension=1)
    m = min(ring_cap, R)
    ends_cs = [jnp.pad(o[:, :m], ((0, 0), (0, ring_cap - m)))
               for o in sorted2[1:]]
    prev = [jnp.concatenate([jnp.zeros((S, 1), c.dtype), c[:, :-1]], axis=1)
            for c in ends_cs]
    sums = jnp.stack([c - p for c, p in zip(ends_cs, prev)],
                     axis=-1)  # [S, ring_cap, 4+E]
    out_mask = (jnp.arange(ring_cap)[None, :]
                < jnp.minimum(n_seg, ring_cap)[:, None])
    sums = jnp.where(out_mask[..., None], sums, 0.0)
    counts = sums[..., 0]
    denom = jnp.maximum(counts, 1.0)[..., None]
    out_xyz = sums[..., 1:4] / denom + jnp.where(
        out_mask[..., None], center[:, None, :], 0.0)
    out_extra = sums[..., 4:4 + n_extra] / denom if n_extra else None
    return out_xyz, out_extra, out_mask

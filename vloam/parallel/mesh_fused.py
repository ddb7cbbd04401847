"""Distributed BA inside the FUSED engines: the mapping chunk sharded
over a device mesh.

Round 4 ran distributed mapping only through the host-stepped
VloamPipeline (parallel/mesh_pipeline.py) — one dispatch per frame, so
the mesh path moved at host-loop speed while the production engines
(vloam_step.VloamEngine / lidar.loam_step.LoamEngine) stayed
single-device. This module is the missing piece: a shard_map'd
`mapping_run_chunk` (vloam_step.py's program 2) that

- keeps the hashed cell-slab map SHARDED over the mesh axis for the whole
  sequence (FeatureGrid.pts rows = hash buckets; contiguous row blocks =
  map blocks; each device owns nb/D buckets and only ever materializes its
  own block),
- per frame, WINDOW-COMPACTS each device's block to the `window_rows`
  bucket rows nearest the predicted pose (one top_k over nb/D row
  min-distances) — this bounds the ring k-NN sweep's per-hop candidate
  count to window_rows*cap REGARDLESS of map size, which is what makes the
  production grid (2^17 buckets x cap 32 ~ 4.2M slots) tractable on a
  mesh; the actually-active row count is returned per frame so callers can
  verify the cap was sufficient (it is logged into the packed outputs),
- runs the pose refinement with the same per-device body as the
  host-stepped path (sharded_mapping.aligned_rounds: scan stacks sharded
  D ways, global 5-NN via ppermute ring hops over the windowed blocks,
  6x6 normal equations psum'd — the Schur-style reduction),
- INSERTS each frame's refined points into the owning device's block only
  (a point's hash bucket determines its owner; the segment-merged row
  insert from lidar/batch_mapping handles the block write), and evicts
  per block on cube-boundary crossings,
- advances F frames per dispatch inside ONE lax.scan, so the mesh path
  now runs at fused-engine cadence instead of host-loop cadence.

Reference analogue being distributed: laser_mapping.cpp:458-626 (solve)
and :638-702 (insert); the window compaction is the fixed-shape analogue of
the reference's 5x5x3 neighbor-cube gather (:404-428) — both restrict
association to the map near the vehicle.

Exactness: the window holds the nearest `window_rows` bucket rows by
point-to-pose distance. Any 1 m-gate neighbor of a scan point lies within
(max scan range + 1 m) of the pose, so with window_rows sized to cover the
active neighborhood the windowed ring 5-NN returns exactly the global
5-NN (tests/test_mesh_fused.py checks trajectory parity vs the
single-device fused chunk at the production grid size).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import PipelineConfig
from ..geometry import so3
from ..lidar.batch_mapping import _merged_row_insert
from ..lidar.gridmap import SENTINEL, _bucket_of
from ..lidar.mapping import GridMap, _cube_coord
from .sharded_mapping import aligned_rounds, shard_map

MESH_MO_OUT = 10  # [q_mo(4), t_mo(3), mapped, n_active_rows_c, n_active_rows_s]


def _window_block(blk: jnp.ndarray, center: jnp.ndarray, w_rows: int):
    """Compact a device's bucket-row block [nbD, 3*cap] to its `w_rows`
    rows nearest `center` (by nearest live slot). Returns (pts
    [w_rows*cap, 3], mask, n_active_rows) where n_active_rows is how many
    rows actually held a live point — if it exceeds w_rows the window
    truncated and the caller should raise window_rows."""
    nbD, W = blk.shape
    cap = W // 3
    xyz = blk.reshape(nbD, 3, cap)
    live = xyz[:, 0] < SENTINEL * 0.5  # [nbD, cap]
    d2 = jnp.sum((xyz - center[None, :, None]) ** 2, axis=1)  # [nbD, cap]
    d2 = jnp.where(live, d2, jnp.inf)
    row_key = jnp.min(d2, axis=1)  # [nbD]
    n_active = jnp.sum(jnp.isfinite(row_key), dtype=jnp.int32)
    _, idx = jax.lax.top_k(-row_key, w_rows)
    rows = blk[idx]  # [w_rows, 3*cap]
    pts = jnp.moveaxis(rows.reshape(w_rows, 3, cap), 1, 2).reshape(-1, 3)
    mask = pts[:, 0] < SENTINEL * 0.5
    return pts, mask, n_active


def _block_evict(blk: jnp.ndarray, center_w: jnp.ndarray,
                 radius: jnp.ndarray):
    """gridmap.grid_evict on one device's block; returns (blk', n_live_local)."""
    cap = blk.shape[1] // 3
    xyz = blk.reshape(-1, 3, cap)
    live = xyz[:, 0] < SENTINEL * 0.5
    inside = jnp.all(jnp.abs(xyz - center_w[None, :, None])
                     <= radius[None, :, None], axis=1)
    keep = live & inside
    pts = jnp.where(keep[:, None, :], xyz, SENTINEL)
    return pts.reshape(blk.shape), jnp.sum(keep, dtype=jnp.int32)


def make_mesh_mapping_chunk(mesh: Mesh, cfg: PipelineConfig,
                            axis: str = "data", window_rows: int = 4096):
    """Build the jitted shard_map'd mapping chunk for `mesh`. The returned
    fn has the contract of vloam_step.mapping_run_chunk:
        (mstate, c_xyz [F,Cc,3], c_m, s_xyz, s_m, q_w_lo [F,4], t_w_lo)
        -> (mstate', out [F, MESH_MO_OUT])
    with mstate a vloam_step.MapState whose cube grids live sharded over
    the mesh (see shard_map_state). Requires mapping_skip_frame == 1 (the
    KITTI profile; the host-stepped mesh path supports skipping)."""
    if cfg.lo.mapping_skip_frame != 1:
        raise NotImplementedError(
            "fused mesh mapping supports mapping_skip_frame == 1 "
            "(use the host-stepped --engine host mesh path for skipping)")
    D = mesh.shape[axis]
    mcfg = cfg.mapping
    nb = mcfg.map_n_buckets
    if nb % D:
        raise ValueError(f"map_n_buckets {nb} not divisible by mesh size {D}")
    nbD = nb // D
    w_rows = min(window_rows, nbD)
    radius = np.asarray([
        mcfg.cube_width * mcfg.cube_size / 2.0,
        mcfg.cube_height * mcfg.cube_size / 2.0,
        mcfg.cube_depth * mcfg.cube_size / 2.0,
    ], np.float32)

    spec_state = (P(axis), P(), P(axis), P(), P(), P(), P(), P())
    spec_frames = (P(), P(), P(), P(), P(), P())

    @partial(shard_map, mesh=mesh, in_specs=(spec_state + spec_frames),
             out_specs=(spec_state + (P(),)), check_vma=False)
    def run(c_blk, n_c, s_blk, n_s, center, qwm, twm, fidx,
            cxs, cms, sxs, sms, qls, tls):
        dev = jax.lax.axis_index(axis)
        lo_row = dev * nbD
        rad = jnp.asarray(radius)

        def frame(carry, inp):
            c_blk, s_blk, n_c, n_s, center, qwm, twm = carry
            cx, cm, sx, sm, q_w, t_w = inp
            q_pred = so3.quat_normalize(so3.quat_multiply(qwm, q_w))
            t_pred = twm + so3.quat_rotate(qwm, t_w)
            enough = ((n_c > mcfg.min_corner_map_points)
                      & (n_s > mcfg.min_surf_map_points))

            # window-compact this device's map block around the prediction;
            # the GLOBAL active-row count is logged in the packed output so
            # callers can verify window_rows covered the active map
            wc, wc_m, nact_c = _window_block(c_blk, t_pred, w_rows)
            ws, ws_m, nact_s = _window_block(s_blk, t_pred, w_rows)
            nact_c = jax.lax.psum(nact_c, axis)
            nact_s = jax.lax.psum(nact_s, axis)

            # this device's slice of the (replicated) scan stacks
            CcD = cx.shape[0] // D
            CsD = sx.shape[0] // D
            my_cx = jax.lax.dynamic_slice_in_dim(cx, dev * CcD, CcD)
            my_cm = jax.lax.dynamic_slice_in_dim(cm, dev * CcD, CcD)
            my_sx = jax.lax.dynamic_slice_in_dim(sx, dev * CsD, CsD)
            my_sm = jax.lax.dynamic_slice_in_dim(sm, dev * CsD, CsD)

            x0 = jnp.concatenate([q_pred, t_pred]).astype(jnp.float32)
            x, _ = aligned_rounds(my_cx, my_cm, my_sx, my_sm,
                                  wc, wc_m, ws, ws_m, x0, mcfg, axis, D)
            x = jnp.where(enough, x, x0)
            q_m, t_m = x[:4], x[4:]

            # insert this frame's refined points into the blocks we own
            def ins(blk, stack, mask, cell, res):
                pw = so3.quat_rotate(q_m, stack) + t_m
                b = _bucket_of(pw, cell, nb)
                local = b - lo_row
                key = jnp.where(mask & (local >= 0) & (local < nbD),
                                local, nbD)
                blk, ok, _ = _merged_row_insert(blk, key, pw, res)
                return blk, jnp.sum(ok, dtype=jnp.int32)

            c_blk, add_c = ins(c_blk, cx, cm, mcfg.corner_cell,
                               mcfg.line_resolution)
            s_blk, add_s = ins(s_blk, sx, sm, mcfg.surf_cell,
                               mcfg.plane_resolution)
            n_c = n_c + jax.lax.psum(add_c, axis)
            n_s = n_s + jax.lax.psum(add_s, axis)

            # recenter on cube-boundary crossings (laser_mapping.cpp:207-402)
            new_center = _cube_coord(t_m, mcfg.cube_size)
            changed = jnp.any(new_center != center)
            c_w = new_center.astype(jnp.float32) * mcfg.cube_size

            def do_evict(blks):
                cb, sb = blks
                cb, nc_loc = _block_evict(cb, c_w, rad)
                sb, ns_loc = _block_evict(sb, c_w, rad)
                return cb, sb, jax.lax.psum(nc_loc, axis), \
                    jax.lax.psum(ns_loc, axis)

            c_blk, s_blk, n_c, n_s = jax.lax.cond(
                changed, do_evict, lambda b: (b[0], b[1], n_c, n_s),
                (c_blk, s_blk))
            center = jnp.where(changed, new_center, center)

            # transformUpdate (laser_mapping.cpp:140-144)
            q_off = so3.quat_normalize(
                so3.quat_multiply(q_m, so3.quat_conjugate(q_w)))
            t_off = t_m - so3.quat_rotate(q_off, t_w)

            out = jnp.concatenate([
                q_m, t_m,
                jnp.asarray([1.0], jnp.float32),
                jnp.asarray([nact_c, nact_s], jnp.float32),
            ]).astype(jnp.float32)
            return (c_blk, s_blk, n_c, n_s, center, q_off, t_off), out

        (c_blk, s_blk, n_c, n_s, center, qwm, twm), outs = jax.lax.scan(
            frame, (c_blk, s_blk, n_c, n_s, center, qwm, twm),
            (cxs, cms, sxs, sms, qls, tls))
        return (c_blk, n_c, s_blk, n_s, center, qwm, twm,
                fidx + cxs.shape[0], outs)

    @partial(jax.jit, donate_argnums=(0,))
    def chunk(mstate, c_xyz, c_m, s_xyz, s_m, q_w_lo, t_w_lo):
        (c_pts, n_c, s_pts, n_s, center, qwm, twm, fidx, outs) = run(
            mstate.cube.corner.pts, mstate.cube.corner.n_live,
            mstate.cube.surf.pts, mstate.cube.surf.n_live,
            mstate.cube.center, mstate.q_wmap_wodom, mstate.t_wmap_wodom,
            mstate.frame_idx,
            c_xyz, c_m, s_xyz, s_m, q_w_lo, t_w_lo)
        from ..lidar.gridmap import FeatureGrid
        from ..vloam_step import MapState

        new_state = MapState(
            cube=GridMap(corner=FeatureGrid(c_pts, n_c),
                         surf=FeatureGrid(s_pts, n_s), center=center),
            q_wmap_wodom=qwm, t_wmap_wodom=twm, frame_idx=fidx)
        return new_state, outs

    return chunk


def shard_map_state(mstate, mesh: Mesh, axis: str = "data"):
    """Lay a vloam_step.MapState out for the mesh chunk: grid rows (hash
    buckets = map blocks) sharded over `axis`, everything else replicated."""
    row = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def put(x, sh):
        return jax.device_put(x, sh)

    from ..lidar.gridmap import FeatureGrid
    from ..vloam_step import MapState

    return MapState(
        cube=GridMap(
            corner=FeatureGrid(put(mstate.cube.corner.pts, row),
                               put(mstate.cube.corner.n_live, rep)),
            surf=FeatureGrid(put(mstate.cube.surf.pts, row),
                             put(mstate.cube.surf.n_live, rep)),
            center=put(mstate.cube.center, rep),
        ),
        q_wmap_wodom=put(mstate.q_wmap_wodom, rep),
        t_wmap_wodom=put(mstate.t_wmap_wodom, rep),
        frame_idx=put(mstate.frame_idx, rep),
    )

"""The production mapping stage executed as distributed BA over a mesh.

This is the BASELINE.json north star wired into the real pipeline (not a
kernel demo): MeshLaserMapping is a drop-in replacement for
lidar.mapping.LaserMapping whose per-frame pose refinement runs through
parallel/sharded_mapping.sharded_map_alignment —

- the frame's REAL voxel-downsampled corner/surf stacks are sharded over
  the mesh axis (each device owns 1/D of the scan points and their
  Jacobian work),
- the map candidates are the grid map's live points (gridmap.
  grid_flat_points: the hash-bucket slabs viewed flat), sharded over the
  mesh as map blocks; the global 5-NN is built by rotating the map shards
  around the ring with ppermute,
- the 6x6 normal equations and the LM accept/reject costs are psum'd, so
  every device applies the identical update (the Schur-style reduction:
  point-block variables are eliminated by the closed-form eigen/plane
  fits; only the 6-dof pose crosses devices),
- map MAINTENANCE (voxel-dedup insert + boundary eviction at the refined
  pose, mapping.map_update) is byte-identical to the single-device path,
  so the map contents — and therefore the next frame's candidates — stay
  in lockstep with a single-device run.

Equivalence to lidar.mapping.solve_mapping (tests/test_mesh_pipeline.py):
the accepted-residual sets are identical because the single-device 8-cell
probe is exact within the 1 m gate (gridmap.py) and the candidate slab is
a subset of the flat map — if the global 5th-nearest passes the gate, all
five live in probed cells and both searches return them; if it fails, the
slab's (>= global) 5th distance fails too. The solver update rule is the
same LM (sharded_mapping round/lm loop mirrors solver.lm.lm_solve), so
trajectories agree to float accumulation order.

Reference semantics being distributed: laser_mapping.cpp:458-626 (the
scan-to-map Ceres solve); the reference is single-threaded.

Scaling note: the ring k-NN sweeps each device's scan shard against every
visiting map shard, so per-device work is O(scan/D x map-slots) per hop x
D hops = O(scan x map-slots / D): compute scales 1/D with device count,
map MEMORY 1/D, and the single-device grid's 8-cell probe (O(scan x
8 cap)) is traded for dense distance tiles. For maps much
larger than the active neighborhood, pre-restricting the flat view to a
window around the pose (a top-k compaction of grid_flat_points by
distance) would bound the sweep; at the reference's window extent
(21x21x11 50 m cubes, eviction already bounds live points) the flat view
IS the active window.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..config import LaserMappingConfig, PipelineConfig
from ..lidar.gridmap import grid_flat_points
from ..lidar.mapping import GridMap, map_update
from ..lidar.types import FeatureCloud
from ..lidar.voxel import voxel_downsample
from .sharded import shard_batch
from .sharded_mapping import sharded_map_alignment


def mesh_solve_mapping(
    mesh: Mesh,
    grid_map: GridMap,
    corner_stack_xyz: jnp.ndarray,
    corner_stack_mask: jnp.ndarray,
    surf_stack_xyz: jnp.ndarray,
    surf_stack_mask: jnp.ndarray,
    q_pred: jnp.ndarray,
    t_pred: jnp.ndarray,
    cfg: LaserMappingConfig,
    axis: str = "data",
):
    """One mapping solve + map update with the pose refinement distributed
    over `mesh`. Same contract as mapping.solve_mapping: returns
    (new_map, q_w, t_w, stats)."""
    n_map_corner = int(grid_map.corner.n_live)
    n_map_surf = int(grid_map.surf.n_live)
    x0 = jnp.concatenate([jnp.asarray(q_pred, jnp.float32),
                          jnp.asarray(t_pred, jnp.float32)])
    enough = (n_map_corner > cfg.min_corner_map_points
              and n_map_surf > cfg.min_surf_map_points)
    if enough:
        mc, mc_m = grid_flat_points(grid_map.corner)
        ms, ms_m = grid_flat_points(grid_map.surf)
        x = sharded_map_alignment(
            mesh,
            shard_batch(corner_stack_xyz, mesh, axis),
            shard_batch(corner_stack_mask, mesh, axis),
            shard_batch(surf_stack_xyz, mesh, axis),
            shard_batch(surf_stack_mask, mesh, axis),
            shard_batch(mc, mesh, axis), shard_batch(mc_m, mesh, axis),
            shard_batch(ms, mesh, axis), shard_batch(ms_m, mesh, axis),
            x0, cfg, axis=axis,
        )
    else:
        x = x0
    q_w, t_w = x[:4], x[4:]
    new_map = map_update(grid_map, corner_stack_xyz, corner_stack_mask,
                         surf_stack_xyz, surf_stack_mask, q_w, t_w, cfg)
    stats = {"n_map_corner": n_map_corner, "n_map_surf": n_map_surf,
             "solved": enough}
    return new_map, q_w, t_w, stats


class MeshLaserMapping:
    """Host-side wrapper mirroring lidar.mapping.LaserMapping (same step()
    contract, same f64 odom->map offset bookkeeping) with the per-frame
    solve distributed over a jax.sharding.Mesh. Plug into VloamPipeline via
    its `mesh=` option or the CLI --mesh flag."""

    def __init__(self, cfg: LaserMappingConfig, mesh: Mesh,
                 axis: str = "data"):
        from scipy.spatial.transform import Rotation as R

        self.cfg = cfg
        self.mesh = mesh
        self.axis = axis
        self.R = R
        self.map = GridMap.create(cfg)
        self.q_wmap_wodom = np.array([0.0, 0.0, 0.0, 1.0])
        self.t_wmap_wodom = np.zeros(3)
        self.q_w = np.array([0.0, 0.0, 0.0, 1.0])
        self.t_w = np.zeros(3)
        self.frame_count = 0
        self.last_stats = {}

    def step(self, corner_cloud: FeatureCloud, surf_cloud: FeatureCloud,
             q_wodom, t_wodom, skip_frame: bool = False):
        R = self.R
        q_pred = (R.from_quat(self.q_wmap_wodom) * R.from_quat(q_wodom)).as_quat()
        t_pred = self.t_wmap_wodom + R.from_quat(self.q_wmap_wodom).apply(t_wodom)
        if skip_frame:
            return {"q_w": q_pred, "t_w": t_pred, "skip": True}

        c_xyz, _, _, c_m = voxel_downsample(
            corner_cloud.xyz, corner_cloud.mask, self.cfg.line_resolution,
            self.cfg.corner_stack_cap,
        )
        s_xyz, _, _, s_m = voxel_downsample(
            surf_cloud.xyz, surf_cloud.mask, self.cfg.plane_resolution,
            self.cfg.surf_stack_cap,
        )
        new_map, q_w, t_w, stats = mesh_solve_mapping(
            self.mesh, self.map, c_xyz, c_m, s_xyz, s_m,
            jnp.asarray(q_pred, jnp.float32), jnp.asarray(t_pred, jnp.float32),
            self.cfg, self.axis,
        )
        self.map = new_map
        self.q_w = np.asarray(q_w, np.float64)
        self.q_w /= np.linalg.norm(self.q_w)
        self.t_w = np.asarray(t_w, np.float64)
        r_off = R.from_quat(self.q_w) * R.from_quat(q_wodom).inv()
        self.q_wmap_wodom = r_off.as_quat()
        self.t_wmap_wodom = self.t_w - r_off.apply(t_wodom)
        self.frame_count += 1
        self.last_stats = {k: (int(v) if hasattr(v, "item") else v)
                           for k, v in stats.items()}
        return {"q_w": self.q_w, "t_w": self.t_w, "skip": False,
                **self.last_stats}


def run_mesh_drive(cfg: PipelineConfig, frames, mesh: Mesh,
                   axis: str = "data") -> dict:
    """Drive a lidar sequence with the mapping stage distributed over
    `mesh` (scanreg + LO single-device, MO via MeshLaserMapping). `frames`
    yields [N,3] point arrays. Returns {'q_w_mo': [F,4], 't_w_mo': [F,3],
    'q_w_lo': ..., 't_w_lo': ...} numpy arrays."""
    from ..data.synthetic import pad_scan
    from ..lidar.odometry import LaserOdometry
    from ..lidar.scan_registration import register_scan

    lo = LaserOdometry(cfg.lo)
    mo = MeshLaserMapping(cfg.mapping, mesh, axis)
    out = {"q_w_lo": [], "t_w_lo": [], "q_w_mo": [], "t_w_mo": []}
    for pts in frames:
        padded, n = pad_scan(pts, cfg.lidar.max_points)
        feats = register_scan(jnp.asarray(padded), jnp.int32(n), cfg.lidar,
                              cfg.scanreg)
        lo_out = lo.step(feats)
        mo_out = mo.step(feats.less_sharp, feats.less_flat,
                         lo_out["q_w"], lo_out["t_w"],
                         skip_frame=lo_out["skip_frame"])
        out["q_w_lo"].append(np.asarray(lo_out["q_w"]))
        out["t_w_lo"].append(np.asarray(lo_out["t_w"]))
        out["q_w_mo"].append(np.asarray(mo_out["q_w"]))
        out["t_w_mo"].append(np.asarray(mo_out["t_w"]))
    return {k: np.stack(v) for k, v in out.items()}

"""Map- AND scan-sharded scan-to-map alignment (distributed BA core).

BASELINE.json north star: the lidar-mapping stage becomes distributed
bundle adjustment over map blocks partitioned across devices, solved via
Schur-complement reduction with psum/all-gather collectives. Both the data AND the compute shard over the mesh:

- the map candidate points are sharded over the mesh axis (map blocks),
- the scan stacks are ALSO sharded: each device owns B/D scan points, so
  k-NN distance compute, feature geometry, and Jacobian work all scale
  1/D with device count (round 2 replicated the stacks, so only map
  memory scaled),
- the global 5-NN of each local scan point is built by rotating the map
  shards around the ring with ppermute (D-1 hops over ICI) and merging a
  running top-k of (distance, coordinates) — no device ever holds the
  whole map,
- each device accumulates the 6x6 normal equations (H, g) over ITS scan
  points only, then one psum reduces them (the Schur reduction: the
  point-block "inner" variables are eliminated analytically by the
  closed-form eigen/plane fits; only the 6-dof pose block crosses
  devices),
- every device applies the identical damped update.

Runs unchanged on a CPU test mesh and a real ICI-connected slice.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import LaserMappingConfig
from ..geometry import so3
from ..lidar.knn import masked_knn
from ..lidar.mapping import _retract
from ..solver.eig3 import eigvals_sym3, principal_eigenvector
from ..solver.lm import huber_weight, huber_cost, solve_damped

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map  # type: ignore


def _ring_knn(queries, shard_pts, shard_mask, k, axis, n_devices):
    """Inside shard_map: global k-NN of LOCAL queries against the SHARDED
    map by rotating the map shard around the ring (ppermute, D-1 hops) and
    merging a running top-k. Returns (d_sq [Qd, k], pts [Qd, k, 3]) — the
    true global k nearest, with both distances and coordinates resolved
    locally (no cross-device point gathers)."""
    d, i = masked_knn(queries, shard_pts, shard_mask, k=k)
    best_d, best_p = d, shard_pts[i]
    pts, mask = shard_pts, shard_mask
    perm = [(j, (j + 1) % n_devices) for j in range(n_devices)]
    for _ in range(n_devices - 1):
        pts = jax.lax.ppermute(pts, axis, perm)
        mask = jax.lax.ppermute(mask, axis, perm)
        d, i = masked_knn(queries, pts, mask, k=k)
        cand_d = jnp.concatenate([best_d, d], axis=1)  # [Qd, 2k]
        cand_p = jnp.concatenate([best_p, pts[i]], axis=1)
        nd, ni = jax.lax.top_k(-cand_d, k)
        best_d = -nd
        best_p = jnp.take_along_axis(cand_p, ni[:, :, None], axis=1)
    return best_d, best_p


def _corner_geometry(mask, near, d, cfg):
    """Line-feature geometry (a, b, |a-b|, weight) from global 5-NN
    coordinates (mirrors lidar/mapping._corner_terms)."""
    ok = mask & (d[:, cfg.knn - 1] < cfg.neighbor_radius_sq)
    center = jnp.mean(near, axis=1)
    dm = near - center[:, None, :]
    cov = jnp.einsum("bki,bkj->bij", dm, dm, precision="highest") / cfg.knn
    lams = eigvals_sym3(cov)
    is_line = lams[:, 2] > cfg.eigen_ratio * lams[:, 1]
    u = principal_eigenvector(cov, lams[:, 2])
    a = center + cfg.edge_half_length * u
    b = center - cfg.edge_half_length * u
    de = jnp.linalg.norm(a - b, axis=-1)
    w_mask = (ok & is_line & (de > 1e-6)).astype(jnp.float32)
    return a, b, de, w_mask


def _surf_geometry(mask, near, d, cfg):
    ok = mask & (d[:, cfg.knn - 1] < cfg.neighbor_radius_sq)
    AtA = jnp.einsum("bki,bkj->bij", near, near, precision="highest")
    Atb = -jnp.sum(near, axis=1)
    det = jnp.linalg.det(AtA)
    adj = jnp.stack([
        jnp.cross(AtA[:, 1], AtA[:, 2]),
        jnp.cross(AtA[:, 2], AtA[:, 0]),
        jnp.cross(AtA[:, 0], AtA[:, 1]),
    ], axis=-1)
    n = jnp.einsum("bij,bj->bi", adj, Atb, precision="highest") / jnp.where(
        jnp.abs(det) > 1e-12, det, jnp.inf)[:, None]
    norm = jnp.linalg.norm(n, axis=-1)
    nood = 1.0 / jnp.maximum(norm, 1e-9)
    n_hat = n / jnp.maximum(norm, 1e-9)[:, None]
    resid = jnp.abs(jnp.einsum("bki,bi->bk", near, n_hat, precision="highest") + nood[:, None])
    plane_ok = jnp.all(resid <= cfg.plane_fit_tolerance, axis=-1)
    w_mask = (ok & plane_ok & (jnp.abs(det) > 1e-12)).astype(jnp.float32)
    return n_hat, nood, w_mask


def _accumulate(res_fn, w_mask, huber_delta):
    r = res_fn(jnp.zeros(6, jnp.float32))
    J = jax.jacfwd(res_fn)(jnp.zeros(6, jnp.float32))
    sq = jnp.sum(r * r, axis=-1)
    w = huber_weight(sq, huber_delta) * w_mask
    H = jnp.einsum("bri,brj->ij", J * w[:, None, None], J, precision="highest")
    g = jnp.einsum("bri,br->i", J, r * w[:, None], precision="highest")
    cost = jnp.sum(huber_cost(sq, huber_delta) * w_mask)
    return H, g, cost


def aligned_rounds(c_stack, c_mask, s_stack, s_mask, mc, mc_m, ms, ms_m, x,
                   cfg: LaserMappingConfig, axis: str, D: int):
    """Per-device body of the distributed scan-to-map refinement — call
    INSIDE a shard_map over `axis` (used by sharded_map_alignment below and
    by the fused-engine mesh mapping chunk, parallel/mesh_fused.py).
    c/s_stack are this device's LOCAL scan points; mc/ms are its LOCAL map
    candidate shard (rotated around the ring). Returns (x [7] replicated by
    psums, n_local accepted residuals on this device)."""

    def round_body(_, carry):
        x, _ = carry
        q, t = x[:4], x[4:]
        pc = so3.quat_rotate(q, c_stack) + t
        ps = so3.quat_rotate(q, s_stack) + t
        d_c, near_c = _ring_knn(pc, mc, mc_m, cfg.knn, axis, D)
        d_s, near_s = _ring_knn(ps, ms, ms_m, cfg.knn, axis, D)
        a, b, de, w_c = _corner_geometry(c_mask, near_c, d_c, cfg)
        n_hat, nood, w_s = _surf_geometry(s_mask, near_s, d_s, cfg)

        def fams_at(x_in):
            def fn_c(delta):
                qd = so3.quat_multiply(x_in[:4],
                                       so3.quat_from_axis_angle(delta[:3]))
                td = x_in[4:] + delta[3:]
                pw = so3.quat_rotate(qd, c_stack) + td
                nu = jnp.cross(pw - a, pw - b)
                return nu / jnp.maximum(de, 1e-9)[:, None]

            def fn_s(delta):
                qd = so3.quat_multiply(x_in[:4],
                                       so3.quat_from_axis_angle(delta[:3]))
                td = x_in[4:] + delta[3:]
                pw = so3.quat_rotate(qd, s_stack) + td
                return (jnp.sum(pw * n_hat, axis=-1) + nood)[:, None]

            return fn_c, fn_s

        def local_cost(x_in):
            fn_c, fn_s = fams_at(x_in)
            z = jnp.zeros(6, jnp.float32)
            cc = jnp.sum(huber_cost(
                jnp.sum(fn_c(z) ** 2, axis=-1), cfg.huber_delta) * w_c)
            cs = jnp.sum(huber_cost(
                jnp.sum(fn_s(z) ** 2, axis=-1), cfg.huber_delta) * w_s)
            return cc + cs

        # LM with accept/reject damping — the exact update rule of
        # solver.lm.lm_solve, with every scalar reduction (H, g, cost)
        # psum'd across the mesh so all devices take identical branches
        def lm_body(_, carry):
            x_in, lam = carry
            fn_c, fn_s = fams_at(x_in)
            # per-shard partial normal equations over LOCAL scan points,
            # reduced with ONE psum — the Schur-style 6x6 reduction
            Hc, gc, cc = _accumulate(fn_c, w_c, cfg.huber_delta)
            Hs, gs, cs = _accumulate(fn_s, w_s, cfg.huber_delta)
            H = jax.lax.psum(Hc + Hs, axis)
            g = jax.lax.psum(gc + gs, axis)
            cost = jax.lax.psum(cc + cs, axis)
            delta = solve_damped(H, g, lam)
            x_try = _retract(x_in, -delta)
            cost_try = jax.lax.psum(local_cost(x_try), axis)
            accept = cost_try < cost
            x_new = jnp.where(accept, x_try, x_in)
            lam_new = jnp.where(accept, jnp.maximum(lam * 0.33, 1e-7),
                                jnp.minimum(lam * 8.0, 1e2))
            return x_new, lam_new

        x_new, _ = jax.lax.fori_loop(0, cfg.gn_iterations, lm_body,
                                     (x, jnp.float32(1e-4)))
        n_loc = jnp.sum(w_c) + jnp.sum(w_s)
        return x_new, n_loc

    return jax.lax.fori_loop(0, cfg.outer_rounds, round_body,
                             (x, jnp.float32(0)))


def sharded_map_alignment(
    mesh: Mesh,
    corner_stack: jnp.ndarray,  # [Bc, 3] sharded over axis (Bc % D == 0)
    corner_mask: jnp.ndarray,
    surf_stack: jnp.ndarray,  # [Bs, 3] sharded over axis (Bs % D == 0)
    surf_mask: jnp.ndarray,
    map_corner: jnp.ndarray,  # [Cc, 3] sharded over axis
    map_corner_mask: jnp.ndarray,
    map_surf: jnp.ndarray,  # [Cs, 3] sharded over axis
    map_surf_mask: jnp.ndarray,
    x0: jnp.ndarray,  # [7] (quat, t)
    cfg: LaserMappingConfig,
    axis: str = "data",
    return_counts: bool = False,
):
    """Distributed scan-to-map pose refinement. Returns x [7]; with
    return_counts also the per-device accepted residual counts [D]
    (final round), for load-balance checks."""
    D = mesh.shape[axis]

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P(axis),
                       P(axis), P(axis), P(axis), P(axis), P()),
             out_specs=(P(), P(axis)), check_vma=False)
    def run(c_stack, c_mask, s_stack, s_mask, mc, mc_m, ms, ms_m, x):
        x_out, n_loc = aligned_rounds(c_stack, c_mask, s_stack, s_mask,
                                      mc, mc_m, ms, ms_m, x, cfg, axis, D)
        return x_out, n_loc[None]

    x, counts = run(corner_stack, corner_mask, surf_stack, surf_mask,
                    map_corner, map_corner_mask, map_surf, map_surf_mask,
                    x0.astype(jnp.float32))
    if return_counts:
        return x, counts
    return x

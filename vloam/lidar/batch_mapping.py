"""Flat-batched scan-to-map mapping: B independent sequences, ONE index space.

Why this exists: vmapping `solve_mapping` over B streams scales
~linearly-or-worse —
- a vmapped row gather pays its fixed lowering cost PER LANE,
- the per-point element scatter in grid_insert serializes under vmap,
- `lax.cond(changed, grid_evict, ...)` becomes a select that runs the
  full-map eviction pass every frame.
Latency-chained stages (sorts, the LM chain, top_k) amortize essentially
for free (argsort B=4 == B=1), so the fix is to make the descriptor-bound
ops flat: fold the stream axis into the hash-bucket axis. B per-stream
tables become ONE [B*nb, 3*cap] table, a point's row is
`stream*nb + hash(cell)`, and every gather/sort/scatter in the mapping
stage is a single flat op whose fixed costs are paid once.

Insert additionally switches from per-element scatter to a segment-merged
ROW scatter (row scatters scale ~1.6x at B=4 where element scatters hit
3.5x): points are sorted by flat bucket, each bucket-segment's points are
merged into one updated row image via prefix sums, and only segment-end
rows are written.

Reference semantics being reproduced: laser_mapping.cpp:458-626 (the
scan-to-map solve) and :638-702 (map insertion + per-cube re-filter), per
stream, exactly as in mapping.solve_mapping. Eviction (the cube-shift
recentering, :207-402) is hoisted to once per chunk (batch_map_evict):
the eviction window is ~±500 m while the pose moves <~2 m/frame, so
evicting at chunk granularity drops the same points a few frames earlier
or later — outside the 1 m association radius either way.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import LaserMappingConfig
from ..geometry import so3
from ..solver.eig3 import eigvals_sym3, principal_eigenvector
from ..solver.lm import huber_cost, huber_weight, solve_damped
from .gridmap import SENTINEL, _bucket_of, _hash_cell, knn_among_planar
from .mapping import _EPS, _cube_coord

_E0 = (1.0, 0.0, 0.0)


class BatchFeatureGrid(NamedTuple):
    """B per-stream hashed cell-slab maps in one flat table.

    Row `s*nb + h` is stream s's bucket h; the interleaved x|y|z row layout
    matches gridmap.FeatureGrid exactly."""

    pts: jnp.ndarray  # [B*nb, 3*cap] f32, SENTINEL-padded
    n_live: jnp.ndarray  # [B] int32

    @property
    def cap(self) -> int:
        return self.pts.shape[1] // 3

    def n_buckets(self, batch: int) -> int:
        return self.pts.shape[0] // batch


class BatchGridMap(NamedTuple):
    corner: BatchFeatureGrid
    surf: BatchFeatureGrid
    center: jnp.ndarray  # [B, 3] int32 cube coordinate at last eviction

    @staticmethod
    def create(cfg: LaserMappingConfig, batch: int) -> "BatchGridMap":
        def grid(cap):
            return BatchFeatureGrid(
                pts=jnp.full((batch * cfg.map_n_buckets, 3 * cap), SENTINEL,
                             jnp.float32),
                n_live=jnp.zeros((batch,), jnp.int32),
            )

        return BatchGridMap(
            corner=grid(cfg.corner_bucket_cap),
            surf=grid(cfg.surf_bucket_cap),
            center=jnp.zeros((batch, 3), jnp.int32),
        )


def _flat_buckets(p: jnp.ndarray, cell: float, nb: int) -> jnp.ndarray:
    """p [B, Q, 3] -> flat row ids [B*Q] = stream*nb + hash(cell(p))."""
    b = _bucket_of(p, cell, nb)  # [B, Q]
    off = (jnp.arange(p.shape[0], dtype=jnp.int32) * nb)[:, None]
    return (b + off).reshape(-1)


def batch_grid_gather(g: BatchFeatureGrid, queries: jnp.ndarray, cell: float,
                      batch: int):
    """8-cell probe candidates for per-stream queries [B, Q, 3] as ONE flat
    gather: returns planar [3, B*Q, 8*cap] (cf. gridmap.grid_gather)."""
    nb = g.n_buckets(batch)
    cap = g.cap
    B, Q = queries.shape[:2]
    s = queries / cell
    c = jnp.floor(s).astype(jnp.int32)
    off = jnp.where(s - c < 0.5, -1, 1).astype(jnp.int32)  # [B, Q, 3]
    soff = (jnp.arange(B, dtype=jnp.int32) * nb)[:, None]
    hs = []
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                h = _hash_cell(c[..., 0] + sx * off[..., 0],
                               c[..., 1] + sy * off[..., 1],
                               c[..., 2] + sz * off[..., 2], nb)
                hs.append(h + soff)
    buckets = jnp.stack(hs, axis=-1).reshape(B * Q, 8)
    rows = g.pts[buckets]  # [B*Q, 8, 3*cap] — one flat gather
    planar = rows.reshape(B * Q, 8, 3, cap)
    return jnp.moveaxis(planar, 2, 0).reshape(3, B * Q, 8 * cap)


def _merged_row_insert(tab: jnp.ndarray, key: jnp.ndarray, p: jnp.ndarray,
                       res: float):
    """Insert points into bucket rows by segment-merged ROW scatter.

    tab [NBt, 3*cap]; key [N] destination row (NBt = dropped); p [N, 3].
    Returns (tab', ok [N] sorted-order insert mask, ks [N] sorted keys).

    One multi-operand sort carries the coordinates (no post-sort point
    gather), one row gather fetches each sorted point's bucket row, voxel
    dup-check and free-slot ranking run in sorted order, per-bucket updates
    are merged with prefix sums, and only segment-end rows are scattered
    (unique row indices by construction).

    The prefix-sum merge runs ENTIRELY in int32: coordinates are split into
    an exact integer res-voxel index and a fixed-point fractional part
    (scale chosen so the worst-case all-same-sign prefix stays < 2^31).
    A plain f32 cumsum would difference two large prefixes per segment —
    catastrophic cancellation grows with N*|coord| (~0.7 m worst at B=8) —
    while the int path's only loss is the fixed-point quantization of the
    fraction (~res/2^14 ~ tens of microns, deterministic)."""
    NBt, W = tab.shape
    cap = W // 3
    N = key.shape[0]

    # fixed-point scale for the in-voxel fraction: frac in [0, res), the
    # worst-case all-in-one-column prefix N*res*q must fit int32 with margin
    import math

    q = float(min(1 << 18,
                  max(1, (2 ** 31 - 1) // int(math.ceil(res * N * 1.25)))))
    inv_q = 1.0 / q

    ks, px, py, pz = jax.lax.sort(
        (key, p[:, 0], p[:, 1], p[:, 2]), num_keys=1)
    rows = tab[jnp.minimum(ks, NBt - 1)]  # [N, 3*cap] one flat gather
    slab = jnp.stack([rows[:, 0 * cap:1 * cap], rows[:, 1 * cap:2 * cap],
                      rows[:, 2 * cap:3 * cap]])  # [3, N, cap]

    # voxel dedup vs the existing map row (first observation wins,
    # reference laser_mapping.cpp:688-702 semantics; see gridmap.grid_insert)
    pstack = jnp.stack([px, py, pz])  # [3, N]
    v = jnp.floor(pstack / res).astype(jnp.int32)  # [3, N] exact voxel index
    sv = jnp.floor(slab / res).astype(jnp.int32)
    dup = jnp.any(jnp.all(sv == v[:, :, None], axis=0), axis=-1)  # [N]

    idx = jnp.arange(N, dtype=jnp.int32)
    boundary = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    seg_start = jax.lax.cummax(jnp.where(boundary, idx, -1))
    # rank among NON-dup points of the segment (dups occupy no slot)
    cs_ex = jnp.cumsum(dup.astype(jnp.int32)) - dup.astype(jnp.int32)
    cs_at_start = jax.lax.cummax(jnp.where(boundary, cs_ex, -1))
    rank = (idx - seg_start) - (cs_ex - cs_at_start)

    free = slab[0] > SENTINEL * 0.5  # [N, cap]; identical within a segment
    fcsum = jnp.cumsum(free, axis=1).astype(jnp.int32)
    ge = fcsum >= (rank + 1)[:, None]
    pos = jnp.argmax(ge, axis=1).astype(jnp.int32)
    ok = (ks < NBt) & ~dup & (rank < fcsum[:, -1])

    # split each coordinate into (voxel index, fixed-point fraction)
    frac_q = jnp.round((pstack - v.astype(jnp.float32) * res) * q
                       ).astype(jnp.int32)  # [3, N], in [0, res*q]

    col = jax.lax.broadcasted_iota(jnp.int32, (N, cap), 1)
    hit = (col == pos[:, None]) & ok[:, None]  # [N, cap]
    hi = hit.astype(jnp.int32)
    vc = jnp.concatenate([hi * v[0][:, None], hi * v[1][:, None],
                          hi * v[2][:, None]], axis=1)  # [N, 3cap] int32
    fc = jnp.concatenate([hi * frac_q[0][:, None], hi * frac_q[1][:, None],
                          hi * frac_q[2][:, None]], axis=1)
    m3 = jnp.concatenate([hi, hi, hi], axis=1)

    vsum = jnp.cumsum(vc, axis=0)
    fsum = jnp.cumsum(fc, axis=0)
    msum = jnp.cumsum(m3, axis=0)
    prev = seg_start - 1
    pc = jnp.maximum(prev, 0)
    has_prev = (prev >= 0)[:, None]
    seg_v = vsum - jnp.where(has_prev, vsum[pc], 0)
    seg_f = fsum - jnp.where(has_prev, fsum[pc], 0)
    seg_m = msum - jnp.where(has_prev, msum[pc], 0)

    # exactly one contributor per written column: reconstruct its value
    written = seg_m > 0
    val = seg_v.astype(jnp.float32) * res + seg_f.astype(jnp.float32) * inv_q
    new_row = jnp.where(written, val, rows)
    is_end = jnp.concatenate([ks[1:] != ks[:-1], jnp.ones((1,), bool)])
    dest = jnp.where(is_end & (ks < NBt), ks, NBt)
    tab = tab.at[dest].set(new_row, mode="drop")
    return tab, ok, ks


def batch_grid_insert(g: BatchFeatureGrid, p: jnp.ndarray, mask: jnp.ndarray,
                      cell: float, res: float, batch: int) -> BatchFeatureGrid:
    """Insert per-stream world points p [B, S, 3] (mask [B, S]) into the
    flat table: one sort + one gather + one row scatter for ALL streams."""
    nb = g.n_buckets(batch)
    NBt = g.pts.shape[0]
    key = jnp.where(mask.reshape(-1), _flat_buckets(p, cell, nb), NBt)
    tab, ok, ks = _merged_row_insert(g.pts, key, p.reshape(-1, 3), res)
    stream = jnp.minimum(ks // nb, batch - 1)
    added = jnp.zeros((batch,), jnp.int32).at[stream].add(
        ok.astype(jnp.int32), mode="drop")
    return BatchFeatureGrid(pts=tab, n_live=g.n_live + added)


def batch_grid_evict(g: BatchFeatureGrid, center_w: jnp.ndarray,
                     radius: jnp.ndarray, batch: int) -> BatchFeatureGrid:
    """Per-stream box eviction (one elementwise pass over the flat table);
    center_w [B, 3] world centers, radius [3]."""
    cap = g.cap
    nb = g.n_buckets(batch)
    xyz = g.pts.reshape(batch, nb, 3, cap)
    live = xyz[:, :, 0] < SENTINEL * 0.5
    inside = jnp.all(
        jnp.abs(xyz - center_w[:, None, :, None]) <= radius[None, None, :,
                                                           None], axis=2)
    keep = live & inside
    pts = jnp.where(keep[:, :, None, :], xyz, SENTINEL)
    return BatchFeatureGrid(
        pts=pts.reshape(batch * nb, 3 * cap),
        n_live=jnp.sum(keep, axis=(1, 2), dtype=jnp.int32),
    )


def _batch_corner_terms(stack, mask, cand, x, cfg):
    """_corner_terms over [B, Qc] stacks with pre-gathered flat candidates
    (mapping.py:70-91; the math is identical, run flat)."""
    B, Q = stack.shape[:2]
    p_w = so3.quat_rotate(x[:, None, :4], stack) + x[:, None, 4:]
    d, near = knn_among_planar(cand, p_w.reshape(B * Q, 3), k=cfg.knn)
    ok = mask.reshape(-1) & (d[:, cfg.knn - 1] < cfg.neighbor_radius_sq)
    center_p = jnp.mean(near, axis=2)  # [3, BQ]
    dm = near - center_p[:, :, None]
    cov = jnp.einsum("iqk,jqk->qij", dm, dm, precision="highest") / cfg.knn
    lams = eigvals_sym3(cov)
    is_line = lams[:, 2] > cfg.eigen_ratio * lams[:, 1]
    u = principal_eigenvector(cov, lams[:, 2])
    center = center_p.T
    a = center + cfg.edge_half_length * u
    b = center - cfg.edge_half_length * u
    valid = ok & is_line
    de = jnp.linalg.norm(a - b, axis=-1)
    return (a.reshape(B, Q, 3), b.reshape(B, Q, 3), de.reshape(B, Q),
            valid.reshape(B, Q))


def _batch_surf_terms(stack, mask, cand, x, cfg):
    """_surf_terms over [B, Qs] stacks (mapping.py:94-123), run flat."""
    B, Q = stack.shape[:2]
    p_w = so3.quat_rotate(x[:, None, :4], stack) + x[:, None, 4:]
    d, near = knn_among_planar(cand, p_w.reshape(B * Q, 3), k=cfg.knn)
    ok = mask.reshape(-1) & (d[:, cfg.knn - 1] < cfg.neighbor_radius_sq)
    AtA = jnp.einsum("iqk,jqk->qij", near, near, precision="highest")
    Atb = -jnp.sum(near, axis=2).T
    det = jnp.linalg.det(AtA)
    adj = jnp.stack(
        [
            jnp.cross(AtA[:, 1], AtA[:, 2]),
            jnp.cross(AtA[:, 2], AtA[:, 0]),
            jnp.cross(AtA[:, 0], AtA[:, 1]),
        ],
        axis=-1,
    )
    n = jnp.einsum("bij,bj->bi", adj, Atb, precision="highest") / jnp.where(
        jnp.abs(det) > 1e-12, det, jnp.inf)[:, None]
    norm = jnp.linalg.norm(n, axis=-1)
    nood = 1.0 / jnp.maximum(norm, _EPS)
    n_hat = n / jnp.maximum(norm, _EPS)[:, None]
    resid = jnp.abs(jnp.einsum("iqk,qi->qk", near, n_hat, precision="highest") + nood[:, None])
    plane_ok = jnp.all(resid <= cfg.plane_fit_tolerance, axis=-1)
    valid = ok & plane_ok & (jnp.abs(det) > 1e-12) & (norm > _EPS)
    return (n_hat.reshape(B, Q, 3), nood.reshape(B, Q), valid.reshape(B, Q))


def _res_one(delta, xx, cp, A, Bp, DE, NH, NOOD, is_edge):
    """Per-stream fused edge+plane residuals at local delta (the batched
    analogue of the fused family in mapping.solve_mapping)."""
    qd = so3.quat_multiply(xx[:4], so3.quat_from_axis_angle(delta[:3]))
    td = xx[4:] + delta[3:]
    pw = so3.quat_rotate(qd, cp) + td
    r_edge = jnp.cross(pw - A, pw - Bp) / jnp.maximum(DE, _EPS)[:, None]
    r_plane = jnp.sum(pw * NH, axis=-1) + NOOD
    e0 = jnp.asarray(_E0, pw.dtype)
    return jnp.where(is_edge, r_edge, r_plane[:, None] * e0)


def _retract_b(x, delta):
    q = so3.quat_normalize(
        so3.quat_multiply(x[:, :4], so3.quat_from_axis_angle(delta[:, :3])))
    return jnp.concatenate([q, x[:, 4:] + delta[:, 3:]], axis=-1)


def _lm_solve_batched(x0, cp, A, Bp, DE, NH, NOOD, is_edge, w, iterations,
                      huber_delta):
    """Per-stream LM over the fused family: x0 [B,7] -> x [B,7]. Mirrors
    solver.lm.lm_solve (one NE eval per iteration, carried accept/reject)
    with all reductions per stream."""
    zero6 = jnp.zeros((x0.shape[0], 6), jnp.float32)

    def ne(x):
        r = jax.vmap(_res_one, in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None))(
            zero6, x, cp, A, Bp, DE, NH, NOOD, is_edge)  # [B, Q, 3]
        J = jax.vmap(jax.jacfwd(_res_one),
                     in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None))(
            zero6, x, cp, A, Bp, DE, NH, NOOD, is_edge)  # [B, Q, 3, 6]
        sq = jnp.sum(r * r, axis=-1)  # [B, Q]
        wgt = huber_weight(sq, huber_delta) * w
        H = jnp.einsum("bqri,bqrj->bij", J * wgt[:, :, None, None], J, precision="highest")
        g = jnp.einsum("bqri,bqr->bi", J, r * wgt[:, :, None], precision="highest")
        cost = jnp.sum(huber_cost(sq, huber_delta) * w, axis=1)
        return H, g, cost

    H0, g0, cost0 = ne(x0)

    def body(_, carry):
        x, H, g, cost, lam = carry
        delta = jax.vmap(solve_damped)(H, g, lam)
        x_try = _retract_b(x, -delta)
        H_t, g_t, cost_t = ne(x_try)
        accept = cost_t < cost
        x = jnp.where(accept[:, None], x_try, x)
        H = jnp.where(accept[:, None, None], H_t, H)
        g = jnp.where(accept[:, None], g_t, g)
        cost = jnp.where(accept, cost_t, cost)
        lam = jnp.where(accept, jnp.maximum(lam * 0.33, 1e-7),
                        jnp.minimum(lam * 8.0, 1e2))
        return x, H, g, cost, lam

    lam0 = jnp.full((x0.shape[0],), 1e-4, jnp.float32)
    x, _, _, _, _ = jax.lax.fori_loop(0, iterations, body,
                                      (x0, H0, g0, cost0, lam0))
    return x


@partial(jax.jit, static_argnames=("cfg", "batch"))
def batch_solve_mapping(
    gm: BatchGridMap,
    corner_stack_xyz: jnp.ndarray,  # [B, Qc, 3]
    corner_stack_mask: jnp.ndarray,  # [B, Qc]
    surf_stack_xyz: jnp.ndarray,  # [B, Qs, 3]
    surf_stack_mask: jnp.ndarray,  # [B, Qs]
    q_pred: jnp.ndarray,  # [B, 4]
    t_pred: jnp.ndarray,  # [B, 3]
    cfg: LaserMappingConfig,
    batch: int,
):
    """B concurrent mapping solves + map inserts (no eviction — call
    batch_map_evict at chunk boundaries). Returns (gm', q_w [B,4],
    t_w [B,3]). Per-stream semantics match mapping.solve_mapping."""
    B = batch
    x0 = jnp.concatenate([q_pred, t_pred], axis=-1).astype(jnp.float32)
    enough = ((gm.corner.n_live > cfg.min_corner_map_points)
              & (gm.surf.n_live > cfg.min_surf_map_points))  # [B]

    # one flat candidate gather at the prediction pose, reused by both
    # rounds (same argument as mapping.solve_mapping:150-157)
    pc0 = so3.quat_rotate(x0[:, None, :4], corner_stack_xyz) + x0[:, None, 4:]
    cand_c = batch_grid_gather(gm.corner, pc0, cfg.corner_cell, B)
    ps0 = so3.quat_rotate(x0[:, None, :4], surf_stack_xyz) + x0[:, None, 4:]
    cand_s = batch_grid_gather(gm.surf, ps0, cfg.surf_cell, B)

    Qc = corner_stack_xyz.shape[1]
    Qs = surf_stack_xyz.shape[1]
    is_edge = (jnp.arange(Qc + Qs) < Qc)[:, None]
    cp = jnp.concatenate([corner_stack_xyz, surf_stack_xyz], axis=1)

    x = x0
    for _ in range(cfg.outer_rounds):
        a, b, de, v_c = _batch_corner_terms(corner_stack_xyz,
                                            corner_stack_mask, cand_c, x, cfg)
        n_hat, nood, v_s = _batch_surf_terms(surf_stack_xyz, surf_stack_mask,
                                             cand_s, x, cfg)
        A = jnp.concatenate([a, jnp.zeros_like(n_hat)], axis=1)
        Bp = jnp.concatenate([b, jnp.zeros_like(n_hat)], axis=1)
        DE = jnp.concatenate([de, jnp.ones((B, Qs), de.dtype)], axis=1)
        NH = jnp.concatenate([jnp.zeros_like(a), n_hat], axis=1)
        NOOD = jnp.concatenate([jnp.zeros((B, Qc), nood.dtype), nood], axis=1)
        w = jnp.concatenate([v_c, v_s], axis=1).astype(jnp.float32)
        x = _lm_solve_batched(x, cp, A, Bp, DE, NH, NOOD, is_edge, w,
                              cfg.gn_iterations, cfg.huber_delta)

    # sparse-map streams keep their prediction (see mapping.solve_mapping
    # :198-205 for why the unconditional solve + select is exact)
    x = jnp.where(enough[:, None], x, x0)
    q_w, t_w = x[:, :4], x[:, 4:]

    pw_c = so3.quat_rotate(q_w[:, None], corner_stack_xyz) + t_w[:, None]
    corner = batch_grid_insert(gm.corner, pw_c, corner_stack_mask,
                               cfg.corner_cell, cfg.line_resolution, B)
    pw_s = so3.quat_rotate(q_w[:, None], surf_stack_xyz) + t_w[:, None]
    surf = batch_grid_insert(gm.surf, pw_s, surf_stack_mask,
                             cfg.surf_cell, cfg.plane_resolution, B)
    return BatchGridMap(corner, surf, gm.center), q_w, t_w


@partial(jax.jit, static_argnames=("cfg", "batch"))
def batch_map_evict(gm: BatchGridMap, t_w: jnp.ndarray,
                    cfg: LaserMappingConfig, batch: int) -> BatchGridMap:
    """Chunk-granularity recentering (reference laser_mapping.cpp:207-402):
    evict points outside each stream's window when its pose crossed a cube
    boundary since the last eviction."""
    center = _cube_coord(t_w, cfg.cube_size)  # [B, 3]
    changed = jnp.any(center != gm.center, axis=-1)  # [B]
    radius = jnp.asarray([
        cfg.cube_width * cfg.cube_size / 2.0,
        cfg.cube_height * cfg.cube_size / 2.0,
        cfg.cube_depth * cfg.cube_size / 2.0,
    ], jnp.float32)
    c_w = center.astype(jnp.float32) * cfg.cube_size
    # streams that did not move keep an effectively infinite window
    big = jnp.float32(1e9)
    radius_b = jnp.where(changed[:, None], radius[None, :], big)

    def evict(g):
        cap = g.cap
        nb = g.n_buckets(batch)
        xyz = g.pts.reshape(batch, nb, 3, cap)
        live = xyz[:, :, 0] < SENTINEL * 0.5
        inside = jnp.all(
            jnp.abs(xyz - c_w[:, None, :, None]) <= radius_b[:, None, :,
                                                            None], axis=2)
        keep = live & inside
        pts = jnp.where(keep[:, :, None, :], xyz, SENTINEL)
        return BatchFeatureGrid(
            pts=pts.reshape(batch * nb, 3 * cap),
            n_live=jnp.sum(keep, axis=(1, 2), dtype=jnp.int32),
        )

    return BatchGridMap(evict(gm.corner), evict(gm.surf),
                        jnp.where(changed[:, None], center, gm.center))

"""LOAM scan registration as a fixed-shape vectorized kernel.

Reimplements reference src/lidar_odometry_mapping/src/scan_registration.cpp
(input():131-449) as fixed-shape array programs:

- range/NaN filtering, ring assignment and azimuth relative time are pure
  elementwise ops over a padded [N] point buffer (reference :157-267),
- the per-ring concatenated cloud becomes a dense [n_scans, ring_capacity]
  layout built with one stable sort (reference :276-281),
- the 11-point curvature (reference :288-307) is a windowed sum per ring,
- the sequential greedy feature selection with neighbor suppression
  (reference :312-431) becomes a vmapped-over-rings lax loop: 6 sectors x
  (20 corner picks + 4 flat picks), each pick an argmax/argmin over the ring
  lane — rings are independent in the reference (suppression never crosses a
  ring boundary), so the 64 rings run data-parallel; on a CUDA device the
  reference-exact strict order runs as one Triton program per ring,
- the per-ring 0.2 m VoxelGrid on the less-flat cloud (reference :433-439)
  uses the hash/sort/segment-mean kernel in voxel.py.

Outputs are ScanFeatures with masked fixed-capacity clouds.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import LidarProfile, ScanRegistrationConfig
from .ring_assoc import RingSlab, SENTINEL
from .types import FeatureCloud, ScanFeatures
from .voxel import voxel_downsample_rows_slab

_2PI = 2.0 * math.pi


def _trunc_int(x):
    """C-style int() cast: truncation toward zero."""
    return jnp.trunc(x).astype(jnp.int32)


def assign_rings(xyz: jnp.ndarray, valid: jnp.ndarray, profile: LidarProfile):
    """Elevation-angle ring id (reference scan_registration.cpp:192-226)."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    angle = jnp.degrees(jnp.arctan2(z, jnp.sqrt(x * x + y * y)))
    n = profile.n_scans
    if n == 16:
        sid = _trunc_int((angle + 15.0) / 2.0 + 0.5)
        ok = (sid >= 0) & (sid < n)
    elif n == 32:
        sid = _trunc_int((angle + 92.0 / 3.0) * 3.0 / 4.0)
        ok = (sid >= 0) & (sid < n)
    elif n == 64:
        upper = _trunc_int((2.0 - angle) * 3.0 + 0.5)
        lower = n // 2 + _trunc_int((-8.83 - angle) * 2.0 + 0.5)
        sid = jnp.where(angle >= -8.83, upper, lower)
        ok = (angle <= 2.0) & (angle >= -24.33) & (sid >= 0) & (sid <= 50)
    else:
        raise ValueError(f"unsupported scan_line {n}")
    return sid, valid & ok


def _relative_time(xyz, valid_range, valid_full):
    """Azimuth-interpolated relative time (reference :166-264), vectorized.

    The reference's sequential halfPassed flag becomes an exclusive
    cumulative-or over the trigger condition.
    """
    n = xyz.shape[0]
    ori = -jnp.arctan2(xyz[:, 1], xyz[:, 0])
    idx = jnp.arange(n)
    first = jnp.argmax(valid_range)
    last = n - 1 - jnp.argmax(valid_range[::-1])
    start_ori = ori[first]
    end_ori = ori[last] + _2PI
    span = end_ori - start_ori
    end_ori = jnp.where(span > 3 * math.pi, end_ori - _2PI,
                        jnp.where(span < math.pi, end_ori + _2PI, end_ori))

    before = ori
    before = jnp.where(before < start_ori - math.pi / 2, before + _2PI, before)
    before = jnp.where(before > start_ori + 3 * math.pi / 2, before - _2PI, before)
    trigger = valid_full & (before - start_ori > math.pi)
    half_passed = jnp.concatenate([jnp.zeros((1,), bool),
                                   jnp.cumsum(trigger.astype(jnp.int32))[:-1] > 0])

    after = ori + _2PI
    after = jnp.where(after < end_ori - 3 * math.pi / 2, after + _2PI, after)
    after = jnp.where(after > end_ori + math.pi / 2, after - _2PI, after)

    o = jnp.where(half_passed, after, before)
    return (o - start_ori) / (end_ori - start_ori)


def _ring_layout(xyz, ring, rel_time, valid, n_scans: int, ring_cap: int):
    """Scatter points into a dense [n_scans, ring_cap] layout preserving
    firing order within each ring (reference :266, :276-281)."""
    n = xyz.shape[0]
    key = jnp.where(valid, ring, n_scans) * n + jnp.arange(n)
    order = jnp.argsort(key)  # ring-major, stable in firing order
    ring_s = jnp.where(valid, ring, n_scans)[order]
    counts_raw = jnp.bincount(ring_s, length=n_scans + 1)[:n_scans]
    counts = jnp.minimum(counts_raw, ring_cap)
    starts = jnp.concatenate(
        [jnp.zeros((1,), counts_raw.dtype), jnp.cumsum(counts_raw)[:-1]]
    )
    rank = jnp.arange(n) - starts[jnp.minimum(ring_s, n_scans - 1)]
    dest_r = jnp.where((ring_s < n_scans) & (rank >= 0) & (rank < ring_cap), ring_s, n_scans)
    rank = jnp.clip(rank, 0, ring_cap - 1)

    pts = jnp.zeros((n_scans + 1, ring_cap, 3), xyz.dtype)
    pts = pts.at[dest_r, rank].set(xyz[order], mode="drop")[:n_scans]
    rt = jnp.zeros((n_scans + 1, ring_cap), xyz.dtype)
    rt = rt.at[dest_r, rank].set(rel_time[order], mode="drop")[:n_scans]
    return pts, rt, counts


def _curvature(ring_pts: jnp.ndarray) -> jnp.ndarray:
    """11-point curvature per ring: ||sum_{|l|<=5} p_{i+l} - 11 p_i||^2
    (reference :288-307)."""
    cs = jnp.concatenate(
        [jnp.zeros_like(ring_pts[:, :1]), jnp.cumsum(ring_pts, axis=1)], axis=1
    )  # [S, R+1, 3]
    r = ring_pts.shape[1]
    pad = jnp.pad(cs, ((0, 0), (5, 6), (0, 0)), mode="edge")
    win = pad[:, 11 : 11 + r] - pad[:, :r]  # sum over [i-5, i+5] (clamped)
    diff = win - 11.0 * ring_pts
    return jnp.sum(diff * diff, axis=-1)


def _break_prefix(pts, gap_sq):
    """Bf[i] = number of 3D gap breaks (consecutive-point distance^2 >
    gap_sq) among gaps (0,1)...(i-1,i). Two indices i<j are gap-connected
    iff Bf[i] == Bf[j]; the reference's +-5 suppression window around a pick
    (scan_registration.cpp:353-376) marks exactly the indices within 5 that
    are gap-connected to the pick, so suppression becomes one elementwise
    compare against the pick's prefix value — no dynamic slices."""
    d = jnp.sum((pts[1:] - pts[:-1]) ** 2, axis=-1)  # gap (i, i+1)
    brk = (d > gap_sq).astype(jnp.int32)
    return jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(brk)])


def _suppress_mask(idx, bf, ind):
    """Elementwise suppression window of a pick at `ind` (see _break_prefix)."""
    return (jnp.abs(idx - ind) <= 5) & (bf == bf[ind])


def _sector_masks(idx, start, end, ring_ok, exists, n_sectors):
    """[n_sectors, R] membership masks (reference sector bounds :317-320)."""
    masks = []
    for j in range(n_sectors):
        sp = start + (end - start) * j // n_sectors
        ep = start + (end - start) * (j + 1) // n_sectors - 1
        masks.append((idx >= sp) & (idx <= ep) & ring_ok & exists)
    return jnp.stack(masks)


def _select_ring(pts, curv, cnt, cfg: ScanRegistrationConfig):
    """Greedy feature selection for one ring. Returns label [R] int32:
    2 sharp, 1 less-sharp, -1 flat, 0 none; and the selectable-range mask.

    Strict mode (cfg.strict_sector_order) follows the reference exactly:
    sectors processed sequentially, each pick seeing all previous sectors'
    suppression. Batched mode (default) runs the 6 sectors' k-th picks
    simultaneously — one argmax over [n_sectors, R] per pick round instead
    of n_sectors separate rounds (6x fewer serialized device ops). The two
    differ only when a pick's +-5 suppression window crosses a sector
    boundary during the same round — a <=5/~425-candidate edge effect.
    """
    r_cap = pts.shape[0]
    idx = jnp.arange(r_cap)
    start, end = 5, cnt - 6  # scanStartInd/scanEndInd in-ring (reference :278-280)
    ring_ok = (end - start) >= 6  # reference :314
    exists = idx < cnt
    gap_sq = cfg.neighbor_suppress_gap_sq
    thr = cfg.curvature_threshold
    n_corner = cfg.max_less_sharp_per_sector
    n_flat = cfg.max_flat_per_sector
    bf = _break_prefix(pts, gap_sq)
    sect = _sector_masks(idx, start, end, ring_ok, exists, cfg.n_sectors)

    picked = jnp.zeros((r_cap,), bool)
    label = jnp.zeros((r_cap,), jnp.int32)

    if cfg.strict_sector_order:
        # Reference-exact sequential order — sector j's picks see all of
        # sector j-1's suppression — as ONE flat fori_loop of
        # n_sectors * (n_corner + n_flat) steps with a branchless body
        # (step s decodes to sector j, pick rank k; corner picks maximize
        # curv, flat picks maximize -curv). One loop body compiles like the
        # batched path and just runs 6x more serialized pick rounds.
        per_sector = n_corner + n_flat

        def strict_pick(s, st):
            picked, label = st
            j = s // per_sector
            k = s % per_sector
            in_sector = jax.lax.dynamic_index_in_dim(sect, j, keepdims=False)
            is_corner = k < n_corner
            score = jnp.where(is_corner, curv, -curv)
            gate = jnp.where(is_corner, curv > thr, curv < thr)
            c = jnp.where(in_sector & ~picked & gate, score, -jnp.inf)
            ind = jnp.argmax(c)
            ok = c[ind] > jnp.where(is_corner, thr, -thr)
            lab = jnp.where(is_corner,
                            jnp.where(k < cfg.max_sharp_per_sector, 2, 1),
                            -1)
            label = jnp.where(ok, label.at[ind].set(lab), label)
            # The reference breaks out before suppressing the last flat
            # pick (scan_registration.cpp:390-394).
            do_supp = ok & (is_corner | (k - n_corner < n_flat - 1))
            picked = picked | (do_supp & _suppress_mask(idx, bf, ind))
            return picked, label

        _, label = jax.lax.fori_loop(0, cfg.n_sectors * per_sector,
                                     strict_pick, (picked, label))
    else:
        ns = cfg.n_sectors
        srange = jnp.arange(ns)

        def corner_round(k, st):
            picked, label = st
            elig = sect & (~picked & (curv > thr))[None, :]  # [ns, R]
            c = jnp.where(elig, curv[None, :], -jnp.inf)
            ind = jnp.argmax(c, axis=1)  # [ns]
            ok = c[srange, ind] > thr
            lab = jnp.where(k < cfg.max_sharp_per_sector, 2, 1)
            label = label.at[ind].set(jnp.where(ok, lab, label[ind]))
            supp = (jnp.abs(idx[None, :] - ind[:, None]) <= 5) & (
                bf[None, :] == bf[ind][:, None]) & ok[:, None]
            picked = picked | jnp.any(supp, axis=0)
            return picked, label

        picked, label = jax.lax.fori_loop(0, n_corner, corner_round,
                                          (picked, label))

        def flat_round(k, st):
            picked, label = st
            elig = sect & (~picked & (curv < thr))[None, :]
            c = jnp.where(elig, curv[None, :], jnp.inf)
            ind = jnp.argmin(c, axis=1)
            ok = c[srange, ind] < thr
            label = label.at[ind].set(jnp.where(ok, -1, label[ind]))
            supp = (jnp.abs(idx[None, :] - ind[:, None]) <= 5) & (
                bf[None, :] == bf[ind][:, None]) & (
                ok & (k < n_flat - 1))[:, None]
            picked = picked | jnp.any(supp, axis=0)
            return picked, label

        _, label = jax.lax.fori_loop(0, n_flat, flat_round, (picked, label))

    selectable = (idx >= start) & (idx <= end - 1) & ring_ok & exists
    return label, selectable


def _select_ring_kernel(curv_ref, bf_ref, cnt_ref, label_ref,
                        *, cfg: ScanRegistrationConfig):
    """Strict sector selection for ONE ring (one program per ring).

    The XLA form of the strict branch of _select_ring runs each of its
    n_sectors*(n_corner+n_flat) = 144 serialized pick rounds as separate
    small kernels in a device while-loop, re-reading and re-writing the
    [S, R] picked/label state every round. Here the whole loop runs inside
    one program whose curvature, break prefix and picked/label state stay in
    registers; the labels are written once. Same argmax/suppression
    semantics as _select_ring's strict branch (reference
    scan_registration.cpp:312-440), bit-identical labels.

    curv_ref/bf_ref/label_ref: [RP] rows (the ring padded to a power of two;
    padded lanes lie beyond the count and are never picked);
    cnt_ref: [1] the ring's point count.
    """
    f32, i32 = jnp.float32, jnp.int32
    curv = curv_ref[...]
    bf = bf_ref[...]
    cnt = jnp.sum(cnt_ref[...])
    rp = curv.shape[0]
    col = jax.lax.broadcasted_iota(jnp.int32, (rp,), 0)
    start = 5
    end = cnt - 6
    width = end - start
    eligible = (width >= 6) & (col < cnt)
    thr = cfg.curvature_threshold
    n_corner = cfg.max_less_sharp_per_sector
    n_flat = cfg.max_flat_per_sector
    per_sector = n_corner + n_flat
    ns = cfg.n_sectors

    def round_body(s, st):
        picked, label = st
        # lax.div/rem: truncating forms (operands are non-negative where
        # they matter; a ring with width < 0 has no eligible lanes)
        j = jax.lax.div(s, per_sector)
        k = jax.lax.rem(s, per_sector)
        is_corner = k < n_corner
        sp = start + jax.lax.div(width * j, ns)
        ep = start + jax.lax.div(width * (j + 1), ns) - 1
        # corner: maximize curv gated at curv > thr; flat: maximize -curv
        # gated at curv < thr — both are `score > tj` with score = sgn*curv.
        # Select operands are strongly typed: the Triton lowering gives a
        # weakly typed select operand the predicate's (bool) type.
        sgn = jnp.where(is_corner, f32(1.0), f32(-1.0))
        tj = jnp.where(is_corner, f32(thr), f32(-thr))
        score = curv * sgn
        c = jnp.where((col >= sp) & (col <= ep) & eligible & (picked == 0)
                      & (score > tj), score, f32(-jnp.inf))
        m = jnp.max(c)
        ind = jnp.min(jnp.where(c >= m, col, i32(rp)))  # first argmax
        ok = m > tj
        lab = jnp.where(is_corner,
                        jnp.where(k < cfg.max_sharp_per_sector, i32(2),
                                  i32(1)), i32(-1))
        at_pick = col == ind
        label = jnp.where(at_pick & ok, lab, label)
        # the reference breaks before suppressing the last flat pick
        do_supp = ok & (is_corner | (k - n_corner < n_flat - 1))
        bf_pick = jnp.max(jnp.where(at_pick, bf, i32(-1)))
        supp = (jnp.abs(col - ind) <= 5) & (bf == bf_pick) & do_supp
        picked = jnp.where(supp, i32(1), picked)
        return picked, label

    zeros = jnp.zeros((rp,), jnp.int32)
    _, label = jax.lax.fori_loop(0, ns * per_sector, round_body,
                                 (zeros, zeros))
    label_ref[...] = label


def _select_rings_kernel(pts, curv, counts, cfg: ScanRegistrationConfig,
                         interpret: bool = False):
    """Strict selection over all rings with _select_ring_kernel (Pallas
    through Triton, grid (S,)); returns (label [S, R], selectable [S, R])
    identical to the vmapped _select_ring(strict)."""
    S, R = curv.shape
    rp = 1 << (R - 1).bit_length()
    bf = jax.vmap(lambda p: _break_prefix(p, cfg.neighbor_suppress_gap_sq))(
        pts)[:, :R]  # prefix value AT each index
    pad = ((0, 0), (0, rp - R))
    label = pl.pallas_call(
        partial(_select_ring_kernel, cfg=cfg),
        grid=(S,),
        in_specs=[pl.BlockSpec((None, rp), lambda i: (i, 0)),
                  pl.BlockSpec((None, rp), lambda i: (i, 0)),
                  pl.BlockSpec((1,), lambda i: (i,))],
        out_specs=pl.BlockSpec((None, rp), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((S, rp), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=8, num_stages=1),
        interpret=interpret,
        name="select_ring_strict",
    )(jnp.pad(curv, pad), jnp.pad(bf, pad), counts.astype(jnp.int32))
    idx = jnp.arange(R)[None, :]
    end = counts[:, None] - 6
    selectable = ((idx >= 5) & (idx <= end - 1) & (end - 5 >= 6)
                  & (idx < counts[:, None]))
    return label[:, :R], selectable


def _features_from_layout(pts, rt, counts, cfg: ScanRegistrationConfig
                          ) -> ScanFeatures:
    """Shared back half: curvature, greedy selection, and feature-cloud
    assembly from a dense per-ring layout pts [S, R, 3] / rt [S, R] /
    counts [S] (reference scan_registration.cpp:288-449)."""
    S, R = pts.shape[0], pts.shape[1]
    curv = _curvature(pts)

    def select_xla(p, c, k):
        return jax.vmap(lambda p, c, k: _select_ring(p, c, k, cfg))(p, c, k)

    if cfg.strict_sector_order:
        # Strict selection compiled for a CUDA device runs as one Triton
        # program per ring; any other target lowers the XLA form.
        label, selectable = jax.lax.platform_dependent(
            pts, curv, counts, default=select_xla,
            cuda=lambda p, c, k: _select_rings_kernel(p, c, k, cfg))
    else:
        label, selectable = select_xla(pts, curv, counts)

    ring_ids = jnp.broadcast_to(jnp.arange(S)[:, None], (S, R))
    exists = jnp.arange(R)[None, :] < counts[:, None]

    # Per-ring label partition: one row-wise multi-operand sort by group key
    # (0=sharp, 1=less-sharp, 2=flat, 3=rest) replaces the previous S*R-point
    # global argsort (rings are independent, so each row sorts alone).
    # Each cloud is then a fixed per-ring block
    # — sharp is a prefix of less-sharp, flat the following group — flattened
    # with masks; capacity splits evenly across rings (cap // S per ring),
    # which also degrades overflow gracefully (the old global truncation
    # dropped entire trailing rings).
    group = jnp.where(label == 2, 0,
                      jnp.where(label == 1, 1,
                                jnp.where(label == -1, 2, 3)))  # [S, R]
    g_s, x_s, y_s, z_s, rt_s = jax.lax.sort(
        (group, pts[..., 0], pts[..., 1], pts[..., 2], rt),
        num_keys=1, dimension=1)
    pts_s = jnp.stack([x_s, y_s, z_s], axis=-1)  # [S, R, 3]
    n_sharp_r = jnp.sum(group == 0, axis=1)  # [S]
    n_less_r = jnp.sum(group == 1, axis=1)
    n_flat_r = jnp.sum(group == 2, axis=1)

    def slice_rows(start_r, count_r, cap):
        per = cap // S
        cols = jnp.clip(start_r[:, None] + jnp.arange(per)[None, :], 0, R - 1)
        m = (jnp.arange(per)[None, :] < jnp.minimum(count_r, per)[:, None])
        xyz_b = jnp.take_along_axis(pts_s, cols[:, :, None], axis=1)
        rt_b = jnp.take_along_axis(rt_s, cols, axis=1)
        return FeatureCloud(
            xyz=jnp.where(m[:, :, None], xyz_b, 0.0).reshape(cap, 3),
            ring=jnp.where(m, ring_ids[:, :per], 0).reshape(cap),
            rel_time=jnp.where(m, rt_b, 0.0).reshape(cap),
            mask=m.reshape(cap),
        )

    zero_r = jnp.zeros((S,), jnp.int32)
    sharp = slice_rows(zero_r, n_sharp_r, cfg.sharp_cap)
    less_sharp = slice_rows(zero_r, n_sharp_r + n_less_r, cfg.less_sharp_cap)
    flat = slice_rows(n_sharp_r + n_less_r, n_flat_r, cfg.flat_cap)

    # LO candidate slabs in the native per-ring layout (ring_assoc.py):
    # sentinel-padded so the association kernel needs no masks. less_sharp
    # is already a per-ring block (slice_rows); less_flat keeps the slab
    # layout straight out of the per-ring voxel filter — the old global
    # prefix-compaction sorts existed only to restore the dense layout
    # lax.approx_min_k's recall depended on, and the exact per-ring-min
    # association removed that dependency.
    ls_per = cfg.less_sharp_cap // S
    ls_xyz = less_sharp.xyz.reshape(S, ls_per, 3)
    ls_m = less_sharp.mask.reshape(S, ls_per)
    less_sharp_slab = RingSlab(jnp.where(ls_m[:, :, None], ls_xyz, SENTINEL))

    lf_mask = selectable & (label <= 0)
    lf_cap_r = cfg.less_flat_cap // S
    lf_xyz, lf_extra, lf_m = voxel_downsample_rows_slab(
        pts, lf_mask, cfg.less_flat_leaf, lf_cap_r, extra=rt[..., None],
    )
    less_flat_slab = RingSlab(jnp.where(lf_m[:, :, None], lf_xyz, SENTINEL))
    less_flat = FeatureCloud(
        xyz=jnp.where(lf_m[:, :, None], lf_xyz, 0.0).reshape(-1, 3),
        ring=jnp.where(lf_m, jnp.arange(S, dtype=jnp.int32)[:, None],
                       0).reshape(-1),
        rel_time=jnp.where(lf_m, lf_extra[..., 0], 0.0).reshape(-1),
        mask=lf_m.reshape(-1),
    )

    full = FeatureCloud(xyz=pts.reshape(-1, 3), ring=ring_ids.reshape(-1),
                        rel_time=rt.reshape(-1), mask=exists.reshape(-1))

    return ScanFeatures(sharp=sharp, less_sharp=less_sharp,
                        flat=flat, less_flat=less_flat, full=full,
                        less_sharp_slab=less_sharp_slab,
                        less_flat_slab=less_flat_slab)


def scan_layout(xyz: jnp.ndarray, n_points: jnp.ndarray,
                profile: LidarProfile):
    """Dense per-ring layout of one padded scan [max_points, 3]: returns
    pts [S, R, 3], rel_time [S, R], counts [S] (R = ring_capacity)."""
    n = xyz.shape[0]
    in_range = jnp.arange(n) < n_points
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    xyz = jnp.where(finite[:, None], xyz, 0.0)
    rng_sq = jnp.sum(xyz * xyz, axis=-1)
    valid_range = in_range & finite & (rng_sq >= profile.minimum_range**2)

    ring, valid = assign_rings(xyz, valid_range, profile)
    rel = _relative_time(xyz, valid_range, valid)

    return _ring_layout(xyz, ring, rel, valid, profile.n_scans,
                        profile.ring_capacity)


@partial(jax.jit, static_argnames=("profile", "cfg"))
def register_scan(
    xyz: jnp.ndarray,
    n_points: jnp.ndarray,
    profile: LidarProfile,
    cfg: ScanRegistrationConfig,
) -> ScanFeatures:
    """Extract LOAM features from one padded scan [max_points, 3]."""
    pts, rt, counts = scan_layout(xyz, n_points, profile)
    return _features_from_layout(pts, rt, counts, cfg)


def polar_layout(ranges_u16: jnp.ndarray, elev_rad: jnp.ndarray,
                 profile: LidarProfile, scale: float = 0.005):
    """Dense per-ring layout of a quantized range image [S, A]: returns
    pts [S, A, 3], rel_time [S, A], counts [S].

    The range image IS the per-ring layout (row = ring, column order =
    firing order, rel_time = column/A), so the xyz path's elevation-angle
    ring assignment, halfPassed azimuth unwrap, and the 131k-point global
    sort all collapse into one per-row compaction of valid returns."""
    S, A = ranges_u16.shape
    r = ranges_u16.astype(jnp.float32) * scale
    valid = r >= profile.minimum_range  # also rejects r == 0 (no return)
    az = -jnp.linspace(0.0, 2.0 * jnp.pi, A, endpoint=False)
    ce, se = jnp.cos(elev_rad), jnp.sin(elev_rad)
    ca, sa = jnp.cos(az), jnp.sin(az)
    xyz = jnp.stack([
        ce[:, None] * ca[None, :],
        ce[:, None] * sa[None, :],
        jnp.broadcast_to(se[:, None], (S, A)),
    ], axis=-1) * r[:, :, None]  # [S, A, 3]
    rel = jnp.broadcast_to((jnp.arange(A) / A)[None, :], (S, A))

    # compact valid returns to the front of each ring: one stable row-wise
    # multi-operand sort (payload carried through the sort network — no
    # post-sort gathers)
    col = jnp.broadcast_to(jnp.arange(A, dtype=jnp.int32)[None, :], (S, A))
    key = jnp.where(valid, col, A)
    _, x_s, y_s, z_s, rel_s, v_s = jax.lax.sort(
        (key, xyz[..., 0], xyz[..., 1], xyz[..., 2], rel,
         valid.astype(jnp.int32)),
        num_keys=1, dimension=1)
    ok = v_s > 0
    pts = jnp.where(ok[:, :, None], jnp.stack([x_s, y_s, z_s], axis=-1), 0.0)
    rt = jnp.where(ok, rel_s, 0.0)
    counts = jnp.sum(valid, axis=1).astype(jnp.int32)
    return pts, rt, counts


@partial(jax.jit, static_argnames=("profile", "cfg", "scale"))
def register_scan_polar(
    ranges_u16: jnp.ndarray,  # [S, A] quantized ranges (0 = no return)
    elev_rad: jnp.ndarray,  # [S]
    profile: LidarProfile,
    cfg: ScanRegistrationConfig,
    scale: float = 0.005,
) -> ScanFeatures:
    """Extract LOAM features straight from a quantized range image."""
    pts, rt, counts = polar_layout(ranges_u16, elev_rad, profile, scale)
    return _features_from_layout(pts, rt, counts, cfg)

"""Brute-force nearest-neighbor search.

Replaces pcl::KdTreeFLANN (reference laser_odometry.cpp:269,356,
laser_mapping.cpp:477,543) with tiled brute-force distance computation: for
these problem sizes (10^3 queries x 10^4-10^5 candidates) a dense
||q||^2 + ||c||^2 - 2 q.c product swept in tiles needs no pointer chasing
and no dynamic shapes, and XLA fuses it.

All functions are masked: invalid candidates get +inf distance; invalid
queries produce garbage that callers mask out.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_INF = jnp.inf


def _pad_to(x, size, axis=0, fill=0):
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=fill)


def _dist_sq(q: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """[Tq, Tc] squared distances as |q|^2 + |c|^2 - 2 q.c.

    The product runs at full float32 precision: at 80 m coordinates
    |q|^2 ~ 6400 m^2, so a TF32 or bf16 product (~2^-11 relative) would err
    by several m^2 and scramble neighbor ordering at LOAM's 0.05-0.2 m
    feature spacing."""
    qq = jnp.sum(q * q, axis=-1, keepdims=True)
    cc = jnp.sum(c * c, axis=-1)[None, :]
    qc = jnp.dot(q, c.T, preferred_element_type=jnp.float32,
                 precision="highest")
    return jnp.maximum(qq + cc - 2.0 * qc, 0.0)


@partial(jax.jit, static_argnames=("k", "q_tile", "c_tile"))
def masked_knn(
    queries: jnp.ndarray,
    cands: jnp.ndarray,
    c_mask: jnp.ndarray,
    k: int = 5,
    q_tile: int = 256,
    c_tile: int = 4096,
):
    """k nearest candidates per query. Returns (d_sq [Q,k], idx [Q,k]),
    ascending by distance; masked-out candidates appear as +inf."""
    Q = queries.shape[0]
    C = cands.shape[0]
    nq = -(-Q // q_tile)
    nc = -(-C // c_tile)
    qp = _pad_to(queries, nq * q_tile).reshape(nq, q_tile, 3)
    cp = _pad_to(cands, nc * c_tile).reshape(nc, c_tile, 3)
    mp = _pad_to(c_mask, nc * c_tile, fill=False).reshape(nc, c_tile)

    def one_qtile(qt):
        def tile_topk(ct, cm, base):
            d = jnp.where(cm[None, :], _dist_sq(qt, ct), jnp.float32(_INF))
            ti = base + jnp.arange(c_tile, dtype=jnp.int32)
            td, tt = jax.lax.top_k(-d, k)
            return -td, ti[tt]

        def scan_ctile(carry, inp):
            best_d, best_i = carry
            ct, cm, base = inp
            td, ti = tile_topk(ct, cm, base)
            cat_d = jnp.concatenate([best_d, td], axis=1)
            cat_i = jnp.concatenate([best_i, ti], axis=1)
            md, mi = jax.lax.top_k(-cat_d, k)
            take = jnp.take_along_axis(cat_i, mi, axis=1)
            return (-md, take), None

        # seed the carry from tile 0 so its sharding/varying type matches the
        # body output under shard_map (a plain full() init is "unvarying" and
        # rejected inside manual-sharding regions)
        bases = jnp.arange(nc, dtype=jnp.int32) * c_tile
        init = tile_topk(cp[0], mp[0], bases[0])
        (bd, bi), _ = jax.lax.scan(scan_ctile, init,
                                   (cp[1:], mp[1:], bases[1:]))
        return bd, bi

    bd, bi = jax.lax.map(one_qtile, qp)
    return bd.reshape(-1, k)[:Q], bi.reshape(-1, k)[:Q]


@partial(jax.jit, static_argnames=("mode", "c_tile"))
def nearest_and_ring_constrained(
    queries: jnp.ndarray,
    cands: jnp.ndarray,
    c_ring: jnp.ndarray,
    c_mask: jnp.ndarray,
    nearby_scan: float,
    mode: str = "corner",
    c_tile: int = 4096,
):
    """LO correspondence search (reference laser_odometry.cpp:266-444).

    Pass 1: unconstrained nearest candidate -> (d0, i0, ring0).
    Pass 2 (corner): nearest with ring != ring0 and |ring-ring0| <= nearby.
    Pass 2 (surf): additionally nearest with ring == ring0 excluding i0.

    Returns dict with d0,i0 and the constrained (d2,i2) / (d3,i3).
    """
    d0, i0 = masked_knn(queries, cands, c_mask, k=1, c_tile=c_tile)
    d0, i0 = d0[:, 0], i0[:, 0]
    ring0 = c_ring[i0]

    Q = queries.shape[0]
    C = cands.shape[0]
    nc = -(-C // c_tile)
    cp = _pad_to(cands, nc * c_tile).reshape(nc, c_tile, 3)
    rp = _pad_to(c_ring, nc * c_tile).reshape(nc, c_tile)
    mp = _pad_to(c_mask, nc * c_tile, fill=False).reshape(nc, c_tile)

    def scan_ctile(carry, inp):
        ct, cr, cm, base = inp
        d = jnp.where(cm[None, :], _dist_sq(queries, ct), _INF)
        ti = base + jnp.arange(c_tile)[None, :]
        diff = cr[None, :] - ring0[:, None]
        near = jnp.abs(diff).astype(jnp.float32) <= nearby_scan
        m_other = (diff != 0) & near
        d_other = jnp.where(m_other, d, _INF)
        a2 = jnp.argmin(d_other, axis=1)
        cand2 = (jnp.take_along_axis(d_other, a2[:, None], 1)[:, 0],
                 jnp.take_along_axis(ti, a2[:, None], 1)[:, 0])
        if mode == "surf":
            m_same = (diff == 0) & (ti != i0[:, None])
            d_same = jnp.where(m_same, d, _INF)
            a3 = jnp.argmin(d_same, axis=1)
            cand3 = (jnp.take_along_axis(d_same, a3[:, None], 1)[:, 0],
                     jnp.take_along_axis(ti, a3[:, None], 1)[:, 0])
        else:
            cand3 = (jnp.full((Q,), _INF), jnp.zeros((Q,), jnp.int32))
        (b2d, b2i), (b3d, b3i) = carry
        up2 = cand2[0] < b2d
        up3 = cand3[0] < b3d
        return (
            (jnp.where(up2, cand2[0], b2d), jnp.where(up2, cand2[1], b2i)),
            (jnp.where(up3, cand3[0], b3d), jnp.where(up3, cand3[1], b3i)),
        ), None

    init = (
        (jnp.full((Q,), _INF), jnp.zeros((Q,), jnp.int32)),
        (jnp.full((Q,), _INF), jnp.zeros((Q,), jnp.int32)),
    )
    bases = jnp.arange(nc) * c_tile
    ((d2, i2), (d3, i3)), _ = jax.lax.scan(
        scan_ctile, init, (cp, rp, mp, bases)
    )
    return {"d0": d0, "i0": i0, "d2": d2, "i2": i2, "d3": d3, "i3": i3}

"""Flat-batched mapping (lidar/batch_mapping.py) parity vs the per-stream
single-device path: the stream-folded table must reproduce grid_insert /
grid_gather / solve_mapping per stream."""

import jax
import jax.numpy as jnp
import numpy as np

from vloam.config import kitti_hdl64
from vloam.lidar import batch_mapping as bm
from vloam.lidar.gridmap import (FeatureGrid, grid_create, grid_evict,
                                     grid_gather, grid_insert)
from vloam.lidar.mapping import GridMap, solve_mapping


def small_map_cfg():
    import dataclasses

    return dataclasses.replace(
        kitti_hdl64().mapping, map_n_buckets=1 << 10, corner_bucket_cap=8,
        surf_bucket_cap=8, corner_stack_cap=128, surf_stack_cap=256)


def _rand_stream(seed, n, extent=20.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-extent, extent, (n, 3)).astype(np.float32)


def test_batch_insert_matches_per_stream():
    cfg = small_map_cfg()
    B, S = 2, 128
    nb, cap = cfg.map_n_buckets, cfg.corner_bucket_cap
    pts = np.stack([_rand_stream(7, S), _rand_stream(8, S)])
    mask = np.ones((B, S), bool)
    mask[0, -5:] = False

    bg = bm.BatchFeatureGrid(
        pts=jnp.full((B * nb, 3 * cap), 1.0e6, jnp.float32),
        n_live=jnp.zeros((B,), jnp.int32))
    # two insert rounds (second exercises dup check + hole filling)
    for k in range(2):
        shift = 0.05 * k
        bg = bm.batch_grid_insert(bg, jnp.asarray(pts + shift),
                                  jnp.asarray(mask), cfg.corner_cell,
                                  cfg.line_resolution, B)

    for b in range(B):
        g = grid_create(nb, cap)
        for k in range(2):
            g = grid_insert(g, jnp.asarray(pts[b] + 0.05 * k),
                            jnp.asarray(mask[b]), cfg.corner_cell,
                            cfg.line_resolution)
        blk = np.asarray(bg.pts[b * nb:(b + 1) * nb])
        ref = np.asarray(g.pts)
        # the merged insert stores fixed-point-quantized coordinates
        # (~tens of microns); see _merged_row_insert
        np.testing.assert_allclose(blk, ref, atol=1e-3)
        assert int(bg.n_live[b]) == int(g.n_live)


def test_batch_gather_matches_per_stream():
    cfg = small_map_cfg()
    B, S = 2, 128
    nb, cap = cfg.map_n_buckets, cfg.corner_bucket_cap
    pts = np.stack([_rand_stream(17, S), _rand_stream(18, S)])
    mask = np.ones((B, S), bool)
    bg = bm.BatchFeatureGrid(
        pts=jnp.full((B * nb, 3 * cap), 1.0e6, jnp.float32),
        n_live=jnp.zeros((B,), jnp.int32))
    bg = bm.batch_grid_insert(bg, jnp.asarray(pts), jnp.asarray(mask),
                              cfg.corner_cell, cfg.line_resolution, B)
    q = np.stack([_rand_stream(27, 64, 18.0), _rand_stream(28, 64, 18.0)])
    cand = bm.batch_grid_gather(bg, jnp.asarray(q), cfg.corner_cell, B)

    for b in range(B):
        g = FeatureGrid(pts=bg.pts[b * nb:(b + 1) * nb],
                        n_live=bg.n_live[b])
        ref = grid_gather(g, jnp.asarray(q[b]), cfg.corner_cell)
        got = cand[:, b * 64:(b + 1) * 64]
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=1e-6)


def test_batch_solve_matches_per_stream():
    cfg = small_map_cfg()
    B = 2
    nb = cfg.map_n_buckets
    rng = np.random.default_rng(3)

    # structured scene per stream: a line of corners + two planes of surfs
    def scene(seed):
        r = np.random.default_rng(seed)
        t = r.uniform(-8, 8, (cfg.corner_stack_cap,))
        corners = np.stack([t, np.full_like(t, 2.0), np.full_like(t, 1.0)],
                           1) + r.normal(0, 0.01, (len(t), 3))
        xs = r.uniform(-8, 8, (cfg.surf_stack_cap,))
        ys = r.uniform(-8, 8, (cfg.surf_stack_cap,))
        ground = np.stack([xs, ys, np.zeros_like(xs)], 1)
        return corners.astype(np.float32), ground.astype(np.float32)

    streams = [scene(40 + b) for b in range(B)]
    c_xyz = jnp.asarray(np.stack([s[0] for s in streams]))
    s_xyz = jnp.asarray(np.stack([s[1] for s in streams]))
    c_m = jnp.ones(c_xyz.shape[:2], bool)
    s_m = jnp.ones(s_xyz.shape[:2], bool)

    bgm = bm.BatchGridMap.create(cfg, B)
    ident = jnp.broadcast_to(jnp.asarray([0, 0, 0, 1], jnp.float32), (B, 4))
    zero = jnp.zeros((B, 3), jnp.float32)
    # seed the maps
    bgm, _, _ = bm.batch_solve_mapping(bgm, c_xyz, c_m, s_xyz, s_m, ident,
                                       zero, cfg, B)
    # second frame at a slightly wrong prediction: the solve must pull back
    q_pred = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.01, 0.99995], jnp.float32), (B, 4))
    t_pred = jnp.broadcast_to(jnp.asarray([0.05, -0.03, 0.02], jnp.float32),
                              (B, 3))
    bgm2, q_b, t_b = bm.batch_solve_mapping(bgm, c_xyz, c_m, s_xyz, s_m,
                                            q_pred, t_pred, cfg, B)

    for b in range(B):
        gm = GridMap(
            corner=FeatureGrid(pts=bgm.corner.pts[b * nb:(b + 1) * nb],
                               n_live=bgm.corner.n_live[b]),
            surf=FeatureGrid(pts=bgm.surf.pts[b * nb:(b + 1) * nb],
                             n_live=bgm.surf.n_live[b]),
            center=jnp.zeros((3,), jnp.int32),
        )
        _, q_s, t_s, _ = solve_mapping(gm, c_xyz[b], c_m[b], s_xyz[b],
                                       s_m[b], q_pred[b], t_pred[b], cfg)
        np.testing.assert_allclose(np.asarray(q_b[b]), np.asarray(q_s),
                                   atol=2e-4)
        np.testing.assert_allclose(np.asarray(t_b[b]), np.asarray(t_s),
                                   atol=2e-3)


def test_batch_evict_matches_per_stream():
    cfg = small_map_cfg()
    B, S = 2, 128
    nb, cap = cfg.map_n_buckets, cfg.corner_bucket_cap
    pts = np.stack([_rand_stream(57, S, 400.0), _rand_stream(58, S, 400.0)])
    mask = np.ones((B, S), bool)
    bg = bm.BatchFeatureGrid(
        pts=jnp.full((B * nb, 3 * cap), 1.0e6, jnp.float32),
        n_live=jnp.zeros((B,), jnp.int32))
    bg = bm.batch_grid_insert(bg, jnp.asarray(pts), jnp.asarray(mask),
                              cfg.corner_cell, cfg.line_resolution, B)
    centers = jnp.asarray([[10.0, 0.0, 0.0], [-5.0, 3.0, 0.0]], jnp.float32)
    radius = jnp.asarray([200.0, 150.0, 100.0], jnp.float32)
    got = bm.batch_grid_evict(bg, centers, radius, B)
    for b in range(B):
        g = FeatureGrid(pts=bg.pts[b * nb:(b + 1) * nb], n_live=bg.n_live[b])
        ref = grid_evict(g, centers[b], radius)
        np.testing.assert_allclose(
            np.asarray(got.pts[b * nb:(b + 1) * nb]), np.asarray(ref.pts),
            atol=1e-3)
        assert int(got.n_live[b]) == int(ref.n_live)

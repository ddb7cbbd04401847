import numpy as np
import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation as R

from vloam.parallel.pose_graph import (PoseGraph, build_odometry_graph,
                                           optimize_pose_graph)
from vloam.parallel.sharded import (data_mesh, shard_batch,
                                        sharded_point_to_plane_gn)


def circle_poses(n, radius=20.0):
    out = []
    for k in range(n):
        th = 2 * np.pi * k / n
        q = R.from_euler("z", th + np.pi / 2).as_quat()
        t = np.array([radius * np.cos(th), radius * np.sin(th), 0.0])
        out.append(np.concatenate([q, t]))
    return np.stack(out)


def drifted_init(gt, rng, sigma_t=0.05, sigma_r=0.004):
    """Integrate noisy odometry to get a drifted initial trajectory."""
    n = len(gt)
    poses = [gt[0]]
    for i in range(1, n):
        qi = R.from_quat(gt[i - 1, :4])
        qj = R.from_quat(gt[i, :4])
        dq = (qi.inv() * qj).as_rotvec() + rng.normal(0, sigma_r, 3)
        dt = qi.inv().apply(gt[i, 4:] - gt[i - 1, 4:]) + rng.normal(0, sigma_t, 3)
        qp = R.from_quat(poses[-1][:4])
        q_new = (qp * R.from_rotvec(dq)).as_quat()
        t_new = poses[-1][4:] + qp.apply(dt)
        poses.append(np.concatenate([q_new, t_new]))
    return np.stack(poses)


def test_pose_graph_closes_loop(rng):
    n = 40
    gt = circle_poses(n)
    init = drifted_init(gt, rng)

    # measurements: true relative poses (odometry) + a loop closure 0<->n-1
    def meas_fn(i, j):
        qi = R.from_quat(gt[i, :4])
        qj = R.from_quat(gt[j, :4])
        q = (qi.inv() * qj).as_quat()
        t = qi.inv().apply(gt[j, 4:] - gt[i, 4:])
        return np.concatenate([q, t])

    graph = build_odometry_graph(init, loop_pairs=[(n - 1, 0), (n // 2, 0)],
                                 meas_fn=meas_fn, loop_weight=2.0)
    opt = np.asarray(optimize_pose_graph(graph, gn_iters=6, cg_iters=128))
    err_init = np.linalg.norm(init[:, 4:] - gt[:, 4:], axis=1).mean()
    err_opt = np.linalg.norm(opt[:, 4:] - gt[:, 4:], axis=1).mean()
    assert err_opt < 0.05 * err_init, (err_init, err_opt)


def test_pose_graph_sharded_matches_single(rng):
    n = 24
    gt = circle_poses(n)
    init = drifted_init(gt, rng)

    def meas_fn(i, j):
        qi = R.from_quat(gt[i, :4])
        qj = R.from_quat(gt[j, :4])
        return np.concatenate([(qi.inv() * qj).as_quat(),
                               qi.inv().apply(gt[j, 4:] - gt[i, 4:])])

    g = build_odometry_graph(init, loop_pairs=[(n - 1, 0)], meas_fn=meas_fn)
    single = np.asarray(optimize_pose_graph(g, gn_iters=4, cg_iters=64))

    mesh = data_mesh()
    nd = mesh.shape["data"]
    e = len(g.edge_i)
    pad = (-e) % nd
    gp = PoseGraph(
        poses=g.poses,
        edge_i=shard_batch(g.edge_i, mesh),
        edge_j=shard_batch(g.edge_j, mesh),
        meas=shard_batch(g.meas, mesh),
        weight=shard_batch(g.weight, mesh),
    )
    sharded = np.asarray(optimize_pose_graph(gp, mesh=mesh, gn_iters=4,
                                             cg_iters=64))
    np.testing.assert_allclose(sharded[:, 4:], single[:, 4:], atol=2e-3)
    assert len(jax.devices()) >= 8  # conftest fake mesh


def test_sharded_point_to_plane_matches_truth(rng):
    # Known pose; planes sampled from a synthetic box world
    q_true = R.from_rotvec([0.02, -0.01, 0.03]).as_quat()
    t_true = np.array([0.3, -0.2, 0.1])
    n = 4096
    normals = rng.normal(size=(n, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    pts_world = rng.uniform(-20, 20, (n, 3))
    # plane through the world point: n.x + d = 0
    d = -np.sum(normals * pts_world, axis=1)
    # sensor-frame points that should land on the planes under the true pose
    pts_sensor = R.from_quat(q_true).inv().apply(pts_world - t_true)

    mesh = data_mesh()
    x0 = jnp.asarray(np.concatenate([[0, 0, 0, 1], [0, 0, 0]]), jnp.float32)
    x = sharded_point_to_plane_gn(
        mesh,
        shard_batch(jnp.asarray(pts_sensor, jnp.float32), mesh),
        shard_batch(jnp.asarray(normals, jnp.float32), mesh),
        shard_batch(jnp.asarray(d, jnp.float32), mesh),
        shard_batch(jnp.ones(n, jnp.float32), mesh),
        x0, iterations=6,
    )
    x = np.asarray(x)
    np.testing.assert_allclose(x[4:], t_true, atol=1e-2)
    assert abs(np.dot(x[:4], q_true)) > 1 - 1e-4

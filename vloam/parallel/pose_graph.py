"""Distributed pose-graph optimization (loop-consistency backend).

New-scope component named in BASELINE.json ("pose-graph backend for loop
consistency", "map blocks partitioned across hosts"): a batched SE(3)
pose-graph solved by Gauss-Newton with matrix-free conjugate gradient, with
the edge set sharded across a device mesh. Each CG matvec computes local
J^T J v contributions over the device's edge shard and psums — collectives
ride ICI on a real slice; the same code runs on the CPU test mesh.

State: poses [N, 7] (quat xyzw, t). Edges: relative-pose measurements
T_i^-1 T_j with per-edge weights. Gauge is fixed by a strong prior on pose 0.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..geometry import so3

try:
    shard_map = jax.shard_map
except AttributeError:  # older jax
    from jax.experimental.shard_map import shard_map  # type: ignore


class PoseGraph(NamedTuple):
    poses: jnp.ndarray  # [N, 7] (qx,qy,qz,qw, tx,ty,tz)
    edge_i: jnp.ndarray  # [E]
    edge_j: jnp.ndarray  # [E]
    meas: jnp.ndarray  # [E, 7] measured T_i^-1 T_j
    weight: jnp.ndarray  # [E] (0 for padding edges)


def _edge_residual(qi, ti, qj, tj, qm, tm, delta):
    """r(delta) in R^6 for one edge, with local perturbations
    delta = [dth_i, dt_i, dth_j, dt_j] (12)."""
    qi = so3.quat_multiply(qi, so3.quat_from_axis_angle(delta[0:3]))
    ti = ti + delta[3:6]
    qj = so3.quat_multiply(qj, so3.quat_from_axis_angle(delta[6:9]))
    tj = tj + delta[9:12]
    qi_inv = so3.quat_conjugate(qi)
    q_ij = so3.quat_multiply(qi_inv, qj)
    t_ij = so3.quat_rotate(qi_inv, tj - ti)
    r_rot = so3.axis_angle_from_quat(
        so3.quat_multiply(so3.quat_conjugate(qm), q_ij)
    )
    return jnp.concatenate([r_rot, t_ij - tm])


def _edge_terms(poses, edge_i, edge_j, meas, weight):
    """Per-edge residual r [E,6] and Jacobian J [E,6,12] at delta=0."""
    qi, ti = poses[edge_i, :4], poses[edge_i, 4:]
    qj, tj = poses[edge_j, :4], poses[edge_j, 4:]
    qm, tm = meas[:, :4], meas[:, 4:]

    def res0(qi, ti, qj, tj, qm, tm):
        return _edge_residual(qi, ti, qj, tj, qm, tm, jnp.zeros(12, poses.dtype))

    def jac(qi, ti, qj, tj, qm, tm):
        return jax.jacfwd(
            lambda d: _edge_residual(qi, ti, qj, tj, qm, tm, d)
        )(jnp.zeros(12, poses.dtype))

    r = jax.vmap(res0)(qi, ti, qj, tj, qm, tm)
    J = jax.vmap(jac)(qi, ti, qj, tj, qm, tm)
    w = weight[:, None]
    return r * w, J * w[:, :, None]


def _retract_all(poses, delta):
    q = so3.quat_normalize(
        so3.quat_multiply(poses[:, :4], so3.quat_from_axis_angle(delta[:, :3]))
    )
    return jnp.concatenate([q, poses[:, 4:] + delta[:, 3:]], axis=-1)


@partial(jax.jit, static_argnames=("mesh", "axis", "gn_iters", "cg_iters"))
def optimize_pose_graph(
    graph: PoseGraph,
    mesh: Mesh | None = None,
    axis: str = "data",
    gn_iters: int = 8,
    cg_iters: int = 32,
    damping: float = 1e-6,
    gauge_weight: float = 1e6,
):
    """Returns optimized poses [N, 7]. If mesh is given, edges are assumed
    sharded over `axis` (pad edge arrays to a multiple of the axis size and
    set weight=0 on padding)."""
    n = graph.poses.shape[0]

    def gn_body(_, poses):
        def local(poses, edge_i, edge_j, meas, weight):
            r, J = _edge_terms(poses, edge_i, edge_j, meas, weight)

            def matvec(v):
                vi = v[edge_i]
                vj = v[edge_j]
                u = jnp.einsum("erk,ek->er", J,
                               jnp.concatenate([vi, vj], axis=-1), precision="highest")
                out = jnp.zeros_like(v)
                out = out.at[edge_i].add(jnp.einsum("erk,er->ek", J[:, :, :6], u, precision="highest"))
                out = out.at[edge_j].add(jnp.einsum("erk,er->ek", J[:, :, 6:], u, precision="highest"))
                return out

            b = jnp.zeros((n, 6), poses.dtype)
            b = b.at[edge_i].add(-jnp.einsum("erk,er->ek", J[:, :, :6], r, precision="highest"))
            b = b.at[edge_j].add(-jnp.einsum("erk,er->ek", J[:, :, 6:], r, precision="highest"))
            # block-diagonal of J^T J for the Jacobi preconditioner
            Dii = jnp.einsum("erk,erl->ekl", J[:, :, :6], J[:, :, :6], precision="highest")
            Djj = jnp.einsum("erk,erl->ekl", J[:, :, 6:], J[:, :, 6:], precision="highest")
            D = jnp.zeros((n, 6, 6), poses.dtype)
            D = D.at[edge_i].add(Dii).at[edge_j].add(Djj)
            return matvec, b, D

        def full_system(poses, ei, ej, meas, w, inside_shard):
            mv_local, b, D = local(poses, ei, ej, meas, w)

            def A(v):
                y = mv_local(v)
                if inside_shard:
                    y = jax.lax.psum(y, axis)
                y = y + damping * v
                # gauge prior on pose 0
                y = y.at[0].add(gauge_weight * v[0])
                return y

            if inside_shard:
                b = jax.lax.psum(b, axis)
                D = jax.lax.psum(D, axis)
            D = D + damping * jnp.eye(6, dtype=poses.dtype)
            D = D.at[0].add(gauge_weight * jnp.eye(6, dtype=poses.dtype))
            # block-Jacobi preconditioner (6x6 inverses) — without it CG on
            # a chain graph needs O(N) iterations
            Minv = jnp.linalg.inv(D)
            return A, b, Minv

        def pcg_solve(A, b, Minv):
            apply_M = lambda r: jnp.einsum("nkl,nl->nk", Minv, r, precision="highest")
            x = jnp.zeros_like(b)
            r = b - A(x)
            z = apply_M(r)
            p = z
            rz = jnp.sum(r * z)

            def body(_, st):
                x, r, p, rz = st
                Ap = A(p)
                alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-20)
                x = x + alpha * p
                r = r - alpha * Ap
                z = apply_M(r)
                rz_new = jnp.sum(r * z)
                beta = rz_new / jnp.maximum(rz, 1e-20)
                p = z + beta * p
                return x, r, p, rz_new

            x, *_ = jax.lax.fori_loop(0, cg_iters, body, (x, r, p, rz))
            return x

        if mesh is None:
            A, b, Minv = full_system(poses, graph.edge_i, graph.edge_j,
                                     graph.meas, graph.weight, False)
            delta = pcg_solve(A, b, Minv)
        else:
            @partial(shard_map, mesh=mesh,
                     in_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
                     out_specs=P())
            def sharded_delta(poses, ei, ej, meas, w):
                A, b, Minv = full_system(poses, ei, ej, meas, w, True)
                return pcg_solve(A, b, Minv)

            delta = sharded_delta(poses, graph.edge_i, graph.edge_j,
                                  graph.meas, graph.weight)
        return _retract_all(poses, delta)

    return jax.lax.fori_loop(0, gn_iters, gn_body, graph.poses)


def build_odometry_graph(poses_qt: np.ndarray, loop_pairs=None,
                         odo_weight: float = 1.0, loop_weight: float = 1.0,
                         meas_fn=None) -> PoseGraph:
    """Helper: consecutive-frame edges (+ optional loop closures) from an
    initial trajectory. meas_fn(i, j) can supply measured relative poses
    (defaults to the relative pose of the given trajectory)."""
    from scipy.spatial.transform import Rotation as R

    n = len(poses_qt)
    pairs = [(i, i + 1) for i in range(n - 1)]
    weights = [odo_weight] * len(pairs)
    if loop_pairs:
        pairs += list(loop_pairs)
        weights += [loop_weight] * len(loop_pairs)

    def rel(i, j):
        qi = R.from_quat(poses_qt[i, :4])
        qj = R.from_quat(poses_qt[j, :4])
        q = (qi.inv() * qj).as_quat()
        t = qi.inv().apply(poses_qt[j, 4:] - poses_qt[i, 4:])
        return np.concatenate([q, t])

    meas = np.stack([
        rel(i, j) if meas_fn is None else meas_fn(i, j) for i, j in pairs
    ])
    ei = np.asarray([p[0] for p in pairs], np.int32)
    ej = np.asarray([p[1] for p in pairs], np.int32)
    return PoseGraph(
        poses=jnp.asarray(poses_qt, jnp.float32),
        edge_i=jnp.asarray(ei),
        edge_j=jnp.asarray(ej),
        meas=jnp.asarray(meas, jnp.float32),
        weight=jnp.asarray(weights, jnp.float32),
    )

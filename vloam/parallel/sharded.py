"""Multi-device scaling: sharded Gauss-Newton normal equations.

The reference is single-process (SURVEY.md §2: no DP/TP/PP, ROS pub/sub
only); this module is the new-scope multi-device scaling path named in
BASELINE.json: residual blocks are sharded across a jax.sharding.Mesh, each
device reduces its local J^T W J / J^T W r, and one psum yields the global
6-dof (or 6N-dof) normal equations — the Schur-style reduction for
scan-to-map alignment where the point sets dwarf the state.

Works identically on a real multi-GPU mesh (collectives ride NVLink) and on
the xla_force_host_platform_device_count CPU mesh used in tests/dryrun.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import so3
from ..solver.lm import huber_cost, huber_weight, solve_damped


def data_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis,))


def shard_batch(arr: jnp.ndarray, mesh: Mesh, axis: str = "data"):
    """Place a batch-leading array sharded over the mesh axis (pads to a
    multiple of the axis size)."""
    n = arr.shape[0]
    size = mesh.shape[axis]
    pad = (-n) % size
    if pad:
        arr = jnp.concatenate([arr, jnp.zeros((pad,) + arr.shape[1:], arr.dtype)])
    return jax.device_put(arr, NamedSharding(mesh, P(axis)))


def sharded_point_to_plane_gn(
    mesh: Mesh,
    pts: jnp.ndarray,  # [B, 3] sensor-frame points, sharded on axis 0
    n_hat: jnp.ndarray,  # [B, 3] plane normals (world)
    d: jnp.ndarray,  # [B] plane offsets: residual = n.(Rp+t) + d
    w_mask: jnp.ndarray,  # [B] weights/validity
    x0: jnp.ndarray,  # [7] (quat, t)
    iterations: int = 4,
    huber_delta: float = 0.1,
    axis: str = "data",
):
    """Distributed GN on a replicated 6-dof pose with sharded residuals.
    Demonstrates the psum reduction; the single-device mapping stage uses the
    same math via solver.lm."""

    def local_terms(x, pts, n_hat, d, w_mask):
        def res_fn(delta):
            q = so3.quat_multiply(x[:4], so3.quat_from_axis_angle(delta[:3]))
            t = x[4:] + delta[3:]
            pw = so3.quat_rotate(q, pts) + t
            return (jnp.sum(pw * n_hat, axis=-1) + d)[:, None]

        r = res_fn(jnp.zeros(6, x.dtype))
        J = jax.jacfwd(res_fn)(jnp.zeros(6, x.dtype))
        sq = jnp.sum(r * r, axis=-1)
        w = huber_weight(sq, huber_delta) * w_mask
        H = jnp.einsum("bri,brj->ij", J * w[:, None, None], J, precision="highest")
        g = jnp.einsum("bri,br->i", J, r * w[:, None], precision="highest")
        cost = jnp.sum(huber_cost(sq, huber_delta) * w_mask)
        return H, g, cost

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(),
    )
    def step(x, pts, n_hat, d, w_mask):
        def body(_, x):
            H, g, _ = local_terms(x, pts, n_hat, d, w_mask)
            H = jax.lax.psum(H, axis)
            g = jax.lax.psum(g, axis)
            delta = solve_damped(H, g, jnp.float32(1e-4))
            q = so3.quat_normalize(
                so3.quat_multiply(x[:4], so3.quat_from_axis_angle(-delta[:3]))
            )
            return jnp.concatenate([q, x[4:] - delta[3:]])

        return jax.lax.fori_loop(0, iterations, body, x)

    return step(x0, pts, n_hat, d, w_mask)

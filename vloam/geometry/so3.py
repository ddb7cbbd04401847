"""SO(3) primitives on quaternions, vectorization-first.

Quaternions are stored ``[x, y, z, w]`` (Eigen/tf2 memory order, matching the
reference's ``para_q`` layout, cf. reference src/lidar_odometry_mapping/
src/laser_odometry.cpp:95-101).  All functions broadcast over leading batch
dimensions and are differentiable, so the nonlinear solvers can push
``jax.jacfwd`` through them.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def identity_quat(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.array([0.0, 0.0, 0.0, 1.0], dtype=dtype)


def quat_normalize(q: jnp.ndarray) -> jnp.ndarray:
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)


def quat_multiply(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product a ⊗ b with [x,y,z,w] storage."""
    ax, ay, az, aw = jnp.moveaxis(a, -1, 0)
    bx, by, bz, bw = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def quat_conjugate(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.asarray([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors v by unit quaternion q: v' = v + 2 w (u×v) + 2 u×(u×v)."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_from_axis_angle(axis_angle: jnp.ndarray) -> jnp.ndarray:
    """Exponential map R^3 -> quaternion, Taylor-safe near zero."""
    theta2 = jnp.sum(axis_angle * axis_angle, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    half = 0.5 * theta
    # sin(x/2)/x with series fallback: 0.5 - theta^2/48 for tiny angles.
    small = theta2 < 1e-8
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    w = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return jnp.concatenate([axis_angle * k, w], axis=-1)


def axis_angle_from_quat(q: jnp.ndarray) -> jnp.ndarray:
    """Log map quaternion -> R^3 rotation vector."""
    q = jnp.where(q[..., 3:4] < 0, -q, q)  # shortest arc
    u = q[..., :3]
    w = jnp.clip(q[..., 3], -1.0, 1.0)
    norm_u = jnp.linalg.norm(u, axis=-1)
    theta = 2.0 * jnp.arctan2(norm_u, w)
    small = norm_u < 1e-8
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 0.5), theta / jnp.maximum(norm_u, _EPS))
    return u * scale[..., None]


def rotate_axis_angle(axis_angle: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues rotation of v by rotation vector (Ceres AngleAxisRotatePoint
    semantics, cf. reference ceres_cost_function.h:30).  Differentiable at 0."""
    theta2 = jnp.sum(axis_angle * axis_angle, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    small = theta2 < 1e-8
    s = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    c1 = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    wxv = jnp.cross(axis_angle, v)
    wxwxv = jnp.cross(axis_angle, wxv)
    return v + s * wxv + c1 * wxwxv


def quat_slerp_identity(q: jnp.ndarray, s) -> jnp.ndarray:
    """slerp(I, q, s) — the de-skew interpolation used by the lidar factors
    (reference lidarFactor.hpp:29-31).  Implemented as exp(s * log(q))."""
    return quat_from_axis_angle(s * axis_angle_from_quat(q))


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    x, y, z, w = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_matrix(m: jnp.ndarray) -> jnp.ndarray:
    """Branchless Shepperd-style conversion (safe under vmap/jit)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate quaternions (unnormalised), one per dominant component
    qw = jnp.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], axis=-1)
    qx = jnp.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], axis=-1)
    qy = jnp.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], axis=-1)
    qz = jnp.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], axis=-1)
    scores = jnp.stack([m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11, tr], axis=-1)
    best = jnp.argmax(scores, axis=-1)
    cands = jnp.stack([qx, qy, qz, qw], axis=-2)  # [..., 4, 4]
    q = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    return quat_normalize(q)

"""SE(3) rigid transforms as (quat, t) pytrees.

Replaces the reference's tf2::Transform / Eigen Isometry algebra
(reference src/vloam_tf/src/vloam_tf.cpp) with a functional,
batchable representation usable inside jit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from . import so3


class Pose(NamedTuple):
    """Rigid transform: x_parent = R(q) @ x_child + t.  Batch dims allowed."""

    q: jnp.ndarray  # [..., 4]  (x, y, z, w)
    t: jnp.ndarray  # [..., 3]

    @staticmethod
    def identity(dtype=jnp.float32, batch=()) -> "Pose":
        q = jnp.broadcast_to(so3.identity_quat(dtype), batch + (4,))
        t = jnp.zeros(batch + (3,), dtype)
        return Pose(q, t)

    def compose(self, other: "Pose") -> "Pose":
        """self ∘ other (apply other first)."""
        return Pose(
            so3.quat_normalize(so3.quat_multiply(self.q, other.q)),
            so3.quat_rotate(self.q, other.t) + self.t,
        )

    def inverse(self) -> "Pose":
        qinv = so3.quat_conjugate(self.q)
        return Pose(qinv, -so3.quat_rotate(qinv, self.t))

    def apply(self, pts: jnp.ndarray) -> jnp.ndarray:
        return so3.quat_rotate(self.q[..., None, :] if pts.ndim > self.q.ndim else self.q, pts) + (
            self.t[..., None, :] if pts.ndim > self.t.ndim else self.t
        )

    def matrix(self) -> jnp.ndarray:
        """[..., 4, 4] homogeneous matrix."""
        R = so3.quat_to_matrix(self.q)
        top = jnp.concatenate([R, self.t[..., :, None]], axis=-1)
        bottom = jnp.broadcast_to(
            jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=top.dtype), top.shape[:-2] + (1, 4)
        )
        return jnp.concatenate([top, bottom], axis=-2)

    def matrix34(self) -> jnp.ndarray:
        R = so3.quat_to_matrix(self.q)
        return jnp.concatenate([R, self.t[..., :, None]], axis=-1)

    @staticmethod
    def from_matrix(m) -> "Pose":
        m = jnp.asarray(m)
        return Pose(so3.quat_from_matrix(m[..., :3, :3]), m[..., :3, 3])

    @staticmethod
    def from_axis_angle(axis_angle, t) -> "Pose":
        return Pose(so3.quat_from_axis_angle(jnp.asarray(axis_angle)), jnp.asarray(t))

    def as_float64(self) -> "Pose":
        return Pose(np.asarray(self.q, np.float64), np.asarray(self.t, np.float64))


def pose_from_np_matrix(m: np.ndarray) -> Pose:
    """Host-side (numpy, float64) construction for accumulators."""
    import numpy as _np

    q = _np.asarray(so3.quat_from_matrix(jnp.asarray(m[:3, :3], dtype=jnp.float64)))
    return Pose(q, _np.asarray(m[:3, 3], _np.float64))

"""Closed-form batched symmetric 3x3 eigendecomposition.

Fixed-shape replacement for Eigen::SelfAdjointEigenSolver on the per-corner
covariance matrices in the mapping stage (reference laser_mapping.cpp:
493-516): the trigonometric (Smith) eigenvalue formula plus a cross-product
eigenvector recovery, fully branchless and vmappable — no LAPACK, no
iteration.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def eigvals_sym3(A: jnp.ndarray) -> jnp.ndarray:
    """Eigenvalues of symmetric [..., 3, 3], ascending [l0 <= l1 <= l2]."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (
        a01 * a01 + a02 * a02 + a12 * a12
    )
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, _EPS))
    # det(B)/2 with B = (A - qI)/p
    c00 = b11 * b22 - a12 * a12
    c01 = a01 * b22 - a12 * a02
    c02 = a01 * a12 - b11 * a02
    det_b = b00 * c00 - a01 * c01 + a02 * c02
    r = det_b / (2.0 * p * p * p)
    r = jnp.clip(r, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    l2 = q + 2.0 * p * jnp.cos(phi)
    l0 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    l1 = 3.0 * q - l0 - l2
    return jnp.stack([l0, l1, l2], axis=-1)


def principal_eigenvector(A: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of symmetric [..., 3, 3] for eigenvalue lam [...]:
    the kernel of (A - lam I), found as the largest cross product of its rows
    (rows of a rank-2 matrix span the orthogonal complement of the kernel)."""
    B = A - lam[..., None, None] * jnp.eye(3, dtype=A.dtype)
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c12 = jnp.cross(r1, r2)
    c20 = jnp.cross(r2, r0)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    n20 = jnp.sum(c20 * c20, axis=-1)
    cands = jnp.stack([c01, c12, c20], axis=-2)
    best = jnp.argmax(jnp.stack([n01, n12, n20], axis=-1), axis=-1)
    v = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    norm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    # Degenerate (isotropic) case: fall back to e_x; callers gate on the
    # eigenvalue ratio anyway.
    fallback = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], A.dtype), v.shape)
    return jnp.where(norm > 1e-9, v / jnp.maximum(norm, _EPS), fallback)

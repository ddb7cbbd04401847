"""Essential-matrix RANSAC (the reference's alternative VO solver,
visual_odometry.cpp solveRANSAC :188-252: cv::findEssentialMat +
cv::recoverPose; diagnostic in the reference, fully usable here).

Batched design: instead of a sequential hypothesize-and-verify loop, ALL
hypotheses run batched — H x (8-point SVD) followed by an H x M Sampson
error matrix (a matmul over the 9-vector lifting), then one argmax.
Pose recovery decomposes the winning E and resolves the fourfold ambiguity
by batched midpoint triangulation cheirality voting.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import so3


def _lift9(x0, x1):
    """Kronecker lifting: rows a s.t. a . vec(E) = x1^T E x0 = 0.
    x0, x1: [..., 2] normalized image coords."""
    u0, v0 = x0[..., 0], x0[..., 1]
    u1, v1 = x1[..., 0], x1[..., 1]
    one = jnp.ones_like(u0)
    return jnp.stack(
        [u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0, one], axis=-1
    )


def _essential_from_8(x0, x1):
    """[H, 8, 2] -> [H, 3, 3] essential candidates via batched SVD."""
    A = _lift9(x0, x1)  # [H, 8, 9]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    e = vt[:, -1, :]
    E = e.reshape(-1, 3, 3)
    # project to the essential manifold: singular values (1, 1, 0)
    u, s, vt2 = jnp.linalg.svd(E)
    d = jnp.zeros_like(E).at[:, 0, 0].set(1.0).at[:, 1, 1].set(1.0)
    return jnp.matmul(jnp.matmul(u, d, precision="highest"), vt2,
                      precision="highest")


def _sampson_sq(E, x0, x1):
    """Squared Sampson distance. E [H,3,3], x: [M,2] -> [H, M]."""
    h0 = jnp.concatenate([x0, jnp.ones_like(x0[:, :1])], axis=1)  # [M,3]
    h1 = jnp.concatenate([x1, jnp.ones_like(x1[:, :1])], axis=1)
    Ex0 = jnp.einsum("hij,mj->hmi", E, h0, precision="highest")
    Etx1 = jnp.einsum("hji,mj->hmi", E, h1, precision="highest")
    num = jnp.einsum("mi,hmi->hm", h1, Ex0, precision="highest") ** 2
    den = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    return num / jnp.maximum(den, 1e-12)


def _triangulate_depths(R, t, x0, x1):
    """Midpoint depths for cheirality: returns (z0, z1) [M]."""
    f0 = jnp.concatenate([x0, jnp.ones_like(x0[:, :1])], axis=1)
    f1 = jnp.concatenate([x1, jnp.ones_like(x1[:, :1])], axis=1)
    Rf0 = jnp.matmul(f0, R.T, precision="highest")  # frame-0 bearings in frame 1
    # z0 * R f0 + t = z1 * f1  -> solve per point in LS
    a = jnp.sum(Rf0 * Rf0, axis=1)
    b = -jnp.sum(Rf0 * f1, axis=1)
    c = jnp.sum(f1 * f1, axis=1)
    tb0 = jnp.sum(Rf0 * t, axis=1)
    tb1 = jnp.sum(f1 * t, axis=1)
    det = a * c - b * b
    z0 = (-c * tb0 - b * tb1) / jnp.maximum(det, 1e-12)
    z1 = (b * tb0 + a * tb1) / jnp.maximum(det, 1e-12)
    return z0, z1


@partial(jax.jit, static_argnames=("n_hyp",))
def estimate_essential_ransac(
    x0_bar: jnp.ndarray,  # [M, 2] normalized coords frame 0
    x1_bar: jnp.ndarray,  # [M, 2] frame 1
    valid: jnp.ndarray,  # [M]
    key: jax.Array,
    n_hyp: int = 256,
    thresh: float = 1e-5,
):
    """Returns (q [4], t_unit [3], inlier_mask [M], n_inliers): the relative
    pose with R, t s.t. x1 ~ R x0 + t (translation up to scale)."""
    m = x0_bar.shape[0]
    w = valid.astype(jnp.float32)
    p = w / jnp.maximum(jnp.sum(w), 1.0)
    idx = jax.random.choice(key, m, shape=(n_hyp, 8), p=p)
    E = _essential_from_8(x0_bar[idx], x1_bar[idx])
    err = _sampson_sq(E, x0_bar, x1_bar)  # [H, M]
    inl = (err < thresh) & valid[None, :]
    scores = jnp.sum(inl.astype(jnp.int32), axis=1)
    best = jnp.argmax(scores)
    E_best = E[best]
    inlier_mask = inl[best]

    # decompose: four (R, t) candidates
    u, s, vt = jnp.linalg.svd(E_best)
    # enforce proper rotations
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))[..., None]
    W = jnp.asarray([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], E_best.dtype)
    R1 = jnp.matmul(jnp.matmul(u, W, precision="highest"), vt,
                    precision="highest")
    R2 = jnp.matmul(jnp.matmul(u, W.T, precision="highest"), vt,
                    precision="highest")
    tt = u[:, 2]
    cands = [(R1, tt), (R1, -tt), (R2, tt), (R2, -tt)]
    votes = []
    for R, t in cands:
        z0, z1 = _triangulate_depths(R, t, x0_bar, x1_bar)
        votes.append(jnp.sum(((z0 > 0) & (z1 > 0) & inlier_mask)))
    votes = jnp.stack(votes)
    kbest = jnp.argmax(votes)
    Rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    R_best, t_best = Rs[kbest], ts[kbest]
    q = so3.quat_from_matrix(R_best)
    return q, t_best, inlier_mask, scores[best]

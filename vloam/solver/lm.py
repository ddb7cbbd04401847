"""Batched Huber-IRLS Levenberg-Marquardt on small states.

Replaces Ceres (AutoDiffCostFunction + HuberLoss + EigenQuaternion
parameterization + DENSE_QR, reference laser_odometry.cpp:457-463,
laser_mapping.cpp:609-617, visual_odometry.cpp:67-71,258) with a JAX-native
design:

- residual families are batched functions of a local perturbation delta in
  R^d evaluated at 0; jacfwd gives the full [B, R, d] Jacobian in d forward
  passes (the JAX analogue of Ceres auto-diff),
- the Huber loss enters as per-block IRLS weights w = rho'(||r||^2),
- the normal equations are Jacobi-preconditioned and solved in f32 by
  Cholesky (the state is 6-dof; conditioning is handled by the D^-1/2 scaling
  rather than f64),
- the LM loop is a lax.fori_loop with accept/reject damping updates, fully
  branchless.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import jax
import jax.numpy as jnp


def huber_weight(sq_norm: jnp.ndarray, delta: float) -> jnp.ndarray:
    """IRLS weight rho'(s) for Ceres HuberLoss(delta): rho(s) = s for
    s <= delta^2 else 2 delta sqrt(s) - delta^2."""
    d2 = delta * delta
    safe = jnp.maximum(sq_norm, 1e-20)
    return jnp.where(sq_norm <= d2, 1.0, delta / jnp.sqrt(safe))


def huber_cost(sq_norm: jnp.ndarray, delta: float) -> jnp.ndarray:
    d2 = delta * delta
    safe = jnp.maximum(sq_norm, 1e-20)
    return jnp.where(sq_norm <= d2, sq_norm, 2.0 * delta * jnp.sqrt(safe) - d2)


class ResidualFamily(NamedTuple):
    """A batch of residual blocks of equal shape.

    fn: delta [d] -> residuals [B, R] (must be differentiable; masked rows
        should still produce finite values)
    mask: [B] validity of each block
    """

    fn: Callable[[jnp.ndarray], jnp.ndarray]
    mask: jnp.ndarray


def normal_equations(
    families: Sequence[ResidualFamily], dim: int, huber_delta: float
):
    """Accumulate H [d,d], g [d], cost over all families at delta = 0."""
    H = jnp.zeros((dim, dim), jnp.float32)
    g = jnp.zeros((dim,), jnp.float32)
    cost = jnp.float32(0.0)
    zero = jnp.zeros((dim,), jnp.float32)
    for fam in families:
        r = fam.fn(zero)  # [B, R]
        J = jax.jacfwd(fam.fn)(zero)  # [B, R, d]
        sq = jnp.sum(r * r, axis=-1)
        w = huber_weight(sq, huber_delta) * fam.mask
        H = H + jnp.einsum("bri,brj->ij", J * w[:, None, None], J, precision="highest")
        g = g + jnp.einsum("bri,br->i", J, r * w[:, None], precision="highest")
        cost = cost + jnp.sum(huber_cost(sq, huber_delta) * fam.mask)
    return H, g, cost


def family_cost(families: Sequence[ResidualFamily], dim: int, huber_delta: float):
    zero = jnp.zeros((dim,), jnp.float32)
    cost = jnp.float32(0.0)
    for fam in families:
        r = fam.fn(zero)
        sq = jnp.sum(r * r, axis=-1)
        cost = cost + jnp.sum(huber_cost(sq, huber_delta) * fam.mask)
    return cost


def _cholesky_solve_unrolled(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b for small SPD A by fully unrolled scalar Cholesky.

    jnp.linalg.cholesky + two solve_triangular calls lower to THREE separate
    device kernels, each paying launch latency, and the LM loop runs 16+ of
    these chains per frame.
    Unrolling the d<=8 factorization into scalar ops lets XLA fuse the whole
    solve into the surrounding elementwise work (zero extra kernels)."""
    d = A.shape[0]
    L = [[None] * d for _ in range(d)]
    for j in range(d):
        s = A[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, d):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * d
    for i in range(d):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * d
    for i in reversed(range(d)):
        s = y[i]
        for k in range(i + 1, d):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def solve_damped(H: jnp.ndarray, g: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Jacobi-preconditioned damped solve: (H + lam*diag(H)) x = g."""
    d = jnp.sqrt(jnp.clip(jnp.diag(H), 1e-12, None))
    Hs = H / (d[:, None] * d[None, :])
    Hs = Hs + (lam + 1e-8) * jnp.eye(H.shape[0], dtype=H.dtype)
    gs = g / d
    if H.shape[0] <= 8:
        x = _cholesky_solve_unrolled(Hs, gs)
    else:
        L = jnp.linalg.cholesky(Hs)
        y = jax.scipy.linalg.solve_triangular(L, gs, lower=True)
        x = jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
    return x / d


def lm_solve(
    make_families: Callable[[jnp.ndarray], Sequence[ResidualFamily]],
    retract: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    x0: jnp.ndarray,
    dim: int,
    iterations: int,
    huber_delta: float,
    init_lambda: float = 1e-4,
) -> jnp.ndarray:
    """Run `iterations` LM steps. `make_families(x)` builds residual families
    whose fn is parameterized by the local delta around x; `retract(x, delta)`
    applies the local step. x is any flat array state.

    One normal-equations evaluation per iteration: (H, g, cost) are computed
    at the TRIAL point and carried — an accepted step's NE are reused as the
    next iteration's linearization, a rejected step keeps the carried ones.
    This follows the identical accept/reject trajectory as evaluating NE at
    the current point plus a separate trial-cost pass (the quantities agree
    value-for-value), but runs one residual/Jacobian pass per iteration
    instead of two — the LM loop is a serialized latency chain of small
    kernels on this hardware, so eval count is wall-clock."""

    H0, g0, cost0 = normal_equations(make_families(x0), dim, huber_delta)

    def body(_, carry):
        x, H, g, cost, lam = carry
        delta = solve_damped(H, g, lam)
        x_try = retract(x, -delta)
        H_t, g_t, cost_t = normal_equations(make_families(x_try), dim,
                                            huber_delta)
        accept = cost_t < cost
        x_new = jnp.where(accept, x_try, x)
        H_new = jnp.where(accept, H_t, H)
        g_new = jnp.where(accept, g_t, g)
        cost_new = jnp.where(accept, cost_t, cost)
        lam_new = jnp.where(accept, jnp.maximum(lam * 0.33, 1e-7),
                            jnp.minimum(lam * 8.0, 1e2))
        return x_new, H_new, g_new, cost_new, lam_new

    x, _, _, _, _ = jax.lax.fori_loop(
        0, iterations, body, (x0, H0, g0, cost0, jnp.float32(init_lambda)))
    return x

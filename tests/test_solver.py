import numpy as np
import jax
import jax.numpy as jnp

from vloam.solver import lm
from vloam.solver.eig3 import eigvals_sym3, principal_eigenvector
from vloam.lidar.knn import masked_knn, nearest_and_ring_constrained


def test_huber_weight_cost():
    s = jnp.asarray([0.0025, 0.01, 1.0])  # delta = 0.1 -> d2 = 0.01
    w = np.asarray(lm.huber_weight(s, 0.1))
    np.testing.assert_allclose(w, [1.0, 1.0, 0.1], atol=1e-6)
    c = np.asarray(lm.huber_cost(s, 0.1))
    np.testing.assert_allclose(c, [0.0025, 0.01, 2 * 0.1 * 1.0 - 0.01], atol=1e-6)


def test_lm_converges_point_cloud_alignment(rng):
    """Recover a known rigid transform from noiseless 3D-3D pairs."""
    from vloam.geometry import so3

    src = jnp.asarray(rng.uniform(-10, 10, (200, 3)), jnp.float32)
    q_true = so3.quat_from_axis_angle(jnp.asarray([0.03, -0.05, 0.1]))
    t_true = jnp.asarray([0.5, -0.2, 0.1])
    dst = so3.quat_rotate(q_true, src) + t_true

    def retract(x, d):
        q = so3.quat_normalize(so3.quat_multiply(x[:4], so3.quat_from_axis_angle(d[:3])))
        return jnp.concatenate([q, x[4:] + d[3:]])

    def make_families(x):
        def fn(delta):
            q = so3.quat_multiply(x[:4], so3.quat_from_axis_angle(delta[:3]))
            t = x[4:] + delta[3:]
            return so3.quat_rotate(q, src) + t - dst

        return [lm.ResidualFamily(fn, jnp.ones(src.shape[0]))]

    x0 = jnp.asarray([0, 0, 0, 1, 0, 0, 0], jnp.float32)
    x = lm.lm_solve(make_families, retract, x0, 6, iterations=8, huber_delta=1.0)
    np.testing.assert_allclose(np.asarray(x[4:]), np.asarray(t_true), atol=1e-3)
    dq = np.abs(np.dot(np.asarray(x[:4]), np.asarray(q_true)))
    assert dq > 1 - 1e-6


def test_normal_equations_match_finite_diff(rng):
    src = jnp.asarray(rng.normal(size=(16, 3)), jnp.float32)
    dst = jnp.asarray(rng.normal(size=(16, 3)), jnp.float32)

    def fn(delta):
        from vloam.geometry import so3

        return so3.rotate_axis_angle(jnp.broadcast_to(delta[:3], (16, 3)), src) + delta[3:] - dst

    fam = lm.ResidualFamily(fn, jnp.ones(16))
    H, g, cost = lm.normal_equations([fam], 6, huber_delta=1e9)
    # finite-difference J
    eps = 1e-4
    J_fd = np.zeros((16, 3, 6))
    r0 = np.asarray(fn(jnp.zeros(6)))
    for i in range(6):
        e = np.zeros(6); e[i] = eps
        J_fd[:, :, i] = (np.asarray(fn(jnp.asarray(e, jnp.float32))) - r0) / eps
    H_fd = np.einsum("bri,brj->ij", J_fd, J_fd)
    g_fd = np.einsum("bri,br->i", J_fd, r0)
    np.testing.assert_allclose(np.asarray(H), H_fd, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np.asarray(g), g_fd, rtol=2e-2, atol=2e-2)


def test_eig3_matches_numpy(rng):
    A = rng.normal(size=(64, 3, 3))
    A = (A + np.transpose(A, (0, 2, 1))) / 2
    got = np.asarray(eigvals_sym3(jnp.asarray(A)))
    want = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(got, want, atol=1e-4)
    v = np.asarray(principal_eigenvector(jnp.asarray(A), jnp.asarray(want[:, 2])))
    _, vecs = np.linalg.eigh(A)
    dot = np.abs(np.sum(v * vecs[:, :, 2], axis=-1))
    np.testing.assert_allclose(dot, 1.0, atol=1e-3)


def test_masked_knn_matches_bruteforce(rng):
    q = jnp.asarray(rng.normal(size=(100, 3)), jnp.float32)
    c = jnp.asarray(rng.normal(size=(5000, 3)), jnp.float32)
    mask = jnp.asarray(rng.uniform(size=5000) > 0.3)
    d, i = masked_knn(q, c, mask, k=5, q_tile=64, c_tile=512)
    d, i = np.asarray(d), np.asarray(i)
    D = np.sum((np.asarray(q)[:, None] - np.asarray(c)[None]) ** 2, axis=-1)
    D[:, ~np.asarray(mask)] = np.inf
    want_i = np.argsort(D, axis=1)[:, :5]
    want_d = np.take_along_axis(D, want_i, axis=1)
    np.testing.assert_allclose(d, want_d, rtol=1e-4, atol=1e-4)
    # indices can differ on ties; distances must match
    got_d_direct = np.take_along_axis(D, i, axis=1)
    np.testing.assert_allclose(got_d_direct, want_d, rtol=1e-4, atol=1e-4)


def test_ring_constrained_search(rng):
    q = jnp.asarray(rng.normal(size=(50, 3)) * 5, jnp.float32)
    c = jnp.asarray(rng.normal(size=(2000, 3)) * 5, jnp.float32)
    ring = jnp.asarray(rng.integers(0, 16, size=2000), jnp.int32)
    mask = jnp.ones(2000, bool)
    res = nearest_and_ring_constrained(q, c, ring, mask, 2.5, mode="surf", c_tile=256)
    D = np.sum((np.asarray(q)[:, None] - np.asarray(c)[None]) ** 2, axis=-1)
    i0 = np.argmin(D, axis=1)
    np.testing.assert_allclose(np.asarray(res["d0"]), D[np.arange(50), i0], rtol=1e-4)
    r0 = np.asarray(ring)[i0]
    rr = np.asarray(ring)
    for k in range(50):
        m_other = (rr != r0[k]) & (np.abs(rr - r0[k]) <= 2.5)
        want2 = np.min(np.where(m_other, D[k], np.inf))
        np.testing.assert_allclose(float(res["d2"][k]), want2, rtol=1e-4)
        m_same = (rr == r0[k]) & (np.arange(2000) != i0[k])
        want3 = np.min(np.where(m_same, D[k], np.inf))
        np.testing.assert_allclose(float(res["d3"][k]), want3, rtol=1e-4)

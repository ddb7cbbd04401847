import numpy as np
import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation as R

from vloam.vision.ransac import estimate_essential_ransac


def test_ransac_essential_recovers_pose(rng):
    n = 400
    X0 = rng.uniform([-10, -4, 4], [10, 4, 50], (n, 3))
    R_true = R.from_rotvec([0.02, -0.04, 0.01])
    t_true = np.array([0.2, -0.1, 1.0])
    X1 = R_true.apply(X0) + t_true
    x0 = X0[:, :2] / X0[:, 2:3]
    x1 = X1[:, :2] / X1[:, 2:3]
    # 20% outliers
    n_out = n // 5
    x1[:n_out] = rng.uniform(-0.5, 0.5, (n_out, 2))
    q, t, inl, score = estimate_essential_ransac(
        jnp.asarray(x0, jnp.float32), jnp.asarray(x1, jnp.float32),
        jnp.ones(n, bool), jax.random.PRNGKey(0), n_hyp=256, thresh=1e-6)
    q, t = np.asarray(q, np.float64), np.asarray(t, np.float64)
    # rotation accuracy
    rot_err = (R.from_quat(q / np.linalg.norm(q)).inv() * R_true).magnitude()
    assert rot_err < 5e-3, rot_err
    # translation direction (up to scale)
    cos = abs(np.dot(t, t_true) / np.linalg.norm(t_true))
    assert cos > 0.99, cos
    assert int(score) > 0.6 * (n - n_out)
    # most inliers are the uncorrupted points
    inl = np.asarray(inl)
    assert inl[n_out:].mean() > 0.8
    assert inl[:n_out].mean() < 0.2


def test_checkpoint_roundtrip(tmp_path):
    from vloam.config import kitti_hdl64
    from vloam.lidar.loam_step import LoamState
    from vloam.runtime.checkpoint import load_state, save_state
    from vloam.config import tiny_test_profile

    cfg = tiny_test_profile()
    st = LoamState.create(cfg)
    st = st._replace(t_w=jnp.asarray([1.0, 2.0, 3.0]),
                     frame_idx=jnp.int32(7))
    st = st._replace(cube=st.cube._replace(
        corner=st.cube.corner._replace(
            n_live=jnp.int32(11))))
    p = str(tmp_path / "state.npz")
    save_state(p, st)
    st2 = load_state(p, LoamState.create(cfg))
    np.testing.assert_allclose(np.asarray(st2.t_w), [1, 2, 3])
    assert int(st2.frame_idx) == 7
    assert int(st2.cube.corner.n_live) == 11
    # structural mismatch is rejected
    import pytest

    bad_cfg = tiny_test_profile()
    from dataclasses import replace

    bad = replace(bad_cfg, mapping=replace(bad_cfg.mapping, map_n_buckets=1 << 10))
    with pytest.raises((KeyError, ValueError)):
        load_state(p, LoamState.create(bad))

"""Vectorized host pose recomposition (geometry/np_pose.py) vs the
sequential scipy reference, plus the LO degradation warning
(reference laser_odometry.cpp:452-455)."""

import logging

import numpy as np
from scipy.spatial.transform import Rotation as R

from vloam.geometry.np_pose import (cumulative_se3, inv_T, mat_cumprod,
                                        qt_to_T, quats_to_mats)


def _rand_qt(rng, n):
    q = R.random(n, random_state=rng).as_quat()
    t = rng.normal(0, 1.0, (n, 3))
    return q, t


def test_cumulative_se3_matches_sequential():
    rng = np.random.default_rng(0)
    n = 257  # odd, exercises the doubling tail
    q, t = _rand_qt(rng, n)
    qw, tw = cumulative_se3(q, t)
    q_acc = R.identity()
    t_acc = np.zeros(3)
    for k in range(n):
        t_acc = t_acc + q_acc.apply(t[k])
        q_acc = q_acc * R.from_quat(q[k])
        np.testing.assert_allclose(tw[k], t_acc, atol=1e-9)
        dq = (q_acc.inv() * R.from_quat(qw[k])).magnitude()
        assert dq < 1e-9


def test_mat_cumprod_and_qt_to_T():
    rng = np.random.default_rng(1)
    n = 33
    q, t = _rand_qt(rng, n)
    Ts = qt_to_T(q, t)
    np.testing.assert_allclose(Ts[0][:3, :3], R.from_quat(q[0]).as_matrix(),
                               atol=1e-12)
    P = mat_cumprod(Ts)
    want = np.eye(4)
    for k in range(n):
        want = want @ Ts[k]
        np.testing.assert_allclose(P[k], want, atol=1e-9)
    np.testing.assert_allclose(
        np.einsum("nij,njk->nik", inv_T(Ts), Ts),
        np.broadcast_to(np.eye(4), (n, 4, 4)), atol=1e-12)


def test_quats_to_mats_handles_unnormalized():
    rng = np.random.default_rng(2)
    q = R.random(8, random_state=rng).as_quat() * 2.5
    np.testing.assert_allclose(quats_to_mats(q),
                               R.from_quat(q).as_matrix(), atol=1e-12)


def test_unpack_outputs_vectorized_matches_loop_and_warns(caplog):
    """unpack_outputs recomposition == sequential scipy loop; degenerate
    frames (< 10 correspondences) trigger the 'less correspondence!'
    warning and are listed in lo_degraded."""
    from vloam.lidar.loam_step import OUT_DIM, unpack_outputs

    rng = np.random.default_rng(3)
    n = 50
    outs = np.zeros((n, OUT_DIM), np.float32)
    q = R.random(n, random_state=rng).as_quat() * np.float32(1.0)
    t = rng.normal(0, 0.5, (n, 3))
    outs[:, 0:4] = q
    outs[:, 4:7] = t
    outs[:, 21] = 40  # n_corner
    outs[:, 22] = 100  # n_surf
    outs[17, 21] = 2
    outs[17, 22] = 3  # 5 < 10: degraded
    outs[0, 21] = 0
    outs[0, 22] = 0  # frame 0 never counts
    with caplog.at_level(logging.WARNING, logger="vloam"):
        res = unpack_outputs(outs)
    assert list(res["lo_degraded"]) == [17]
    assert any("less correspondence" in r.message for r in caplog.records)

    q_acc, t_acc = R.identity(), np.zeros(3)
    for k in range(n):
        if k > 0:
            t_acc = t_acc + q_acc.apply(res["t_f2f"][k])
            q_acc = q_acc * R.from_quat(res["q_f2f"][k])
        np.testing.assert_allclose(res["t_w_lo"][k], t_acc, atol=1e-6)
        dq = (q_acc.inv() * R.from_quat(res["q_w_lo"][k])).magnitude()
        assert dq < 1e-6

import numpy as np

from vloam.data import synthetic
from vloam.lidar.loam_step import (BatchLoamEngine, LoamEngine,
                                       unpack_outputs)

from test_pipeline import small_cfg


def test_batch_engine_matches_single_streams():
    cfg = small_cfg()
    n = 4
    streams = []
    for seed in (31, 32):
        scene = synthetic.urban_scene(seed)
        poses = synthetic.drive_trajectory(n, speed=1.0,
                                           yaw_rate=0.01 * (seed - 30))
        streams.append([
            synthetic.simulate_scan(scene, T, n_scans=64, n_azimuth=700,
                                    seed=seed * 100 + k)
            for k, T in enumerate(poses)
        ])

    singles = []
    for scans in streams:
        eng = LoamEngine(cfg, chunk=2)
        for s in scans:
            eng.push(s)
        singles.append(unpack_outputs(eng.finish()))

    batch = BatchLoamEngine(cfg, batch=2, chunk=2, quantize_mm=0.0)
    for k in range(n):
        for b in range(2):
            batch.push(b, streams[b][k])
    outs = batch.finish()
    assert outs.shape[0] == 2 and outs.shape[1] == n
    for b in range(2):
        res = unpack_outputs(outs[b])
        np.testing.assert_allclose(res["t_w_lo"], singles[b]["t_w_lo"],
                                   atol=1e-3)
        np.testing.assert_allclose(res["t_w_mo"], singles[b]["t_w_mo"],
                                   atol=1e-2)

    # opt-in int16 staging (5 mm) stays within a few cm of the exact run
    batch_q = BatchLoamEngine(cfg, batch=2, chunk=2, quantize_mm=5.0)
    for k in range(n):
        for b in range(2):
            batch_q.push(b, streams[b][k])
    outs_q = batch_q.finish()
    for b in range(2):
        res_q = unpack_outputs(outs_q[b])
        np.testing.assert_allclose(res_q["t_w_mo"], singles[b]["t_w_mo"],
                                   atol=5e-2)

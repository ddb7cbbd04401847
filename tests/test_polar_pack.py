"""12-bit packed polar ingest (loam_step.pack12/unpack12): bit-exact
roundtrip, and engine parity — a pack12=True LoamEngine must produce the
SAME trajectory as the uint16 path when fed the same (<4096) range images,
because unpack12 is exact. The packing cuts upload bytes 25%."""

import numpy as np
import pytest

from test_pipeline import small_cfg

from vloam.lidar.loam_step import LoamEngine, pack12, unpack12


def test_pack12_roundtrip_exact(rng):
    img = rng.integers(0, 4096, (16, 360), dtype=np.uint16)
    img[0, :7] = 0
    img[3, 5] = 4095
    packed = pack12(img)
    assert packed.dtype == np.uint8
    assert packed.shape == (16, 540)  # 1.5 bytes/ray
    out = np.asarray(unpack12(packed))
    np.testing.assert_array_equal(out, img)


def test_pack12_batched_leading_dims(rng):
    img = rng.integers(0, 4096, (3, 8, 100), dtype=np.uint16)
    out = np.asarray(unpack12(pack12(img)))
    np.testing.assert_array_equal(out, img)


def test_pack12_rejects_overflow():
    img = np.full((4, 10), 4096, np.uint16)
    with pytest.raises(AssertionError):
        pack12(img)


def _polar_frames(cfg, n_frames, scale):
    from vloam.data import synthetic

    scene = synthetic.urban_scene(0, extent=20.0)
    poses = synthetic.drive_trajectory(n_frames, speed=0.8, yaw_rate=0.01)
    return [
        synthetic.simulate_scan_polar(
            scene, T, n_scans=cfg.lidar.n_scans,
            n_azimuth=cfg.lidar.max_points // cfg.lidar.n_scans,
            noise=0.01, seed=k, range_scale=scale)
        for k, T in enumerate(poses)
    ]


def test_engine_pack12_matches_uint16():
    cfg = small_cfg()
    scale = 0.03  # 122.8 m reach in 12 bits
    frames = [np.minimum(f, 4095).astype(np.uint16)
              for f in _polar_frames(cfg, 6, scale)]

    def run(**kw):
        eng = LoamEngine(cfg, chunk=3, **kw)
        for f in frames:
            eng.push_polar(f, range_scale=scale)
        return eng.finish()

    ref = run()
    packed = run(pack12=True)
    np.testing.assert_array_equal(packed, ref)


def test_batch_engine_pack12_matches_uint16():
    from vloam.lidar.loam_step import BatchLoamEngine

    cfg = small_cfg()
    scale = 0.03
    frames = [np.minimum(f, 4095).astype(np.uint16)
              for f in _polar_frames(cfg, 4, scale)]

    def run(**kw):
        eng = BatchLoamEngine(cfg, batch=2, chunk=2, **kw)
        for f in frames:
            for b in range(2):
                eng.push_polar(b, f, range_scale=scale)
        return eng.finish()

    np.testing.assert_array_equal(run(pack12=True), run())

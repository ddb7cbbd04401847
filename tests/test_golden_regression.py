"""Golden-trajectory regression (the analogue of the reference's checked-in
results/*.txt, SURVEY.md §4): a short deterministic synthetic drive through
the fused engine must keep matching the committed trajectory. Catches any
unintended numeric change in the scanreg/LO/MO chain.

Regenerate with scripts in the commit history ONLY when a deliberate
algorithm change shifts the numbers (and re-verify accuracy vs GT first).
"""

from pathlib import Path

import numpy as np

from vloam.data import synthetic
from vloam.lidar.loam_step import LoamEngine, unpack_outputs

from test_pipeline import small_cfg

GOLDEN = Path(__file__).parent / "golden" / "short_drive_lo_mo.npy"


def test_short_drive_matches_golden():
    cfg = small_cfg()
    scene = synthetic.urban_scene(42)
    poses = synthetic.drive_trajectory(6, speed=1.0, yaw_rate=0.015)
    eng = LoamEngine(cfg, chunk=3)
    for k, T in enumerate(poses):
        eng.push(synthetic.simulate_scan(scene, T, n_scans=64, n_azimuth=700,
                                         seed=k))
    res = unpack_outputs(eng.finish())
    golden = np.load(GOLDEN)
    # small cross-platform float noise allowed; trajectory-level agreement
    np.testing.assert_allclose(res["t_w_lo"], golden[0], atol=2e-2)
    np.testing.assert_allclose(res["t_w_mo"], golden[1], atol=3e-2)
    # and stays within GT bounds
    gt = np.stack([T[:3, 3] for T in poses])
    assert np.linalg.norm(res["t_w_mo"] - gt, axis=1).max() < 0.15

"""Mesh-sharded mapping INSIDE the fused engines (parallel/mesh_fused.py):
trajectory parity vs the single-device fused chunks on the 8-device CPU
test mesh, at the PRODUCTION grid size (map_n_buckets=1<<17), which the
windowed ring k-NN makes tractable."""

import dataclasses

import jax
import numpy as np
import pytest

from vloam.data import synthetic
from vloam.lidar.loam_step import LoamEngine, unpack_outputs
from vloam.parallel.sharded import data_mesh

from test_pipeline import small_cfg

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU test mesh")


def _drive(n, seed=11):
    scene = synthetic.urban_scene(seed)
    poses = synthetic.drive_trajectory(n, speed=1.0, yaw_rate=0.02)
    return [synthetic.simulate_scan(scene, T, n_scans=64, n_azimuth=700,
                                    seed=seed * 100 + k)
            for k, T in enumerate(poses)]


def _production_grid_cfg():
    """Test shapes for scan/stacks, PRODUCTION shapes for the map grid —
    the sweep-tractability regime VERDICT r4 item 4 names (2^17 buckets;
    4.2M corner slots)."""
    cfg = small_cfg()
    return cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, map_n_buckets=1 << 17, corner_bucket_cap=32,
        surf_bucket_cap=16))


def test_mesh_fused_loam_matches_single_device():
    cfg = _production_grid_cfg()
    n = 6
    scans = _drive(n)

    single = LoamEngine(cfg, chunk=3)
    for s in scans:
        single.push(s)
    res_single = unpack_outputs(single.finish())

    mesh = data_mesh(jax.devices()[:8])
    meshed = LoamEngine(cfg, chunk=3, mesh=mesh, mesh_window_rows=2048)
    for s in scans:
        meshed.push(s)
    res_mesh = unpack_outputs(meshed.finish())

    # LO never touches the mesh: identical
    np.testing.assert_allclose(res_mesh["t_w_lo"], res_single["t_w_lo"],
                               atol=1e-5)
    # MO: same association sets (window covers the active map; the
    # windowed ring 5-NN equals the 8-cell probe within the 1 m gate),
    # same LM update rule -> parity to float accumulation order
    d = np.linalg.norm(res_mesh["t_w_mo"] - res_single["t_w_mo"], axis=1)
    assert d.max() < 0.01, d

    # the window log proves the sweep was bounded AND sufficient
    active, cap = meshed.window_active_rows
    assert 0 < active <= cap, (active, cap)


def test_mesh_fused_vloam_matches_single_device(tmp_path):
    from test_pipeline import synth_setup

    from vloam.vloam_step import VloamEngine, unpack_vloam_outputs

    n = 4
    calib, frames, gt = synth_setup(n, seed=3)
    cfg = small_cfg(detach_VO_LO=False).replace(
        mapping=dataclasses.replace(small_cfg().mapping,
                                    map_n_buckets=1 << 15))

    single = VloamEngine(cfg, calib, chunk=2)
    for f in frames():
        single.push(f["points"], f["image"])
    res_single = unpack_vloam_outputs(single.finish(), calib)

    mesh = data_mesh(jax.devices()[:8])
    meshed = VloamEngine(cfg, calib, chunk=2, mesh=mesh,
                         mesh_window_rows=1024)
    for f in frames():
        meshed.push(f["points"], f["image"])
    res_mesh = unpack_vloam_outputs(meshed.finish(), calib)

    for which, tol in (("VO", 1e-4), ("LO", 1e-4), ("MO", 0.01)):
        d = np.linalg.norm(res_mesh[f"traj_{which}"][:, :, 3]
                           - res_single[f"traj_{which}"][:, :, 3], axis=1)
        assert d.max() < tol, (which, d)


def test_cli_mesh_fused_engine(tmp_path):
    """CLI: --mesh with the default fused engine runs the shard_map'd
    mapping chunk end-to-end on the KITTI-layout fixture."""
    from pathlib import Path

    from vloam.cli import main

    fixture = Path(__file__).parent / "fixtures" / "kitti_mini"
    out = tmp_path / "mesh_fused"
    rc = main([
        "run", "--odometry-root", str(fixture), "--seq", "00",
        "--sensor", "tiny", "--mode", "lidar-only", "--engine", "fused",
        "--chunk", "2", "--out", str(out), "--verbose", "0", "--mesh", "8",
    ])
    assert rc == 0
    mo = np.loadtxt(out / "MO1.txt").reshape(-1, 3, 4)
    assert len(mo) == 5 and np.isfinite(mo).all()

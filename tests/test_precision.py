"""Every float32 matrix product on the main path states full precision:
at default precision a GPU may run it in TF32 (~2^-11 relative), which at
metre-scale lidar coordinates and pixel-scale projections is far above the
geometry's tolerances."""

import jax
import jax.numpy as jnp
import pytest
from jax.extend import core

from vloam.config import tiny_test_profile
from vloam.data import synthetic


def _default_precision_dots(jaxpr, found):
    """Collect float32 dot_generals whose precision is not HIGHEST, walking
    every sub-jaxpr (scan, while, cond, pjit, custom rules, kernels)."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            prec = eqn.params.get("precision")
            precs = prec if isinstance(prec, tuple) else (prec,)
            f32 = any(v.aval.dtype == jnp.float32 for v in eqn.invars)
            if f32 and not all(p == jax.lax.Precision.HIGHEST for p in precs):
                found.append(str(eqn.source_info.traceback))
        for param in eqn.params.values():
            for sub in param if isinstance(param, (list, tuple)) else [param]:
                if isinstance(sub, core.ClosedJaxpr):
                    _default_precision_dots(sub.jaxpr, found)
                elif isinstance(sub, core.Jaxpr):
                    _default_precision_dots(sub, found)
    return found


def _chunk_jaxpr(name):
    cfg = tiny_test_profile()
    f, S = 2, cfg.lidar.n_scans
    ranges = jnp.zeros((f, S, 360), jnp.uint16)
    elev = jnp.zeros((S,), jnp.float32)
    if name == "loam_run_chunk_polar":
        from vloam.lidar.loam_step import LoamState, loam_run_chunk_polar

        pq, pt = jnp.zeros((f, 4)), jnp.zeros((f, 3))
        up = jnp.zeros((f,), bool)
        return jax.make_jaxpr(lambda s, r: loam_run_chunk_polar(
            s, r, elev, pq, pt, up, cfg, 0.005))(LoamState.create(cfg),
                                                 ranges)
    from vloam.vloam_step import (CamExtrinsics, VisionLoState,
                                  vision_lo_run_chunk_polar)

    cfg = cfg.replace(detach_VO_LO=False)
    ext = CamExtrinsics.from_calib(synthetic.synthetic_calib(
        cfg.vo.img_width, cfg.vo.img_height))
    imgs = jnp.zeros((f, cfg.vo.img_height, cfg.vo.img_width), jnp.uint8)
    return jax.make_jaxpr(lambda s, r, i: vision_lo_run_chunk_polar(
        s, r, elev, i, ext, cfg, 0.005))(VisionLoState.create(cfg), ranges,
                                        imgs)


@pytest.mark.parametrize("name", ["loam_run_chunk_polar",
                                  "vision_lo_run_chunk_polar"])
def test_no_default_precision_float32_dot(name):
    closed = _chunk_jaxpr(name)
    n_dots = str(closed).count("dot_general")
    assert n_dots > 0  # the walk sees the products it must check
    found = _default_precision_dots(closed.jaxpr, [])
    assert not found, "\n\n".join(found[:3])

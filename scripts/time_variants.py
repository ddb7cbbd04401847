"""Time each hand-written kernel and each plain alternative inside the
program that uses it, on the GPU at full KITTI HDL-64 width.

    python scripts/time_variants.py

- the fused LOAM chunk (polar ingest, F=16, as bench.py runs it) with the
  strict-selection Triton kernel vs its XLA form, and with each LO
  association impl ("packed", "xla");
- the ZNCC descriptor: one flat gather (features.describe_keypoints) vs
  the vmapped dynamic_slice form, alone (2048 keypoints, 24 px patches,
  1242x375) and against the vision chunk's per-frame time.

Device times are host-clock windows over pre-uploaded inputs, each ending in
block_until_ready; every variant is compiled and warmed before its window.
Prints one line per measurement and a JSON summary as the last line.
"""

import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _window(fn, reps):
    """Mean ms per call over `reps` calls after one warm call."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def time_loam_chunk(cfg, variant, ranges, elev, reps=5):
    """ms per frame of loam_run_chunk_polar under a selection/association
    variant (module attributes patched before tracing, caches cleared)."""
    import jax
    import jax.numpy as jnp

    from vloam.lidar import odometry, ring_assoc
    from vloam.lidar import scan_registration as sr
    from vloam.lidar.loam_step import LoamState, loam_run_chunk_polar

    select, impl = variant
    kernel = sr._select_rings_kernel
    assoc = odometry.ring_slab_assoc
    try:
        if select == "xla":
            sr._select_rings_kernel = lambda p, c, k, cfg: jax.vmap(
                lambda p, c, k: sr._select_ring(p, c, k, cfg))(p, c, k)
        odometry.ring_slab_assoc = partial(ring_assoc.ring_slab_assoc,
                                           impl=impl)
        jax.clear_caches()
        f = ranges.shape[0]
        pq = jnp.zeros((f, 4), jnp.float32).at[:, 3].set(1.0)
        pt = jnp.zeros((f, 3), jnp.float32)
        up = jnp.zeros((f,), bool)
        state = [LoamState.create(cfg)]

        def step():
            state[0], outs = loam_run_chunk_polar(state[0], ranges, elev, pq,
                                                  pt, up, cfg, 0.005)
            return outs

        t0 = time.perf_counter()
        jax.block_until_ready(step())
        compile_s = time.perf_counter() - t0
        return _window(step, reps) / f, compile_s
    finally:
        sr._select_rings_kernel = kernel
        odometry.ring_slab_assoc = assoc
        jax.clear_caches()


def describe_slices(img, xy, p):
    """ZNCC descriptors from one dynamic_slice per keypoint (vmapped): the
    plain alternative to features.describe_keypoints' single flat gather
    (the two agree for keypoints at least p//2 inside the image)."""
    import jax
    import jax.numpy as jnp

    def one(pt):
        patch = jax.lax.dynamic_slice(
            img, (pt[1].astype(jnp.int32) - p // 2,
                  pt[0].astype(jnp.int32) - p // 2), (p, p)).reshape(-1)
        patch = patch - jnp.mean(patch)
        return patch / jnp.maximum(jnp.linalg.norm(patch), 1e-6)

    return jax.vmap(one)(xy)


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vloam.config import kitti_hdl64
    from vloam.data import synthetic
    from vloam.runtime.cache import enable_compile_cache
    from vloam.runtime.profiling import card_info
    from vloam.vision import features

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"needs a GPU, found {dev.platform}")
    enable_compile_cache()
    card = card_info().splitlines()[0]
    print(f"device {dev.device_kind} | card {card}", flush=True)
    cfg = kitti_hdl64()
    res = {"card": card, "device_kind": dev.device_kind}

    scene = synthetic.urban_scene(0, extent=80.0)
    poses = synthetic.drive_trajectory(16, speed=1.1, yaw_rate=0.01)
    ranges = jnp.asarray(np.stack([
        synthetic.simulate_scan_polar(scene, T, n_scans=64, n_azimuth=1800,
                                      noise=0.01, seed=k)
        for k, T in enumerate(poses)]))
    elev = jnp.asarray(np.radians(synthetic.hdl64_elevations(64)),
                       jnp.float32)
    variants = [("triton", "packed"), ("xla", "packed"), ("triton", "xla"),
                ("triton", "packed")]
    for v in variants:
        ms, comp = time_loam_chunk(cfg, v, ranges, elev)
        key = f"loam_chunk select={v[0]} assoc={v[1]}"
        res.setdefault(key, []).append(ms)
        print(f"{key}: {ms:.4f} ms/frame (compile {comp:.1f} s)", flush=True)

    K, _, _, velo_T_cam = synthetic.default_cam_calib(1242, 375)
    img = jnp.asarray(synthetic.render_camera(
        scene, poses[0] @ velo_T_cam, K, 1242, 375))
    xy, _, mask = features.detect_keypoints(img, cfg.vo)
    p = cfg.vo.descriptor_patch
    f_slice = jax.jit(lambda i, x: describe_slices(i, x, p))
    f_gather = jax.jit(lambda i, x: features.describe_keypoints(i, x, cfg.vo))
    d_s = np.asarray(f_slice(img, xy))
    d_g = np.asarray(f_gather(img, xy))
    m = np.asarray(mask)
    err = float(np.abs(d_s - d_g)[m].max())
    for name, fn in (("slice", f_slice), ("gather", f_gather)):
        ms = _window(lambda: fn(img, xy), 50)
        res[f"describe {name}"] = ms
        print(f"describe {name}: {ms:.4f} ms ({int(m.sum())} live of "
              f"{xy.shape[0]} keypoints)", flush=True)
    print(f"describe slice vs gather max |diff| {err:.3e}", flush=True)

    from vloam.vloam_step import (CamExtrinsics, VisionLoState,
                                  vision_lo_run_chunk_polar)

    cfg_c = cfg.replace(detach_VO_LO=False)
    ext = CamExtrinsics.from_calib(synthetic.synthetic_calib(1242, 375))
    imgs = jnp.asarray(np.stack([
        (synthetic.render_camera(scene, T @ velo_T_cam, K, 1242, 375) * 255
         ).astype(np.uint8) for T in poses[:8]]))
    vstate = [VisionLoState.create(cfg_c)]

    def vstep():
        vstate[0], outs, _ = vision_lo_run_chunk_polar(
            vstate[0], ranges[:8], elev, imgs, ext, cfg_c, 0.005)
        return outs

    ms = _window(vstep, 5) / 8
    res["vision_lo_chunk"] = ms
    print(f"vision_lo_run_chunk_polar: {ms:.4f} ms/frame", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()

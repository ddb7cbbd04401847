"""Fused device-resident FULL VLOAM engine (camera + lidar), two device
programs per chunk of F frames:

  program 1 (vision+LO, lax.scan per frame): detect/describe (S1) ->
  depth grid (S3) -> VO solve seeded from the previous frame's LO f2f
  (S4, visual_odometry.cpp:269-281) -> scan registration -> f2f LO seeded
  from the same-frame VO when combined (laser_odometry.cpp:223-236),
  program 2 (mapping, lax.scan per frame): scan-to-map refinement (S5)
  over the chunk's voxel-downsampled stacks + LO world poses, carrying
  the cube map with in-place donation.

The VO<->LO coupling transforms (vloam_tf.cpp:59-75, laser_odometry.cpp:
563-570) are carried on device as quaternion Pose algebra; only packed pose
rows leave the device.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import PipelineConfig
from .geometry import so3
from .vision import features
from .vision.depth_map import DepthGrid, build_depth_grid, grid_shape
from .vision.optical_flow import lk_flow
from .vision.vo import solve_vo

VLOAM_OUT_DIM = 33


class CamExtrinsics(NamedTuple):
    """Constant extrinsic chain as device quaternion poses."""

    q_base_cam: jnp.ndarray  # base_T_cam0
    t_base_cam: jnp.ndarray
    q_velo_cam: jnp.ndarray  # velo_T_cam0
    t_velo_cam: jnp.ndarray
    K: jnp.ndarray  # [3, 3]
    P_velo_to_img: jnp.ndarray  # [3, 4]

    @staticmethod
    def from_calib(calib) -> "CamExtrinsics":
        from scipy.spatial.transform import Rotation as R

        base_T_cam = np.asarray(calib.imu_T_cam0, np.float64)
        imu_T_velo = np.asarray(calib.imu_T_velo, np.float64)
        velo_T_cam = np.linalg.inv(imu_T_velo) @ base_T_cam
        return CamExtrinsics(
            q_base_cam=jnp.asarray(R.from_matrix(base_T_cam[:3, :3]).as_quat(),
                                   jnp.float32),
            t_base_cam=jnp.asarray(base_T_cam[:3, 3], jnp.float32),
            q_velo_cam=jnp.asarray(R.from_matrix(velo_T_cam[:3, :3]).as_quat(),
                                   jnp.float32),
            t_velo_cam=jnp.asarray(velo_T_cam[:3, 3], jnp.float32),
            K=jnp.asarray(calib.K, jnp.float32),
            P_velo_to_img=jnp.asarray(calib.P_velo_to_img, jnp.float32),
        )


def _compose(q1, t1, q2, t2):
    return (so3.quat_normalize(so3.quat_multiply(q1, q2)),
            so3.quat_rotate(q1, t2) + t1)


def _invert(q, t):
    qi = so3.quat_conjugate(q)
    return qi, -so3.quat_rotate(qi, t)


def _conjugate(q_a, t_a, q_x, t_x):
    """a^-1 * x * a."""
    qa_i, ta_i = _invert(q_a, t_a)
    q1, t1 = _compose(qa_i, ta_i, q_x, t_x)
    return _compose(q1, t1, q_a, t_a)


# (a single-program whole-VLOAM chunk — vision AND mapping in one lax.scan
# — was removed in round 4: XLA fails to alias the cube-map scan carry once
# the vision graph is fused in, copying ~300 MB per frame)


class VisionState(NamedTuple):
    prev_kp: jnp.ndarray  # [K, 2]
    prev_kp_mask: jnp.ndarray  # [K]
    prev_desc: jnp.ndarray  # [K, P*P]
    prev_img: jnp.ndarray  # [H, W] (LK mode)
    prev_grid: DepthGrid

    @staticmethod
    def create(cfg: PipelineConfig) -> "VisionState":
        k = cfg.vo.max_keypoints
        p = cfg.vo.descriptor_patch
        gw, gh = grid_shape(cfg.vo)
        return VisionState(
            prev_kp=jnp.zeros((k, 2), jnp.float32),
            prev_kp_mask=jnp.zeros((k,), bool),
            prev_desc=jnp.zeros((k, p * p), jnp.float32),
            prev_img=jnp.zeros((cfg.vo.img_height, cfg.vo.img_width),
                               jnp.float32),
            prev_grid=DepthGrid(
                u=jnp.zeros((gw, gh), jnp.float32),
                v=jnp.zeros((gw, gh), jnp.float32),
                z=jnp.zeros((gw, gh), jnp.float32),
                cnt=jnp.zeros((gw, gh), jnp.int32),
            ),
        )


def _vision_frame_core(
    vstate: VisionState,
    scan: jnp.ndarray,
    n_pts: jnp.ndarray,
    image_u8: jnp.ndarray,
    a_seed: jnp.ndarray,  # [3] axis-angle VO seed (cam frame)
    t_seed: jnp.ndarray,  # [3]
    initialized: jnp.ndarray,  # bool
    ext: CamExtrinsics,
    cfg: PipelineConfig,
):
    """Vision half of one VLOAM frame: detect/describe/match + depth grid +
    VO solve with an explicit (already cam-frame) seed. Returns
    (vstate', prior_q, prior_t, vo_ok, vo_out [9], q_vo, t_vo)."""
    img = image_u8.astype(jnp.float32) / 255.0
    if cfg.vo.clahe:
        img = features.clahe(img)
    xy, score, kp_mask = features.detect_keypoints(img, cfg.vo)
    if cfg.vo.keypoint_nms:
        kp_mask = features.bucket_nms(
            xy, score, kp_mask, cfg.vo.img_width, cfg.vo.img_height,
            cfg.vo.nms_bucket, cfg.vo.nms_bucket, cfg.vo.nms_max_total)
    desc = features.describe_keypoints(img, xy, cfg.vo)
    in_mask = jnp.arange(scan.shape[0]) < n_pts
    grid = build_depth_grid(scan, in_mask, ext.P_velo_to_img, cfg.vo)

    if cfg.vo.reset_VO_to_identity:
        a_seed = jnp.zeros(3, jnp.float32)
        t_seed = jnp.zeros(3, jnp.float32)

    used_flow = jnp.bool_(False)
    if cfg.vo.optical_flow_match:
        xy1, status = lk_flow(vstate.prev_img, img, vstate.prev_kp, cfg.vo)
        prev_uv, curr_uv = vstate.prev_kp, xy1
        valid = vstate.prev_kp_mask & status
    else:
        idx1, ok = features.match_descriptors(
            vstate.prev_desc, vstate.prev_kp_mask, desc, kp_mask,
            cfg.vo.match_ratio, matcher=cfg.vo.matcher,
            select=cfg.vo.match_select)
        prev_uv = vstate.prev_kp
        curr_uv = xy[idx1]
        valid = ok
        if cfg.vo.lowtex_fallback:
            # descriptor matching collapsed (low-texture regime): re-match
            # the same frame pair by LK flow — gradient-based tracking
            # survives faint texture that defeats the ratio test (the
            # reference's alternative matcher, image_util.cpp:351-372).
            # Flow-recovered frames feed ONLY the exported VO stream: the
            # prior gate below refuses them (vo_ok requires a descriptor-
            # healthy solve), so a flow solve can never seed LO.
            xy1, status = lk_flow(vstate.prev_img, img, vstate.prev_kp,
                                  cfg.vo)
            fvalid = vstate.prev_kp_mask & status
            used_flow = jnp.sum(valid) < cfg.vo.min_vo_matches
            curr_uv = jnp.where(used_flow, xy1, curr_uv)
            valid = jnp.where(used_flow, fvalid, valid)
    valid = valid & initialized

    angles, t_vo, n32, n22 = solve_vo(
        prev_uv, curr_uv, valid, vstate.prev_grid, ext.K,
        a_seed.astype(jnp.float32), t_seed.astype(jnp.float32), cfg.vo)
    q_vo = so3.quat_from_axis_angle(angles)
    solve_ok = (initialized & jnp.all(jnp.isfinite(angles))
                & jnp.all(jnp.isfinite(t_vo))
                & (n32 + n22 >= cfg.vo.min_vo_matches))
    if cfg.vo.lowtex_fallback:
        # vo_ok gates the LO prior: ONLY descriptor-healthy solves are
        # trusted (a flow re-match keeps the exported stream alive but is
        # not allowed to seed LO — flow on textureless input can return
        # confidently-wrong tracks). Export tiers: solve (desc or flow)
        # -> LO-derived seed (what the reference's solve returns with zero
        # usable residuals) -> identity.
        vo_ok = solve_ok & jnp.logical_not(used_flow)
        q_fb = so3.quat_from_axis_angle(a_seed.astype(jnp.float32))
        t_fb = jnp.where(jnp.all(jnp.isfinite(t_seed)),
                         t_seed.astype(jnp.float32),
                         jnp.zeros(3, jnp.float32))
        q_fb = jnp.where(jnp.all(jnp.isfinite(q_fb)), q_fb,
                         jnp.asarray([0, 0, 0, 1], jnp.float32))
        q_vo = jnp.where(solve_ok, q_vo, q_fb)
        t_vo = jnp.where(solve_ok, t_vo, t_fb)
    else:
        vo_ok = solve_ok
        q_vo = jnp.where(vo_ok, q_vo, jnp.asarray([0, 0, 0, 1], jnp.float32))
        t_vo = jnp.where(vo_ok, t_vo, jnp.zeros(3, jnp.float32))

    q_vo_i, t_vo_i = _invert(q_vo, t_vo)
    qv_i, tv_i = _invert(ext.q_velo_cam, ext.t_velo_cam)
    q_pr, t_pr = _conjugate(qv_i, tv_i, q_vo_i, t_vo_i)

    new_vstate = VisionState(xy, kp_mask, desc, img, grid)
    vo_out = jnp.concatenate([
        q_vo, t_vo, jnp.asarray([n32, n22], jnp.float32)
    ])
    return new_vstate, q_pr, t_pr, vo_ok, vo_out, q_vo, t_vo


def _seed_from_lo_f2f(q_lo_f2f, t_lo_f2f, ext):
    """cam-frame VO seed from the LO f2f estimate:
    cam0_curr_LOT_cam0_prev = base_T_cam0^-1 * T_lo_f2f^-1 * base_T_cam0
    (visual_odometry.cpp:269-281)."""
    q_lo_i, t_lo_i = _invert(q_lo_f2f, t_lo_f2f)
    q_seed, t_seed = _conjugate(ext.q_base_cam, ext.t_base_cam, q_lo_i, t_lo_i)
    return so3.axis_angle_from_quat(q_seed), t_seed



# ---- production two-program chunked engine ----
#
# Program 1 (vision+LO): per frame, vision core AND scanreg AND the f2f LO
# solve interleaved in one lax.scan — so every VO solve is seeded from the
# TRUE previous-frame LO f2f estimate (reference visual_odometry.cpp:
# 269-281) and every LO solve from the same-frame VO prior (laser_odometry.
# cpp:223-236), exactly the reference's per-frame coupling. The carried
# state (feature slabs + poses + vision buffers, a few MB) aliases cleanly.
# Round 3 ran vision and LOAM as two whole-chunk programs, which forced
# intra-chunk VO solves onto stale/self-propagated seeds; in the low-match
# regime that compounded (LO ATE 1.22 m engine vs 0.19 m host on a 24-frame
# drive — see test_vloam_engine_long_combined_drive_matches_host).
#
# Program 2 (mapping): the scan-to-map stage alone, carrying the ~300 MB
# cube-map state with in-place donation. Keeping the map OUT of program 1
# is what preserves XLA's buffer aliasing (a single fused program copies
# the map every frame).


class VisionLoState(NamedTuple):
    vision: VisionState
    corner_last: "RingSlab"
    surf_last: "RingSlab"
    q_f2f: jnp.ndarray  # [4] last LO frame-to-frame estimate
    t_f2f: jnp.ndarray
    q_w: jnp.ndarray  # [4] LO world pose (odom frame)
    t_w: jnp.ndarray
    frame_idx: jnp.ndarray

    @staticmethod
    def create(cfg: PipelineConfig) -> "VisionLoState":
        from .lidar.ring_assoc import RingSlab

        sr = cfg.scanreg
        S = cfg.lidar.n_scans
        return VisionLoState(
            vision=VisionState.create(cfg),
            corner_last=RingSlab.empty(S, sr.less_sharp_cap // S),
            surf_last=RingSlab.empty(S, sr.less_flat_cap // S),
            q_f2f=jnp.asarray([0, 0, 0, 1], jnp.float32),
            t_f2f=jnp.zeros(3, jnp.float32),
            q_w=jnp.asarray([0, 0, 0, 1], jnp.float32),
            t_w=jnp.zeros(3, jnp.float32),
            frame_idx=jnp.int32(0),
        )


class MapState(NamedTuple):
    cube: "GridMap"
    q_wmap_wodom: jnp.ndarray
    t_wmap_wodom: jnp.ndarray
    frame_idx: jnp.ndarray

    @staticmethod
    def create(cfg: PipelineConfig) -> "MapState":
        from .lidar.mapping import GridMap

        return MapState(
            cube=GridMap.create(cfg.mapping),
            q_wmap_wodom=jnp.asarray([0, 0, 0, 1], jnp.float32),
            t_wmap_wodom=jnp.zeros(3, jnp.float32),
            frame_idx=jnp.int32(0),
        )


def _vision_lo_frame(st: VisionLoState, grid_scan, grid_n, feats, image_u8,
                     ext, cfg):
    """One frame of program 1. grid_scan/grid_n feed the depth grid (may be
    FOV-sliced in polar mode); feats are the frame's scanreg features.
    Returns (st', out [25], stacks (c_xyz, c_m, s_xyz, s_m))."""
    from .lidar.odometry import solve_lo
    from .lidar.voxel import voxel_downsample

    initialized = st.frame_idx > 0
    a_seed, t_seed = _seed_from_lo_f2f(st.q_f2f, st.t_f2f, ext)
    vst, q_pr, t_pr, vo_ok, vo_out, _, _ = _vision_frame_core(
        st.vision, grid_scan, grid_n, image_u8, a_seed, t_seed, initialized,
        ext, cfg)
    use_prior = jnp.logical_and(jnp.logical_not(cfg.detach_VO_LO), vo_ok)
    q0 = jnp.where(use_prior, q_pr, st.q_f2f)
    t0 = jnp.where(use_prior, t_pr, st.t_f2f)

    # No lax.cond around the LO solve (see lidar/loam_step.py): frame 0's
    # all-SENTINEL slabs zero every IRLS weight, so the solve returns its
    # seed and the select reproduces the skip branch exactly, without the
    # conditional's per-frame operand copies.
    q_s, t_s, n_c, n_s = solve_lo(feats.sharp, feats.flat, st.corner_last,
                                  st.surf_last, q0, t0, cfg.lo)
    q = jnp.where(initialized, q_s, jnp.asarray([0, 0, 0, 1], jnp.float32))
    t = jnp.where(initialized, t_s, jnp.zeros(3, jnp.float32))
    n_c = jnp.where(initialized, n_c, 0)
    n_s = jnp.where(initialized, n_s, 0)
    q_w = jnp.where(initialized,
                    so3.quat_normalize(so3.quat_multiply(st.q_w, q)), st.q_w)
    t_w = jnp.where(initialized, st.t_w + so3.quat_rotate(st.q_w, t),
                    st.t_w)

    c_xyz, _, _, c_m = voxel_downsample(
        feats.less_sharp.xyz, feats.less_sharp.mask,
        cfg.mapping.line_resolution, cfg.mapping.corner_stack_cap)
    s_xyz, _, _, s_m = voxel_downsample(
        feats.less_flat.xyz, feats.less_flat.mask,
        cfg.mapping.plane_resolution, cfg.mapping.surf_stack_cap)

    new_st = VisionLoState(
        vision=vst, corner_last=feats.less_sharp_slab,
        surf_last=feats.less_flat_slab,
        q_f2f=q, t_f2f=t, q_w=q_w, t_w=t_w, frame_idx=st.frame_idx + 1)
    out = jnp.concatenate([
        q, t, q_w, t_w,
        jnp.asarray([n_c, n_s], jnp.float32), vo_out,
    ]).astype(jnp.float32)  # [16 + 9]
    return new_st, out, (c_xyz, c_m, s_xyz, s_m)


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def vision_lo_run_chunk(
    vlstate: VisionLoState,
    scans: jnp.ndarray,  # [F, max_points, 3]
    n_pts: jnp.ndarray,  # [F]
    images_u8: jnp.ndarray,  # [F, H, W] uint8
    ext: CamExtrinsics,
    cfg: PipelineConfig,
):
    """Program 1 over F frames (xyz ingest). Returns
    (state', out [F, 25], stacks 4-tuple of [F, ...])."""
    from .lidar.scan_registration import register_scan

    def body(st, inp):
        scan, n, img = inp
        feats = register_scan(scan, n, cfg.lidar, cfg.scanreg)
        st, out, stacks = _vision_lo_frame(st, scan, n, feats, img, ext, cfg)
        return st, (out, stacks)

    vlstate, (outs, stacks) = jax.lax.scan(
        body, vlstate, (scans, n_pts, images_u8))
    return vlstate, outs, stacks


@partial(jax.jit, static_argnames=("cfg", "scale"), donate_argnums=(0,))
def vision_lo_run_chunk_polar(
    vlstate: VisionLoState,
    ranges: jnp.ndarray,  # [F, S, A] uint16
    elev_rad: jnp.ndarray,
    images_u8: jnp.ndarray,
    ext: CamExtrinsics,
    cfg: PipelineConfig,
    scale: float = 0.005,
):
    """Program 1, polar ingest: scanreg runs on the range image directly;
    the depth grid decodes only the forward cfg.vo.polar_fov_fraction of
    azimuth columns (rays outside the camera FOV never project; the
    depth-grid scatter is linear in decoded rays)."""
    from .lidar.loam_step import _unpack_polar, polar_to_xyz_cols
    from .lidar.scan_registration import register_scan_polar

    S, A = ranges.shape[1], ranges.shape[2]
    if ranges.dtype == jnp.uint8:  # pack12-compressed (loam_step.pack12)
        A = A // 3 * 2
    frac = min(max(cfg.vo.polar_fov_fraction, 0.0), 1.0)
    half = min(A, max(1, int(round(A * frac / 2.0))))
    az_full = -jnp.arange(A, dtype=jnp.float32) * (2.0 * jnp.pi / A)
    if 2 * half < A:
        az = jnp.concatenate([az_full[:half], az_full[A - half:]])
    else:
        half = 0
        az = az_full
    n_rays = jnp.int32(S * az.shape[0])

    def body(st, inp):
        r_img, img = inp
        r_img = _unpack_polar(r_img)
        r_sel = (r_img if half == 0
                 else jnp.concatenate([r_img[:, :half], r_img[:, A - half:]],
                                      axis=1))
        grid_scan = polar_to_xyz_cols(r_sel, elev_rad, az, scale)
        feats = register_scan_polar(r_img, elev_rad, cfg.lidar, cfg.scanreg,
                                    scale)
        st, out, stacks = _vision_lo_frame(st, grid_scan, n_rays, feats,
                                           img, ext, cfg)
        return st, (out, stacks)

    vlstate, (outs, stacks) = jax.lax.scan(body, vlstate,
                                           (ranges, images_u8))
    return vlstate, outs, stacks


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def mapping_run_chunk(
    mstate: MapState,
    c_xyz: jnp.ndarray,  # [F, Cc, 3] voxel-downsampled corner stacks
    c_m: jnp.ndarray,  # [F, Cc]
    s_xyz: jnp.ndarray,  # [F, Cs, 3]
    s_m: jnp.ndarray,  # [F, Cs]
    q_w_lo: jnp.ndarray,  # [F, 4] LO world poses (odom frame)
    t_w_lo: jnp.ndarray,  # [F, 3]
    cfg: PipelineConfig,
):
    """Program 2: the scan-to-map stage alone over F frames (carries the
    cube map with in-place donation). Returns (mstate', out [F, 8]):
    out = [q_mo(4), t_mo(3), mapped]."""
    from .lidar.mapping import solve_mapping

    def body(mst, inp):
        cx, cm, sx, sm, q_w, t_w = inp
        q_pred = so3.quat_normalize(
            so3.quat_multiply(mst.q_wmap_wodom, q_w))
        t_pred = mst.t_wmap_wodom + so3.quat_rotate(mst.q_wmap_wodom, t_w)

        def do_map(cube):
            new_cube, q_m, t_m, _ = solve_mapping(
                cube, cx, cm, sx, sm, q_pred, t_pred, cfg.mapping)
            return new_cube, q_m, t_m

        def skip_map(cube):
            return cube, q_pred, t_pred

        if cfg.lo.mapping_skip_frame == 1:
            # static fast path: a lax.cond around the cube would copy it
            mapped = jnp.bool_(True)
            cube, q_m, t_m = do_map(mst.cube)
        else:
            mapped = (mst.frame_idx % cfg.lo.mapping_skip_frame) == 0
            cube, q_m, t_m = jax.lax.cond(mapped, do_map, skip_map,
                                          mst.cube)

        q_off = so3.quat_normalize(
            so3.quat_multiply(q_m, so3.quat_conjugate(q_w)))
        t_off = t_m - so3.quat_rotate(q_off, t_w)
        new_mst = MapState(
            cube=cube,
            q_wmap_wodom=jnp.where(mapped, q_off, mst.q_wmap_wodom),
            t_wmap_wodom=jnp.where(mapped, t_off, mst.t_wmap_wodom),
            frame_idx=mst.frame_idx + 1,
        )
        out = jnp.concatenate([
            q_m, t_m, mapped.astype(jnp.float32)[None],
        ]).astype(jnp.float32)
        return new_mst, out

    return jax.lax.scan(body, mstate, (c_xyz, c_m, s_xyz, s_m,
                                       q_w_lo, t_w_lo))


def _fit_image(image: np.ndarray, vo_cfg) -> np.ndarray:
    """Crop/zero-pad an image to the config's static jit shape (bottom/right
    only, so pixel coordinates and the intrinsics stay valid). KITTI image
    sizes vary per sequence (1241x376, 1226x370, 1242x375, ...)."""
    H, W = vo_cfg.img_height, vo_cfg.img_width
    if image.shape == (H, W):
        return image
    image = image[:H, :W]
    if image.shape != (H, W):
        image = np.pad(image, ((0, H - image.shape[0]),
                               (0, W - image.shape[1])))
    return image


class VloamEngine:
    """Host wrapper for the fused VLOAM pipeline (camera + lidar).

    Runs two device programs per CHUNK of F frames — the vision+LO chunk
    (per-frame interleaved detect/describe/match/depth/VO/scanreg/LO with
    the reference's exact seeding chain, small state) and the MAPPING
    chunk (scan-to-map alone, large cube-map state) — exchanging the LO
    world poses + voxel-downsampled stacks as [F]-shaped device arrays.
    Two programs instead of one keeps the cube map's in-place buffer
    aliasing (a single fused program copies the ~300 MB map every frame;
    see the note above VisionState); two programs per CHUNK instead of per FRAME
    amortizes the per-call dispatch latency over F frames. No per-frame
    host downloads; packed outputs are fetched in finish()."""

    def __init__(self, cfg: PipelineConfig, calib, chunk: int = 8,
                 map_callback=None, mesh=None, mesh_window_rows: int = 4096,
                 pack12: bool = False):
        """mesh: a jax.sharding.Mesh — run the mapping chunk as distributed
        BA sharded over the mesh (parallel/mesh_fused.py) while the
        vision+LO chunk stays single-device. `window_active_rows` reports
        the peak active-map row count vs the window cap after finish()."""
        self.cfg = cfg
        self.chunk = chunk
        self.mesh = mesh
        self.pack12 = pack12  # 12-bit packed polar staging (loam_step.pack12)
        self.window_active_rows = (0, 0)
        self._win: list = []
        self.ext = CamExtrinsics.from_calib(calib)
        # Polar ingest decodes only the forward +-(polar_fov_fraction*pi)
        # azimuth wedge for the depth grid; a camera yawed outside that
        # wedge would silently lose all lidar depth (advisor r4). Validate
        # the camera principal axis (velo frame) against the wedge here,
        # loudly, instead of producing depthless VO downstream.
        frac = float(cfg.vo.polar_fov_fraction)
        if frac < 1.0:
            # cam0 principal axis +z expressed in velo frame: the rotation
            # part of velo_T_cam's third column
            velo_T_cam = np.asarray(getattr(calib, "imu_T_cam0", np.eye(4)))
            axis = velo_T_cam[:3, 2]
            yaw = abs(float(np.arctan2(axis[1], axis[0])))
            half_fov = np.arctan2(cfg.vo.img_width / 2.0,
                                  float(np.asarray(calib.K)[0, 0]))
            if yaw + half_fov > frac * np.pi + 1e-6:
                raise ValueError(
                    f"camera FOV (yaw {np.degrees(yaw):.1f} deg +- "
                    f"{np.degrees(half_fov):.1f} deg from velo +x) exceeds "
                    f"the decoded polar wedge +-{frac * 180:.0f} deg; raise "
                    "vo.polar_fov_fraction (1.0 = full sweep)")
        self.map_callback = map_callback
        self._next_pub = cfg.mapping.map_pub_number
        self.vstate = VisionLoState.create(cfg)
        if mesh is None:
            self.lstate = MapState.create(cfg)
            self._map_chunk = None
        else:
            from .parallel.mesh_fused import (make_mesh_mapping_chunk,
                                              shard_map_state)

            self.lstate = shard_map_state(MapState.create(cfg), mesh)
            self._map_chunk = make_mesh_mapping_chunk(
                mesh, cfg, window_rows=mesh_window_rows)
            self._mesh_window_rows = mesh_window_rows
        self._outs = []  # device arrays [F, VLOAM_OUT_DIM]
        self._scans: list[np.ndarray] = []
        self._ns: list[int] = []
        self._imgs: list[np.ndarray] = []
        self._polar: list[np.ndarray] = []
        self._elev = None
        self._polar_scale = 0.005
        self._frame = 0

    @property
    def state(self):
        """Pytree to block on (API compat with the old fused engine)."""
        return (self.vstate, self.lstate)

    def _run_mapping(self, stacks, vl_out):
        """Program 2: single-device mapping chunk, or the shard_map'd
        distributed-BA chunk when a mesh was given."""
        c_xyz, c_m, s_xyz, s_m = stacks
        if self._map_chunk is not None:
            self.lstate, mo_out = self._map_chunk(
                self.lstate, c_xyz, c_m, s_xyz, s_m,
                vl_out[:, 7:11], vl_out[:, 11:14])
            self._win.append(mo_out[:, 8:10])
        else:
            self.lstate, mo_out = mapping_run_chunk(
                self.lstate, c_xyz, c_m, s_xyz, s_m,
                vl_out[:, 7:11], vl_out[:, 11:14], self.cfg)
        return mo_out

    def _assemble(self, vl_out, mo_out):
        """Pack the two programs' outputs into the VLOAM_OUT_DIM row
        layout unpack_vloam_outputs expects."""
        return jnp.concatenate([
            vl_out[:, :14],          # q_f2f, t_f2f, q_w_lo, t_w_lo
            mo_out[:, :7],           # q_mo, t_mo
            vl_out[:, 14:16],        # n_corner, n_surf
            mo_out[:, 7:8],          # mapped flag
            vl_out[:, 16:25],        # vo_out (q_vo, t_vo, n32, n22)
        ], axis=1)

    def push(self, points: np.ndarray, image: np.ndarray):
        from .data.synthetic import pad_scan

        assert not self._polar, "do not mix push() and push_polar()"
        padded, n = pad_scan(points, self.cfg.lidar.max_points)
        if image.dtype != np.uint8:
            image = np.clip(image * 255.0, 0, 255).astype(np.uint8)
        image = _fit_image(image, self.cfg.vo)
        self._scans.append(padded)
        self._ns.append(n)
        self._imgs.append(image)
        if len(self._scans) >= self.chunk:
            self._flush()

    def push_polar(self, range_img: np.ndarray, image: np.ndarray,
                   range_scale: float = 0.005,
                   elevations_deg: np.ndarray | None = None):
        """Quantized range-image ingest (2 bytes/ray, ~6x fewer upload bytes
        than xyz float32). The range image is uploaded ONCE per chunk and decoded on device by
        both the vision chunk (depth grid) and the LOAM chunk."""
        assert not self._scans, "do not mix push() and push_polar()"
        if self._elev is None:
            from .data.synthetic import hdl64_elevations

            ed = (elevations_deg if elevations_deg is not None
                  else hdl64_elevations(self.cfg.lidar.n_scans))
            self._elev = jnp.asarray(np.radians(ed), jnp.float32)
        self._polar_scale = range_scale
        if image.dtype != np.uint8:
            image = np.clip(image * 255.0, 0, 255).astype(np.uint8)
        image = _fit_image(image, self.cfg.vo)
        if self.pack12:
            from .lidar.loam_step import pack12 as _pack12

            range_img = _pack12(range_img)
        self._polar.append(range_img)
        self._imgs.append(image)
        if len(self._polar) >= self.chunk:
            self._flush_polar()

    def _flush_polar(self):
        f = len(self._polar)
        if f == 0:
            return
        ranges = jnp.asarray(np.stack(self._polar))
        imgs = jnp.asarray(np.stack(self._imgs))
        self._polar, self._imgs = [], []

        self.vstate, vl_out, stacks = vision_lo_run_chunk_polar(
            self.vstate, ranges, self._elev, imgs, self.ext, self.cfg,
            self._polar_scale)
        mo_out = self._run_mapping(stacks, vl_out)
        self._outs.append(self._assemble(vl_out, mo_out))
        self._frame += f
        self._maybe_publish_map()

    def _flush(self):
        f = len(self._scans)
        if f == 0:
            return
        scans = jnp.asarray(np.stack(self._scans))
        ns = jnp.asarray(np.asarray(self._ns, np.int32))
        imgs = jnp.asarray(np.stack(self._imgs))
        self._scans, self._ns, self._imgs = [], [], []

        self.vstate, vl_out, stacks = vision_lo_run_chunk(
            self.vstate, scans, ns, imgs, self.ext, self.cfg)
        mo_out = self._run_mapping(stacks, vl_out)
        self._outs.append(self._assemble(vl_out, mo_out))
        self._frame += f
        self._maybe_publish_map()

    def _maybe_publish_map(self):
        if self.map_callback is not None and self._frame >= self._next_pub:
            from .lidar.mapping import export_map_points

            corner, surf = export_map_points(self.lstate.cube)
            self.map_callback(self._frame, corner, surf)
            while self._next_pub <= self._frame:
                self._next_pub += self.cfg.mapping.map_pub_number

    def finish(self) -> np.ndarray:
        self._flush()
        self._flush_polar()
        if self.mesh is not None and self._win:
            win = np.asarray(jnp.concatenate(self._win, axis=0))
            self.window_active_rows = (int(win.max()),
                                       self._mesh_window_rows
                                       * self.mesh.devices.size)
            self._win = []
        if not self._outs:
            return np.zeros((0, VLOAM_OUT_DIM), np.float32)
        stacked = jnp.concatenate(self._outs, axis=0).reshape(-1)
        return np.asarray(stacked).reshape(-1, VLOAM_OUT_DIM)


def unpack_vloam_outputs(outs: np.ndarray, calib,
                         min_correspondences: int = 10) -> dict:
    """Named arrays + the three exported cam0-start-frame trajectories
    (VO/LO/MO), recomposed in float64 with the FrameChain algebra
    (vloam_tf.cpp:59-153), vectorized: prefix-scan the VO world chain,
    then one batched conjugation per stream (a per-frame Python loop
    costs seconds on 4,660-frame sequences)."""
    from .fusion.frame_chain import FrameChain
    from .geometry.np_pose import inv_T, mat_cumprod, qt_to_T
    from .lidar.loam_step import unpack_outputs

    res = unpack_outputs(outs[:, :24], min_correspondences)
    res["q_vo"] = outs[:, 24:28].astype(np.float64)
    res["t_vo"] = outs[:, 28:31].astype(np.float64)
    res["n32"] = outs[:, 31].astype(int)
    res["n22"] = outs[:, 32].astype(int)

    n = len(outs)
    chain = FrameChain(np.asarray(calib.imu_T_velo, np.float64),
                       np.asarray(calib.imu_T_cam0, np.float64))
    B = chain.base_T_cam0
    Binv = np.linalg.inv(B)

    # VO world accumulation (vloam_tf.cpp:59-75): per-frame increment
    # base_last_T_base_curr = B @ inv(cam0_curr_T_cam0_last) @ B^-1,
    # identity on frame 0 and on non-finite solves (the NaN guard).
    C = qt_to_T(res["q_vo"], res["t_vo"])
    M = np.einsum("ij,njk,kl->nil", B, inv_T(C), Binv)
    bad = ~np.isfinite(M).all(axis=(1, 2))
    if n > 0:
        bad[0] = True
    M[bad] = np.eye(4)
    worlds = {
        "VO": mat_cumprod(M),
        "LO": qt_to_T(res["q_w_lo"], res["t_w_lo"]),
        "MO": qt_to_T(res["q_w_mo"], res["t_w_mo"]),
    }
    # export re-based to the cam0 start frame (vloam_tf.cpp:77-153)
    for which, W in worlds.items():
        X = np.einsum("ij,njk,kl->nil", Binv, W, B)
        start_inv = inv_T(X[0]) if n > 0 else np.eye(4)
        res[f"traj_{which}"] = np.einsum("ij,njk->nik", start_inv, X)[:, :3, :]
    return res

"""Synthetic KITTI-like world + sensor simulator (host-side numpy).

There is no KITTI data in this environment, so correctness is validated on a
simulated urban scene with exact ground-truth motion: ground plane, building
boxes (plane surfaces -> LOAM surf features) and poles (vertical cylinders ->
LOAM edge features), raycast with an HDL-64-style ring pattern (elevations
matching the reference's ring formula domain,
scan_registration.cpp:213-226), and a pinhole camera with KITTI-like
intrinsics for the VO pipeline.

Velodyne frame convention: x forward, y left, z up. Camera frame: z forward,
x right, y down (KITTI cam0).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Scene:
    ground_z: float = -1.73
    # axis-aligned boxes: (xmin, xmax, ymin, ymax, zmin, zmax)
    boxes: np.ndarray = field(default_factory=lambda: np.zeros((0, 6)))
    # vertical cylinders: (cx, cy, radius, zmin, zmax)
    poles: np.ndarray = field(default_factory=lambda: np.zeros((0, 5)))
    max_range: float = 80.0
    # image texture contrast multiplier (1.0 = urban default). Low values
    # model the KITTI seq-01 highway regime: surfaces render nearly
    # featureless, the corner detector finds few keypoints, and VO
    # degrades/diverges (BASELINE.md row 01: VO 50.5% t_rel).
    tex_scale: float = 1.0


def urban_scene(seed: int = 0, extent: float = 60.0, n_boxes: int = 14,
                n_poles: int = 24, scatter: int = 0) -> Scene:
    """Street corridor along +x. `scatter` adds that many extra buildings
    randomly placed over the whole [-extent, extent]^2 area (off-street
    drives — e.g. the eval's arcing trajectory — still see structure)."""
    rng = np.random.default_rng(seed)
    boxes = []
    # Two rows of "buildings" flanking a corridor along +x, like a street.
    for i in range(n_boxes):
        side = 1 if i % 2 == 0 else -1
        x0 = -extent + (2 * extent) * (i // 2) / max(1, n_boxes // 2)
        w = rng.uniform(6, 14)
        d = rng.uniform(4, 8)
        y0 = side * rng.uniform(8, 14)
        h = rng.uniform(4, 12)
        boxes.append([x0, x0 + w, min(y0, y0 + side * d), max(y0, y0 + side * d), -1.73, h])
    for _ in range(scatter):
        x0 = rng.uniform(-extent, extent)
        y0 = rng.uniform(-extent, extent)
        if abs(y0) < 16.0:  # keep the street corridor drivable
            continue
        w = rng.uniform(6, 14)
        d = rng.uniform(6, 14)
        boxes.append([x0, x0 + w, y0, y0 + d, -1.73, rng.uniform(4, 12)])
    poles = []
    for _ in range(n_poles):
        px = rng.uniform(-extent, extent)
        py = rng.uniform(-7.0, 7.0) + np.sign(rng.standard_normal()) * 6.0
        poles.append([px, py, rng.uniform(0.08, 0.2), -1.73, rng.uniform(3, 6)])
    return Scene(boxes=np.asarray(boxes, np.float64), poles=np.asarray(poles, np.float64))


def highway_scene(seed: int = 0, extent: float = 260.0,
                  tex_scale: float = 0.06) -> Scene:
    """Feature-poor highway corridor — the KITTI seq-01 stress regime
    (BASELINE.md row 01: VO 50.5% t_rel, MO(C) 45.4% vs MO(D) 2.7%; the
    reason the reference's detach_VO_LO flag exists,
    vloam_main.launch:4). Properties mirrored from that sequence:

    - near-featureless images (tex_scale ~0.06: surface contrast below the
      corner detector's quality gate almost everywhere),
    - sparse geometry: flat ground, a guardrail of small posts, and only a
      handful of distant structures — LiDAR features are few but (unlike
      the camera) still sufficient for LO/MO,
    - meant to be driven FAST (speed >= 3) for highway-scale inter-frame
      motion."""
    rng = np.random.default_rng(seed)
    boxes = []
    # a few distant buildings/sound barriers, far off the road
    for i in range(6):
        x0 = -extent + (2 * extent) * i / 6 + rng.uniform(0, 30)
        side = 1 if i % 2 == 0 else -1
        y0 = side * rng.uniform(35, 60)
        boxes.append([x0, x0 + rng.uniform(15, 40),
                      min(y0, y0 + side * 6.0), max(y0, y0 + side * 6.0),
                      -1.73, rng.uniform(3, 6)])
    poles = []
    # guardrail posts every ~8 m on both shoulders (thin, low)
    for x in np.arange(-extent, extent, 8.0):
        for side in (-1.0, 1.0):
            poles.append([x + rng.uniform(-0.3, 0.3), side * 7.5,
                          0.06, -1.73, -0.9])
    return Scene(boxes=np.asarray(boxes, np.float64),
                 poles=np.asarray(poles, np.float64),
                 tex_scale=tex_scale)


def hdl64_elevations(n_scans: int = 64) -> np.ndarray:
    """Per-ring elevation angles (deg) landing in the reference's 64-beam
    ring-id bins: upper block rings 0..31 at 2..-8.8deg (1/3 deg step), lower
    block 32..50 at -8.83..-24.33 (1/2 deg step)."""
    if n_scans == 64:
        # Offsets keep every beam strictly inside its ring bin and inside the
        # [-24.33, 2] elevation gate, away from float-precision boundaries.
        upper = 2.0 - (np.arange(32) + 0.2) / 3.0
        lower = -8.83 - (np.arange(32)) / 2.0 - 0.2
        return np.concatenate([upper, lower])
    if n_scans == 16:
        return -15.0 + 2.0 * np.arange(16)
    if n_scans == 32:
        return (np.arange(32) + 0.5) * 4.0 / 3.0 - 92.0 / 3.0 + 0.2
    raise ValueError(n_scans)


def _ray_scene_range(origins: np.ndarray, dirs: np.ndarray, scene: Scene,
                     with_ids: bool = False):
    """Min positive hit distance per ray (inf when no hit). origins [N,3],
    dirs [N,3] unit. With with_ids, also returns the hit object id
    (0 = ground, 1.. = boxes, then poles)."""
    n = dirs.shape[0]
    tmin = np.full(n, np.inf)
    ids = np.zeros(n, np.int32)

    def update(hit, t, oid):
        nonlocal tmin, ids
        better = hit & (t < tmin)
        tmin = np.where(better, t, tmin)
        ids = np.where(better, oid, ids)

    # ground plane z = ground_z
    dz = dirs[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (scene.ground_z - origins[:, 2]) / dz
    update((np.abs(dz) > 1e-9) & (t > 0.1), t, 0)

    # boxes via slab method
    for k, b in enumerate(scene.boxes):
        lo = b[[0, 2, 4]]
        hi = b[[1, 3, 5]]
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (lo[None, :] - origins) / dirs
            t2 = (hi[None, :] - origins) / dirs
        tnear = np.nanmax(np.minimum(t1, t2), axis=1)
        tfar = np.nanmin(np.maximum(t1, t2), axis=1)
        update((tnear <= tfar) & (tfar > 0) & (tnear > 0.1), tnear, 1 + k)

    # vertical cylinders
    for k, p in enumerate(scene.poles):
        cx, cy, r, zmin, zmax = p
        ox = origins[:, 0] - cx
        oy = origins[:, 1] - cy
        dx, dy = dirs[:, 0], dirs[:, 1]
        a = dx * dx + dy * dy
        bq = 2 * (ox * dx + oy * dy)
        c = ox * ox + oy * oy - r * r
        disc = bq * bq - 4 * a * c
        with np.errstate(divide="ignore", invalid="ignore"):
            sq = np.sqrt(np.maximum(disc, 0.0))
            t = (-bq - sq) / (2 * a)
        z = origins[:, 2] + t * dirs[:, 2]
        hit = (disc > 0) & (a > 1e-12) & (t > 0.1) & (z >= zmin) & (z <= zmax)
        update(hit, t, 1 + len(scene.boxes) + k)

    if with_ids:
        return tmin, ids
    return tmin


def simulate_scan(
    scene: Scene,
    T_world_sensor: np.ndarray,  # [4,4] sensor->world
    n_scans: int = 64,
    n_azimuth: int = 1800,
    noise: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """Raycast one scan; returns [n_valid, 3] float32 points in sensor frame,
    azimuth-major firing order within each ring (matching velodyne packets)."""
    rng = np.random.default_rng(seed)
    elev = np.radians(hdl64_elevations(n_scans))
    az = -np.linspace(0, 2 * np.pi, n_azimuth, endpoint=False)  # clockwise like velodyne
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(az), np.sin(az)
    # dirs[ring, az]: x = cos(e)cos(a), y = cos(e)sin(a), z = sin(e)
    d = np.stack(
        [
            ce[:, None] * ca[None, :],
            ce[:, None] * sa[None, :],
            np.broadcast_to(se[:, None], (n_scans, n_azimuth)),
        ],
        axis=-1,
    ).reshape(-1, 3)
    R = T_world_sensor[:3, :3]
    t = T_world_sensor[:3, 3]
    dw = d @ R.T
    ow = np.broadcast_to(t, dw.shape)
    rngs = _ray_scene_range(ow, dw, scene)
    hit = np.isfinite(rngs) & (rngs < scene.max_range)
    rngs = np.where(hit, rngs, 0.0)
    if noise > 0:
        rngs = rngs + np.where(hit, rng.normal(0, noise, rngs.shape), 0.0)
    pts_sensor = d * rngs[:, None]
    return pts_sensor[hit].astype(np.float32)


def simulate_scan_polar(
    scene: Scene,
    T_world_sensor: np.ndarray,
    n_scans: int = 64,
    n_azimuth: int = 1800,
    noise: float = 0.01,
    seed: int = 0,
    range_scale: float = 0.005,
) -> np.ndarray:
    """Same raycast as simulate_scan, returned as a quantized range image
    [n_scans, n_azimuth] uint16 in `range_scale`-meter units (0 = no return).
    3.4x fewer upload bytes than int16 xyz; xyz is reconstructed on device
    (loam_step.polar_to_xyz) from the static ray-direction grid."""
    rng = np.random.default_rng(seed)
    elev = np.radians(hdl64_elevations(n_scans))
    az = -np.linspace(0, 2 * np.pi, n_azimuth, endpoint=False)
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(az), np.sin(az)
    d = np.stack(
        [
            ce[:, None] * ca[None, :],
            ce[:, None] * sa[None, :],
            np.broadcast_to(se[:, None], (n_scans, n_azimuth)),
        ],
        axis=-1,
    ).reshape(-1, 3)
    R = T_world_sensor[:3, :3]
    t = T_world_sensor[:3, 3]
    rngs = _ray_scene_range(np.broadcast_to(t, d.shape), d @ R.T, scene)
    hit = np.isfinite(rngs) & (rngs < scene.max_range)
    if noise > 0:
        rngs = rngs + np.where(hit, rng.normal(0, noise, rngs.shape), 0.0)
    q = np.where(hit, np.clip(np.round(rngs / range_scale), 1, 65535), 0)
    return q.reshape(n_scans, n_azimuth).astype(np.uint16)


def pad_scan(pts: np.ndarray, cap: int) -> tuple[np.ndarray, int]:
    n = min(len(pts), cap)
    out = np.zeros((cap, 3), np.float32)
    out[:n] = pts[:n]
    return out, n


def _ray_scene_hit(origins, dirs, scene):
    """Hit distance + a textured intensity per ray (for camera rendering).
    Texture phases depend on the hit object so patches are distinctive —
    a globally periodic texture would defeat ratio-test matching the way a
    blank wall defeats real VO."""
    t, oid = _ray_scene_range(origins, dirs, scene, with_ids=True)
    hit = np.isfinite(t)
    tt = np.where(hit, t, 0.0)
    p = origins + dirs * tt[:, None]
    ph1 = 2.39996 * oid  # decorrelate per object
    ph2 = 1.17 * oid
    # deterministic world-anchored cell noise (~8 cm cells): real surfaces
    # carry aperiodic micro-detail; without it a close-up wall shows only
    # the periodic sinusoids and the ratio test rejects every match.
    # Faded with distance (once a pixel's footprint spans multiple cells
    # the noise aliases into per-frame decorrelated speckle that DESTROYS
    # patch matching — real optics low-pass this away).
    cell = np.floor(p * 12.0).astype(np.int64)
    hsh = np.sin(cell[:, 0] * 12.9898 + cell[:, 1] * 78.233
                 + cell[:, 2] * 37.719 + ph1)
    noise = ((hsh * 43758.5453) % 1.0) * np.clip(1.0 - tt / 45.0, 0.0, 1.0)
    ts = scene.tex_scale
    tex = (
        0.52
        + ts * 0.16 * np.sin(2.1 * p[:, 0] + ph1) * np.cos(1.7 * p[:, 1] - ph2)
        + ts * 0.12 * np.sin(5.3 * p[:, 2] + 1.3 * p[:, 0] + 0.7 * ph2)
        + ts * 0.10 * np.sin(9.1 * p[:, 1] + 3.1 * p[:, 2] + ph1)
        + ts * 0.06 * np.sin(17.0 * p[:, 0] - 13.0 * p[:, 1] + 2.0 * ph2)
        + ts * 0.05 * np.sign(np.sin(4.9 * p[:, 0] + ph1) * np.sin(4.3 * p[:, 2] - ph2))
        + ts * 0.14 * (noise - 0.5)
    )
    shade = np.clip(1.0 - tt / (scene.max_range * 1.2), 0.2, 1.0)
    img = np.where(hit, np.clip(tex * shade, 0.0, 1.0), 0.08)
    return img, np.where(hit, tt, np.inf)


def render_camera(
    scene: Scene,
    T_world_cam: np.ndarray,  # [4,4] cam->world; cam: z fwd, x right, y down
    K: np.ndarray,  # [3,3]
    width: int,
    height: int,
) -> np.ndarray:
    """Raycast a grayscale image [H, W] float32 in [0, 1]."""
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    pix = np.stack([u.ravel() + 0.5, v.ravel() + 0.5, np.ones(u.size)], axis=0)
    d_cam = np.linalg.solve(K, pix).T
    d_cam /= np.linalg.norm(d_cam, axis=1, keepdims=True)
    R = T_world_cam[:3, :3]
    t = T_world_cam[:3, 3]
    dw = d_cam @ R.T
    ow = np.broadcast_to(t, dw.shape)
    img, _ = _ray_scene_hit(ow, dw, scene)
    return img.reshape(height, width).astype(np.float32)


def default_cam_calib(width: int = 320, height: int = 96):
    """KITTI-like intrinsics scaled to the requested size, plus the
    velo->cam extrinsic chain (cam: z fwd, x right, y down; velo: x fwd,
    y left, z up; cam sits at the velo origin for simplicity)."""
    f = 718.0 * width / 1242.0  # KITTI-like focal scaled to requested width
    K = np.array([[f, 0.0, width / 2.0], [0.0, f, height * 0.55], [0.0, 0.0, 1.0]])
    # cam axes in velo frame: x_cam = -y_velo, y_cam = -z_velo, z_cam = x_velo
    velo_T_cam = np.eye(4)
    velo_T_cam[:3, :3] = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], float)
    cam_T_velo = np.linalg.inv(velo_T_cam)
    P_rect0 = np.hstack([K, np.zeros((3, 1))])
    return K, P_rect0, cam_T_velo, velo_T_cam


def synthetic_calib(width: int = 320, height: int = 96):
    """default_cam_calib's camera as a kitti.Calib: cam0 at the velo origin,
    no rectification, imu frame = velo frame."""
    from .kitti import Calib

    _, P_rect0, cam_T_velo, velo_T_cam = default_cam_calib(width, height)
    return Calib(P_rect0=P_rect0, cam_T_velo=cam_T_velo,
                 rect0_T_cam=np.eye(4), imu_T_velo=np.eye(4),
                 imu_T_cam0=velo_T_cam)


def drive_trajectory(n_frames: int, speed: float = 1.0,
                     yaw_rate: float | np.ndarray = 0.01,
                     start: np.ndarray | None = None) -> list[np.ndarray]:
    """Ground-truth sensor poses: arc along +x (per-frame motion `speed` m,
    `yaw_rate` rad — scalar, or per-frame array for S-curves that stay on
    the street like real drives)."""
    poses = []
    T = np.eye(4) if start is None else start.copy()
    yr = np.broadcast_to(np.asarray(yaw_rate, float), (n_frames,))
    for k in range(n_frames):
        poses.append(T.copy())
        c, s = np.cos(yr[k]), np.sin(yr[k])
        dT = np.eye(4)
        dT[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        dT[0, 3] = speed
        T = T @ dT
    return poses

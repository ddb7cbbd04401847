import numpy as np
import jax.numpy as jnp
import cv2
from scipy.spatial.transform import Rotation as R

from vloam.config import VisualOdometryConfig
from vloam.data import synthetic
from vloam.vision import features
from vloam.vision.depth_map import build_depth_grid, query_depth
from vloam.vision.optical_flow import lk_flow
from vloam.vision.vo import solve_vo

CFG = VisualOdometryConfig(img_width=320, img_height=96, max_keypoints=256,
                           max_matches=512)


def make_frame(seed=0, pose=None):
    scene = synthetic.urban_scene(seed)
    K, P_rect0, cam_T_velo, velo_T_cam = synthetic.default_cam_calib(320, 96)
    T_ws = np.eye(4) if pose is None else pose  # sensor (velo) -> world
    T_wc = T_ws @ velo_T_cam
    img = synthetic.render_camera(scene, T_wc, K, 320, 96)
    pts = synthetic.simulate_scan(scene, T_ws, n_scans=64, n_azimuth=700, seed=seed)
    P_velo_to_img = P_rect0 @ np.linalg.inv(velo_T_cam)  # [3,4] velo -> pixels
    return img, pts, K, P_velo_to_img


def test_shi_tomasi_overlaps_opencv():
    img, *_ = make_frame(2)
    xy, score, mask = features.detect_keypoints(jnp.asarray(img), CFG)
    ours = np.asarray(xy)[np.asarray(mask)]
    assert len(ours) > 30
    cv = cv2.goodFeaturesToTrack((img * 255).astype(np.uint8), 256, 0.03, 7.5,
                                 blockSize=5)
    cv = cv.reshape(-1, 2)
    # most of our corners should be close to some OpenCV corner
    d = np.linalg.norm(ours[:, None] - cv[None], axis=-1).min(axis=1)
    assert np.median(d) < 4.0, np.median(d)


def test_zncc_matching_identity():
    img, *_ = make_frame(3)
    im = jnp.asarray(img)
    xy, score, mask = features.detect_keypoints(im, CFG)
    desc = features.describe_keypoints(im, xy, CFG)
    idx, ok = features.match_descriptors(desc, mask, desc, mask, 0.9)
    ok = np.asarray(ok)
    # self-matching must map i -> i for valid keypoints
    hit = np.asarray(idx)[ok] == np.arange(len(ok))[ok]
    assert hit.mean() > 0.95


def test_lk_flow_recovers_shift():
    img, *_ = make_frame(4)
    shift = 3
    img1 = np.roll(img, shift, axis=1)
    xy0, _, mask = features.detect_keypoints(jnp.asarray(img), CFG)
    xy1, status = lk_flow(jnp.asarray(img), jnp.asarray(img1), xy0, CFG)
    sel = np.asarray(mask & status)
    flow = np.asarray(xy1 - xy0)[sel]
    assert sel.sum() > 20
    med = np.median(flow, axis=0)
    np.testing.assert_allclose(med, [shift, 0.0], atol=0.35)


def test_depth_grid_and_query():
    img, pts, K, P_vi = make_frame(5)
    mask = np.ones(len(pts), bool)
    grid = build_depth_grid(jnp.asarray(pts), jnp.asarray(mask),
                            jnp.asarray(P_vi, jnp.float32), CFG)
    assert int(jnp.sum(grid.cnt > 0)) > 100
    # query at projected positions of lidar points: depth must roughly match
    ph = pts @ np.asarray(P_vi)[:, :3].T + np.asarray(P_vi)[:, 3]
    front = ph[:, 2] > 0.5
    uv = ph[front, :2] / ph[front, 2:3]
    inside = (uv[:, 0] > 15) & (uv[:, 0] < 305) & (uv[:, 1] > 15) & (uv[:, 1] < 80)
    uv = uv[inside][:200]
    z_true = ph[front, 2][inside][:200]
    z_got = np.asarray(query_depth(grid, jnp.asarray(uv, jnp.float32), CFG))
    valid = z_got > 0
    assert valid.mean() > 0.6
    rel = np.abs(z_got[valid] - z_true[valid]) / z_true[valid]
    assert np.median(rel) < 0.1, np.median(rel)


def test_solve_vo_recovers_motion_synthetic_points(rng):
    """Pure-solver test: synthetic 3D points observed in two frames."""
    K = np.array([[185.0, 0, 160.0], [0, 185.0, 52.8], [0, 0, 1.0]])
    n = 300
    X0 = rng.uniform([-10, -3, 5], [10, 3, 40], (n, 3))  # cam frame 0
    w_true = np.array([0.02, -0.03, 0.01])
    t_true = np.array([0.1, -0.05, 1.0])
    X1 = R.from_rotvec(w_true).apply(X0) + t_true
    uv0 = (X0 / X0[:, 2:3]) @ K.T
    uv1 = (X1 / X1[:, 2:3]) @ K.T
    # depth grid: give depth for a half of the points via a fake grid is
    # complex; instead exercise the solver directly with mixed families by
    # constructing an empty grid (all 2D-2D) plus translation scale from
    # a handful of 3D-2D constraints -> here: build a real grid from X0.
    from vloam.vision.depth_map import DepthGrid
    import jax.numpy as jnp

    gw, gh = -(-320 // 5), -(-96 // 5)
    grid_u = np.zeros((gw, gh), np.float32)
    grid_v = np.zeros((gw, gh), np.float32)
    grid_z = np.zeros((gw, gh), np.float32)
    grid_c = np.zeros((gw, gh), np.int32)
    for p, uv in zip(X0, uv0[:, :2]):
        ix, iy = int(uv[0] // 5), int(uv[1] // 5)
        if 0 <= ix < gw and 0 <= iy < gh:
            grid_u[ix, iy] = uv[0]
            grid_v[ix, iy] = uv[1]
            grid_z[ix, iy] = p[2]
            grid_c[ix, iy] = 1
    grid = DepthGrid(jnp.asarray(grid_u), jnp.asarray(grid_v),
                     jnp.asarray(grid_z), jnp.asarray(grid_c))
    cfg = VisualOdometryConfig(img_width=320, img_height=96, max_matches=512,
                               remove_VO_outlier=0)
    angles, t, n32, n22 = solve_vo(
        jnp.asarray(uv0[:, :2], jnp.float32), jnp.asarray(uv1[:, :2], jnp.float32),
        jnp.ones(n, bool), grid, jnp.asarray(K, jnp.float32),
        jnp.zeros(3), jnp.zeros(3), cfg,
    )
    assert int(n32) > 50
    np.testing.assert_allclose(np.asarray(angles), w_true, atol=5e-3)
    np.testing.assert_allclose(np.asarray(t), t_true, atol=0.15)


def test_alternative_detectors_fire():
    """Every reference DetectorType alternative (image_util.cpp:37-72)
    produces keypoints on a textured frame."""
    img, *_ = make_frame(5)
    im = jnp.asarray(img)
    for det in ("orb", "brisk", "sift", "akaze", "fast"):
        cfg = VisualOdometryConfig(
            img_width=320, img_height=96, max_keypoints=256, max_matches=512,
            detector=det, fast_threshold=0.06)
        xy, score, mask = features.detect_keypoints(im, cfg)
        n = int(np.asarray(mask).sum())
        assert n > 10, (det, n)
        pts = np.asarray(xy)[np.asarray(mask)]
        assert (pts[:, 0] < 320).all() and (pts[:, 1] < 96).all(), det


def test_orb_descriptor_matches_under_rotation():
    """Oriented BRIEF self-matches and survives an in-plane rotation that
    breaks unoriented patches (the point of the IC-angle steering)."""
    img, *_ = make_frame(6)
    im = jnp.asarray(img)
    cfg = VisualOdometryConfig(
        img_width=320, img_height=96, max_keypoints=128, max_matches=256,
        descriptor="orb")
    xy, score, mask = features.detect_keypoints(im, cfg)
    desc = features.describe_keypoints(im, xy, cfg)
    # rows are +-1/sqrt(256): unit norm, so Hamming = (1 - dot) * 128
    norms = np.linalg.norm(np.asarray(desc), axis=1)
    assert np.allclose(norms, 1.0, atol=1e-5)
    idx, ok = features.match_descriptors(desc, mask, desc, mask, 0.9)
    ok = np.asarray(ok)
    hit = np.asarray(idx)[ok] == np.arange(len(ok))[ok]
    assert hit.mean() > 0.9

    # rotate 90 deg (exact, no resampling blur) and re-describe
    img_r = np.rot90(np.asarray(im)).copy()
    cfg_r = VisualOdometryConfig(
        img_width=96, img_height=320, max_keypoints=128, max_matches=256,
        descriptor="orb")
    h = im.shape[0]
    # keypoint (x,y) -> rot90 coords (y', x') = (w-1-x? ) : rot90 maps
    # (row r, col c) -> (row W-1-c, col r)  for np.rot90(img) [H,W]->[W,H]
    xy_np = np.asarray(xy)
    xy_r = np.stack([xy_np[:, 1], im.shape[1] - 1 - xy_np[:, 0]], axis=1)
    inb = (xy_r[:, 0] > 16) & (xy_r[:, 0] < 320 - 16) & \
          (xy_r[:, 1] > 16) & (xy_r[:, 1] < 96 - 16)
    desc_r = features.describe_keypoints(
        jnp.asarray(img_r), jnp.asarray(xy_r, np.float32), cfg_r)
    m = np.asarray(mask) & inb
    idx2, ok2 = features.match_descriptors(
        desc, jnp.asarray(m), desc_r, jnp.asarray(m), 0.9)
    sel = np.asarray(ok2) & m
    if sel.sum() >= 5:
        hit2 = np.asarray(idx2)[sel] == np.arange(len(sel))[sel]
        assert hit2.mean() > 0.6, hit2.mean()


def test_flann_and_nn_matcher_modes():
    img, *_ = make_frame(7)
    im = jnp.asarray(img)
    xy, score, mask = features.detect_keypoints(im, CFG)
    desc = features.describe_keypoints(im, xy, CFG)
    idx_f, ok_f = features.match_descriptors(desc, mask, desc, mask, 0.9,
                                             matcher="flann")
    okf = np.asarray(ok_f)
    hit = np.asarray(idx_f)[okf] == np.arange(len(okf))[okf]
    assert hit.mean() > 0.9  # approximate NN still finds exact self-matches
    idx_n, ok_n = features.match_descriptors(desc, mask, desc, mask, 0.9,
                                             select="nn")
    # NN keeps every masked query (no ratio rejection)
    assert bool(np.all(np.asarray(ok_n) == np.asarray(mask)))


def describe_zncc_np(img, xy, p):
    """NumPy ZNCC reference: the p x p window at (x, y) - p//2, shifted to
    lie inside the image, zero-mean and unit-norm."""
    h, w = img.shape
    out = []
    for x, y in np.asarray(xy).astype(int):
        y0 = min(max(y - p // 2, 0), h - p)
        x0 = min(max(x - p // 2, 0), w - p)
        patch = np.asarray(img, np.float64)[y0:y0 + p, x0:x0 + p].ravel()
        patch = patch - patch.mean()
        out.append(patch / max(np.linalg.norm(patch), 1e-6))
    return np.stack(out)


def test_zncc_gather_matches_numpy_including_borders():
    img, *_ = make_frame(5)
    im = jnp.asarray(img)
    xy, _, _ = features.detect_keypoints(im, CFG)
    h, w = im.shape
    border = jnp.asarray([[0.0, 0.0], [w - 1.0, h - 1.0], [3.0, h - 2.0],
                          [w - 5.0, 1.0]], jnp.float32)
    xy = jnp.concatenate([xy, border])
    got = np.asarray(features.describe_keypoints(im, xy, CFG))
    want = describe_zncc_np(img, xy, CFG.descriptor_patch)
    np.testing.assert_allclose(got, want, atol=1e-5)

import numpy as np
import cv2
import jax.numpy as jnp

from vloam.vision import features

from test_vision import CFG, make_frame


def test_clahe_close_to_opencv():
    img, *_ = make_frame(8)
    got = np.asarray(features.clahe(jnp.asarray(img), clip_limit=2.0,
                                    tiles=(8, 8)))
    cv = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    want = cv.apply((img * 255).astype(np.uint8)).astype(np.float32) / 255.0
    # implementations differ in interpolation details; demand a strong
    # correlation and similar contrast expansion
    c = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert c > 0.95, c
    assert got.std() > img.std() * 1.05  # contrast actually increased


def test_bucket_nms_caps_counts():
    img, *_ = make_frame(9)
    xy, score, mask = features.detect_keypoints(jnp.asarray(img), CFG)
    new_mask = features.bucket_nms(xy, score, mask, 320, 96,
                                   bucket_w=80, bucket_h=48, max_total=12)
    new_mask = np.asarray(new_mask)
    assert new_mask.sum() <= 12
    assert new_mask.sum() > 0
    # per-bucket cap: 12 / (4*2)=1 -> each bucket at most 1 + mask subset
    pts = np.asarray(xy)[new_mask]
    bids = (pts[:, 0] // 80).astype(int) + 4 * (pts[:, 1] // 48).astype(int)
    _, counts = np.unique(bids, return_counts=True)
    assert counts.max() <= max(1, 12 // 8)
    assert (new_mask & ~np.asarray(mask)).sum() == 0


def test_export_map_points():
    from vloam.config import tiny_test_profile
    from vloam.lidar.mapping import GridMap, export_map_points

    cfg = tiny_test_profile().mapping
    gm = GridMap.create(cfg)

    def fill(grid, bucket, n, val):
        # interleaved row layout: row b = [x_0..x_cap | y.. | z..]
        cap = grid.cap
        pts = grid.pts
        for block in range(3):
            pts = pts.at[bucket, block * cap:block * cap + n].set(val)
        return grid._replace(pts=pts,
                             n_live=grid.n_live + jnp.int32(n))

    gm = gm._replace(
        corner=fill(gm.corner, 3, 5, 1.5),
        surf=fill(gm.surf, 7, 9, 2.5),
    )
    corner, surf = export_map_points(gm)
    assert corner.shape == (5, 3) and np.allclose(corner, 1.5)
    assert surf.shape == (9, 3) and np.allclose(surf, 2.5)

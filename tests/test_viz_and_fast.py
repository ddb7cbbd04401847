import numpy as np
import jax.numpy as jnp

from vloam.config import VisualOdometryConfig
from vloam.vision import features, viz

from test_vision import CFG, make_frame


def test_fast_detector_finds_corners():
    img, *_ = make_frame(6)
    cfg = VisualOdometryConfig(img_width=320, img_height=96, max_keypoints=256,
                               detector="fast", fast_threshold=0.08)
    xy, score, mask = features.detect_keypoints(jnp.asarray(img), cfg)
    n = int(mask.sum())
    assert n > 10, n
    # scores positive, coords interior
    s = np.asarray(score)[np.asarray(mask)]
    assert (s > 0).all()
    pts = np.asarray(xy)[np.asarray(mask)]
    assert (pts[:, 0] >= 16).all() and (pts[:, 0] < 320 - 16).all()


def test_render_utilities(tmp_path):
    img, pts, K, P_vi = make_frame(7)
    im = jnp.asarray(img)
    xy, score, mask = features.detect_keypoints(im, CFG)
    desc = features.describe_keypoints(im, xy, CFG)
    idx, ok = features.match_descriptors(desc, mask, desc, mask, 0.9)
    pairs = [(i, int(idx[i])) for i in range(len(ok)) if bool(ok[i])][:50]
    out = viz.render_matches(img, img, np.asarray(xy), np.asarray(xy), pairs,
                             path=str(tmp_path / "matches.png"))
    assert out.shape == (96, 640, 3)
    assert (tmp_path / "matches.png").exists()

    from vloam.vision.depth_map import build_depth_grid

    grid = build_depth_grid(jnp.asarray(pts), jnp.ones(len(pts), bool),
                            jnp.asarray(P_vi, jnp.float32), CFG)
    canvas = viz.render_depth(img, grid, CFG, path=str(tmp_path / "depth.png"))
    assert canvas.shape == (96, 320, 3)
    # some depth dots must have been drawn (non-gray pixels)
    gray = np.all(canvas == canvas[..., :1], axis=-1)
    assert (~gray).sum() > 50

    flow_img = viz.render_flow(img, np.asarray(xy)[:20],
                               np.asarray(xy)[:20] + 3,
                               np.ones(20, bool),
                               path=str(tmp_path / "flow.png"))
    assert flow_img.shape == (96, 320, 3)

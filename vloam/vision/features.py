"""Keypoint detection + descriptors + matmul matching.

Fixed-shape replacement for the reference's OpenCV feature pipeline
(image_util.cpp):

- detKeypoints (:12-36): cv::goodFeaturesToTrack with maxCorners=1024,
  quality 0.03, minDistance 7.5, blockSize 5 -> Sobel gradients + box-filter
  structure tensor + min-eigenvalue response + maxpool NMS + top-k.
  The reference's alternative DetectorTypes (:37-72) map to vectorized
  response maps sharing the same NMS/top-k tail:
    FAST  -> fast_response (contiguous-arc test, vectorized over all pixels)
    ORB   -> FAST gate scored by the Harris measure (cv::ORB HARRIS_SCORE)
    BRISK -> multi-scale FAST over a mean-pooled pyramid (AGAST stand-in)
    SIFT  -> difference-of-Gaussians scale-space extrema
    AKAZE -> scale-normalized determinant-of-Hessian over smoothed scales
      (the nonlinear-diffusion scale space is host-hostile; det-Hessian is
      the same blob measure KAZE thresholds)
- descKeypoints (:162-212, ORB): two descriptors. Default is a 24x24
  zero-normalized patch (ZNCC correlation IS a matmul). `descriptor="orb"`
  is a faithful oriented-BRIEF-256: intensity-centroid orientation, rotated
  point pairs, bits stored as +-1/sqrt(n) so one similarity MATMUL computes
  Hamming distance (sim = 1 - 2*ham/n) — binary matching as a matrix
  product instead of popcounts.
- matchDescriptors (:214-296): MatcherType BF -> exact lax.top_k over the
  similarity matmul; FLANN (approximate NN) -> lax.approx_max_k (exact
  top-k on GPUs and CPUs). SelectType KNN -> ratio test (:270-283),
  NN -> best match only (:264-268).

Images are float32 [H, W] in [0, 1].
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import VisualOdometryConfig


def _conv2_same(img: jnp.ndarray, kern: jnp.ndarray) -> jnp.ndarray:
    return jax.scipy.signal.convolve2d(img, kern, mode="same")


def _shift(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """img shifted so out[y, x] = img[y+dy, x+dx], zero-padded (matching
    convolve2d's zero boundary)."""
    h, w = img.shape
    out = img
    if dy:
        z = jnp.zeros((abs(dy), w), img.dtype)
        out = (jnp.concatenate([out[dy:], z]) if dy > 0
               else jnp.concatenate([z, out[:dy]]))
    if dx:
        z = jnp.zeros((h, abs(dx)), img.dtype)
        out = (jnp.concatenate([out[:, dx:], z], axis=1) if dx > 0
               else jnp.concatenate([z, out[:, :dx]], axis=1))
    return out


def _sobel_xy(img: jnp.ndarray):
    """Both Sobel gradients via separable shift-adds (elementwise work XLA
    fuses, instead of two 1-channel convolutions). Matches _conv2_same(img,
    _SOBEL_X/_SOBEL_Y) with zero boundaries."""
    # smooth [1,2,1] along y then central difference along x (and vice
    # versa); convolution flips the kernel, hence +shift = -offset
    sy = _shift(img, -1, 0) + 2.0 * img + _shift(img, 1, 0)
    sx = _shift(img, 0, -1) + 2.0 * img + _shift(img, 0, 1)
    gx = (_shift(sy, 0, -1) - _shift(sy, 0, 1)) / 8.0
    gy = (_shift(sx, -1, 0) - _shift(sx, 1, 0)) / 8.0
    return gx, gy


@partial(jax.jit, static_argnames=("tiles", "n_bins"))
def clahe(img: jnp.ndarray, clip_limit: float = 2.0, tiles: tuple = (8, 8),
          n_bins: int = 256) -> jnp.ndarray:
    """Contrast-limited adaptive histogram equalization (the reference's
    cv::createCLAHE(2.0) preprocessing, visual_odometry.cpp:31,97-100).

    Per-tile histograms -> clipped + redistributed -> CDF LUTs -> bilinear
    blend of the 4 surrounding tile LUTs per pixel. All scatter/gather."""
    h, w = img.shape
    ty, tx = tiles
    th = -(-h // ty)
    tw = -(-w // tx)
    pad_img = jnp.pad(img, ((0, ty * th - h), (0, tx * tw - w)), mode="edge")
    bins = jnp.clip((pad_img * (n_bins - 1)).astype(jnp.int32), 0, n_bins - 1)
    tile_r = jnp.arange(ty * th) // th
    tile_c = jnp.arange(tx * tw) // tw
    tid = tile_r[:, None] * tx + tile_c[None, :]
    flat_idx = tid * n_bins + bins
    hist = jnp.zeros((ty * tx * n_bins,), jnp.float32).at[
        flat_idx.reshape(-1)].add(1.0)
    hist = hist.reshape(ty * tx, n_bins)
    n_pix = th * tw
    clip = clip_limit * n_pix / n_bins
    excess = jnp.sum(jnp.maximum(hist - clip, 0.0), axis=1, keepdims=True)
    hist = jnp.minimum(hist, clip) + excess / n_bins
    cdf = jnp.cumsum(hist, axis=1)
    cdf_min = cdf[:, :1]
    lut = (cdf - cdf_min) / jnp.maximum(n_pix - cdf_min, 1.0)  # [T, n_bins]
    lut = lut.reshape(ty, tx, n_bins)

    # bilinear interpolation between tile centers
    yy = jnp.arange(h, dtype=jnp.float32)
    xx = jnp.arange(w, dtype=jnp.float32)
    fy = jnp.clip((yy - th / 2.0) / th, 0.0, ty - 1.0)
    fx = jnp.clip((xx - tw / 2.0) / tw, 0.0, tx - 1.0)
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ty - 2) if ty > 1 else jnp.zeros_like(fy, jnp.int32)
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, tx - 2) if tx > 1 else jnp.zeros_like(fx, jnp.int32)
    wy = (fy - y0) if ty > 1 else jnp.zeros_like(fy)
    wx = (fx - x0) if tx > 1 else jnp.zeros_like(fx)
    b = bins[:h, :w]
    y0g = y0[:, None]
    x0g = x0[None, :]
    v00 = lut[y0g, x0g, b]
    v01 = lut[y0g, jnp.minimum(x0g + 1, tx - 1), b]
    v10 = lut[jnp.minimum(y0g + 1, ty - 1), x0g, b]
    v11 = lut[jnp.minimum(y0g + 1, ty - 1), jnp.minimum(x0g + 1, tx - 1), b]
    wyg = wy[:, None]
    wxg = wx[None, :]
    out = (v00 * (1 - wyg) * (1 - wxg) + v01 * (1 - wyg) * wxg
           + v10 * wyg * (1 - wxg) + v11 * wyg * wxg)
    return jnp.clip(out, 0.0, 1.0)


def bucket_nms(xy, score, mask, img_w, img_h, bucket_w: int = 100,
               bucket_h: int = 100, max_total: int = 400):
    """Bucketed keypoint NMS (reference keyPointsNMS, image_util.cpp:
    100-150): cap keypoints per bucket_w x bucket_h cell, then keep the
    strongest max_total overall. Returns an updated mask."""
    nx = -(-img_w // bucket_w)
    ny = -(-img_h // bucket_h)
    per_bucket = max(1, max_total // (nx * ny))
    bid = (xy[:, 0] // bucket_w).astype(jnp.int32) + nx * (
        xy[:, 1] // bucket_h).astype(jnp.int32)
    bid = jnp.where(mask, bid, nx * ny)
    k = xy.shape[0]
    # rank within bucket by descending score: sort by (bucket, -score)
    order = jnp.lexsort((-score, bid))
    bid_s = bid[order]
    counts = jnp.bincount(bid_s, length=nx * ny + 1)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    rank = jnp.arange(k) - starts[jnp.minimum(bid_s, nx * ny - 1)]
    keep_sorted = (rank < per_bucket) & (bid_s < nx * ny)
    keep = jnp.zeros((k,), bool).at[order].set(keep_sorted)
    keep = keep & mask
    # global cap
    s = jnp.where(keep, score, -jnp.inf)
    kth = jax.lax.top_k(s, min(max_total, k))[0][-1]
    return keep & (s >= kth)


def _box_filter(img: jnp.ndarray, size: int) -> jnp.ndarray:
    """Unnormalized box sum via two cumsum passes (separable, O(HW))."""
    pad = size // 2
    cs = jnp.cumsum(jnp.pad(img, ((0, 0), (pad + 1, pad)), mode="edge"), axis=1)
    h = cs[:, size:] - cs[:, :-size]
    cs2 = jnp.cumsum(jnp.pad(h, ((pad + 1, pad), (0, 0)), mode="edge"), axis=0)
    return cs2[size:, :] - cs2[:-size, :]


_SOBEL_X = jnp.asarray([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], jnp.float32) / 8.0
_SOBEL_Y = _SOBEL_X.T


def min_eig_response(img: jnp.ndarray, block: int) -> jnp.ndarray:
    """Shi-Tomasi min-eigenvalue of the block-averaged structure tensor."""
    gx, gy = _sobel_xy(img)
    a = _box_filter(gx * gx, block)
    b = _box_filter(gx * gy, block)
    c = _box_filter(gy * gy, block)
    tr = 0.5 * (a + c)
    det_term = jnp.sqrt(jnp.maximum(0.25 * (a - c) ** 2 + b * b, 0.0))
    return tr - det_term


def harris_response(img: jnp.ndarray, block: int, k: float = 0.04) -> jnp.ndarray:
    """Harris corner measure det(M) - k tr(M)^2 (cv::ORB HARRIS_SCORE)."""
    gx, gy = _sobel_xy(img)
    a = _box_filter(gx * gx, block)
    b = _box_filter(gx * gy, block)
    c = _box_filter(gy * gy, block)
    return a * c - b * b - k * (a + c) ** 2


def _gauss_kernel_1d(sigma: float) -> jnp.ndarray:
    r = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return jnp.asarray(k / k.sum())


def gauss_blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur with a static kernel (radius = 3 sigma)."""
    k = _gauss_kernel_1d(sigma)
    h = jax.scipy.signal.convolve(img, k[None, :], mode="same")
    return jax.scipy.signal.convolve(h, k[:, None], mode="same")


def dog_response(img: jnp.ndarray, base_sigma: float = 1.6,
                 n_scales: int = 4) -> jnp.ndarray:
    """SIFT-style difference-of-Gaussians scale-space extremum response
    (reference SIFT DetectorType, image_util.cpp:60-63): |DoG| at pixels
    that are 3x3 spatial local maxima of |DoG| AND exceed the adjacent DoG
    scales, maxed over the scale axis."""
    sigmas = [base_sigma * (2.0 ** (i / 2.0)) for i in range(n_scales)]
    blurs = [gauss_blur(img, s) for s in sigmas]
    dogs = jnp.stack([blurs[i + 1] - blurs[i]
                      for i in range(n_scales - 1)])  # [S-1, H, W]
    mag = jnp.abs(dogs)
    pooled = jax.lax.reduce_window(mag, -jnp.inf, jax.lax.max,
                                   (1, 3, 3), (1, 1, 1), "SAME")
    spatial_peak = mag >= pooled
    lo = jnp.concatenate([jnp.full_like(mag[:1], -jnp.inf), mag[:-1]])
    hi = jnp.concatenate([mag[1:], jnp.full_like(mag[:1], -jnp.inf)])
    scale_peak = (mag >= lo) & (mag >= hi)
    resp = jnp.where(spatial_peak & scale_peak, mag, 0.0)
    return jnp.max(resp, axis=0)


def hessian_response(img: jnp.ndarray,
                     sigmas: tuple = (1.6, 3.2, 6.4)) -> jnp.ndarray:
    """Scale-normalized determinant of Hessian, maxed over scales (the blob
    measure AKAZE thresholds; reference AKAZE DetectorType,
    image_util.cpp:56-59 — the nonlinear-diffusion scale space is replaced
    by Gaussian scales, which XLA fuses into a few convs)."""
    out = None
    for s in sigmas:
        L = gauss_blur(img, s)
        lx, ly = _sobel_xy(L)
        lxx, lxy = _sobel_xy(lx)
        _, lyy = _sobel_xy(ly)
        det = (s * s) ** 2 * (lxx * lyy - lxy * lxy)
        out = det if out is None else jnp.maximum(out, det)
    return out


def _mean_pool2(img: jnp.ndarray) -> jnp.ndarray:
    h, w = img.shape
    return img[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2).mean(
        axis=(1, 3))


def multiscale_fast_response(img: jnp.ndarray, threshold: float,
                             n_levels: int = 3) -> jnp.ndarray:
    """BRISK stand-in (reference image_util.cpp:48-51): FAST over a
    mean-pooled pyramid; coarse responses are nearest-upsampled and maxed
    so keypoint coordinates stay full-resolution."""
    resp = fast_response(img, threshold)
    level = img
    for lvl in range(1, n_levels):
        level = _mean_pool2(level)
        r = fast_response(level, threshold)
        f = 2 ** lvl
        up = jnp.repeat(jnp.repeat(r, f, axis=0), f, axis=1)
        up = up[: img.shape[0], : img.shape[1]]
        up = jnp.pad(up, ((0, img.shape[0] - up.shape[0]),
                          (0, img.shape[1] - up.shape[1])))
        resp = jnp.maximum(resp, up)
    return resp


# FAST-16 Bresenham circle offsets (dy, dx)
_FAST_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def fast_response(img: jnp.ndarray, threshold: float, arc: int = 9) -> jnp.ndarray:
    """FAST corner response (image_util.cpp:37-40 alternative detector):
    a pixel is a corner when >= `arc` contiguous circle pixels are all
    brighter or all darker by `threshold`; the response is the summed
    absolute excess (cv::FAST score flavor)."""
    pads = jnp.pad(img, 3, mode="edge")
    h, w = img.shape
    ring = jnp.stack([
        jax.lax.dynamic_slice(pads, (3 + dy, 3 + dx), (h, w))
        for dy, dx in _FAST_CIRCLE
    ])  # [16, H, W]
    brighter = ring > img[None] + threshold
    darker = ring < img[None] - threshold

    def max_run(mask):
        # longest circular run of True >= arc: AND of `arc` rolled copies
        acc = jnp.ones_like(mask[0], bool)[None]
        out = jnp.zeros(img.shape, bool)
        doubled = jnp.concatenate([mask, mask], axis=0)
        for s in range(16):
            window = doubled[s : s + arc]
            out = out | jnp.all(window, axis=0)
        return out

    is_corner = max_run(brighter) | max_run(darker)
    excess = jnp.sum(
        jnp.where(brighter | darker, jnp.abs(ring - img[None]) - threshold, 0.0),
        axis=0,
    )
    return jnp.where(is_corner, excess, 0.0)


@partial(jax.jit, static_argnames=("cfg",))
def detect_keypoints(img: jnp.ndarray, cfg: VisualOdometryConfig):
    """Returns (xy [K, 2] float32 pixel coords, score [K], mask [K]).
    K = cfg.max_keypoints."""
    if cfg.detector == "fast":
        resp = fast_response(img, cfg.fast_threshold)
    elif cfg.detector == "orb":
        # cv::ORB: FAST candidates ranked by the Harris measure (:41-47)
        gate = fast_response(img, cfg.fast_threshold) > 0.0
        resp = jnp.where(gate, harris_response(img, cfg.shi_tomasi_block), 0.0)
    elif cfg.detector == "brisk":
        resp = multiscale_fast_response(img, cfg.fast_threshold)
    elif cfg.detector == "sift":
        resp = dog_response(img)
    elif cfg.detector == "akaze":
        resp = hessian_response(img)
    else:
        resp = min_eig_response(img, cfg.shi_tomasi_block)
    h, w = resp.shape
    # exclude borders (gradient + descriptor support)
    m = cfg.descriptor_patch
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    interior = (yy >= m) & (yy < h - m) & (xx >= m) & (xx < w - m)
    resp = jnp.where(interior, resp, -jnp.inf)

    # quality gate relative to the global max (goodFeaturesToTrack semantics)
    thr = cfg.shi_tomasi_quality * jnp.max(resp)

    # min-distance NMS via maxpool: survive only at the local argmax in a
    # (2r+1)^2 window, r = ceil(min_distance)
    r = int(-(-cfg.shi_tomasi_min_distance // 1))
    win = 2 * r + 1
    pooled = jax.lax.reduce_window(
        resp, -jnp.inf, jax.lax.max, (win, win), (1, 1), "SAME"
    )
    is_peak = (resp >= pooled) & (resp > thr) & jnp.isfinite(resp)

    flat = jnp.where(is_peak.reshape(-1), resp.reshape(-1), -jnp.inf)
    # approx_max_k: exact top-k on GPUs and CPUs. Candidates are already
    # NMS'd peaks (a few thousand); where it is approximate, ~0.95 recall on
    # the strongest 2048 only swaps borderline corners.
    score, idx = jax.lax.approx_max_k(flat, cfg.max_keypoints)
    ky = (idx // w).astype(jnp.float32)
    kx = (idx % w).astype(jnp.float32)
    mask = jnp.isfinite(score)
    xy = jnp.stack([kx, ky], axis=-1)
    if getattr(cfg, "subpixel", False):
        # quadratic peak interpolation on the response surface: integer
        # corner grids cost +-0.5 px quantization noise on every residual
        iy = (idx // w).astype(jnp.int32)
        ix = (idx % w).astype(jnp.int32)
        rs = jnp.where(jnp.isfinite(resp), resp, 0.0)

        def at(dy, dx):
            return rs[jnp.clip(iy + dy, 0, h - 1), jnp.clip(ix + dx, 0, w - 1)]

        gx = 0.5 * (at(0, 1) - at(0, -1))
        gy = 0.5 * (at(1, 0) - at(-1, 0))
        hxx = at(0, 1) - 2.0 * at(0, 0) + at(0, -1)
        hyy = at(1, 0) - 2.0 * at(0, 0) + at(-1, 0)
        hxy = 0.25 * (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1))
        det = hxx * hyy - hxy * hxy
        ox = jnp.where(jnp.abs(det) > 1e-12, -(hyy * gx - hxy * gy) / det, 0.0)
        oy = jnp.where(jnp.abs(det) > 1e-12, -(hxx * gy - hxy * gx) / det, 0.0)
        off = jnp.clip(jnp.stack([ox, oy], axis=-1), -0.5, 0.5)
        xy = xy + off
    return jnp.where(mask[:, None], xy, 0.0), jnp.where(mask, score, 0.0), mask


@partial(jax.jit, static_argnames=("cfg",))
def describe_keypoints(img: jnp.ndarray, xy: jnp.ndarray, cfg: VisualOdometryConfig):
    """Unit-norm descriptors [K, D]; rows are directly matmul-matchable.
    descriptor="zncc": zero-normalized P*P patch; "orb": oriented BRIEF
    bits as +-1/sqrt(n)."""
    if getattr(cfg, "descriptor", "zncc") == "orb":
        return orb_describe(img, xy, cfg)
    # All K*p*p patch pixels in ONE flat gather (faster on an H100 than K
    # vmapped dynamic_slices); windows are clamped inside the image exactly
    # as dynamic_slice clamps its start.
    p = cfg.descriptor_patch
    H, W = img.shape
    y0 = jnp.clip(xy[:, 1].astype(jnp.int32) - p // 2, 0, H - p)
    x0 = jnp.clip(xy[:, 0].astype(jnp.int32) - p // 2, 0, W - p)
    offs = jnp.arange(p)
    idx = ((y0[:, None, None] + offs[None, :, None]) * W
           + x0[:, None, None] + offs[None, None, :])  # [K, p, p]
    patch = img.reshape(-1)[idx.reshape(xy.shape[0], p * p)]
    patch = patch - jnp.mean(patch, axis=1, keepdims=True)
    n = jnp.linalg.norm(patch, axis=1, keepdims=True)
    return patch / jnp.maximum(n, 1e-6)


# ---- oriented BRIEF (the reference's ORB descriptor, image_util.cpp:166) --

_ORB_PATCH = 31  # cv::ORB patch size


def _brief_pairs(n_bits: int, patch: int):
    """Static BRIEF-II sampling pattern: Gaussian(0, patch/5) point pairs
    (the distribution cv::ORB's learned pattern was trained from)."""
    rng = np.random.default_rng(0x16833)
    lim = patch // 2 - 1
    pts = np.clip(rng.normal(0.0, patch / 5.0, (2, n_bits, 2)),
                  -lim, lim).astype(np.float32)
    return jnp.asarray(pts[0]), jnp.asarray(pts[1])  # each [n_bits, 2] (x,y)


def _ic_angle_grids(patch: int):
    r = patch // 2
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1].astype(np.float32)
    circ = (xs * xs + ys * ys <= r * r).astype(np.float32)
    return jnp.asarray(xs * circ), jnp.asarray(ys * circ)


@partial(jax.jit, static_argnames=("cfg", "n_bits"))
def orb_describe(img: jnp.ndarray, xy: jnp.ndarray,
                 cfg: VisualOdometryConfig, n_bits: int = 256):
    """Oriented BRIEF-256 (rBRIEF): per keypoint, intensity-centroid
    orientation over a radius-15 disc (cv::ORB IC_Angle), BRIEF point pairs
    rotated by that angle, each bit I(a) > I(b) stored as +-1/sqrt(n).

    Stored this way, binary matching is a matrix product: for unit rows
    sim = 1 - 2*ham/n_bits, so the similarity matmul in match_descriptors
    ranks candidates exactly as Hamming distance does (image_util.cpp:237
    BFMatcher(NORM_HAMMING))."""
    p = _ORB_PATCH
    ax, ay = _brief_pairs(n_bits, p)
    gx, gy = _ic_angle_grids(p)
    half = p // 2
    scale = 1.0 / float(np.sqrt(n_bits))

    def one(pt):
        x0 = pt[0].astype(jnp.int32) - half
        y0 = pt[1].astype(jnp.int32) - half
        patch = jax.lax.dynamic_slice(img, (y0, x0), (p, p))
        m10 = jnp.sum(patch * gx)
        m01 = jnp.sum(patch * gy)
        theta = jnp.arctan2(m01, m10)
        c, s = jnp.cos(theta), jnp.sin(theta)

        def sample(offs):  # offs [n_bits, 2] (x, y) -> intensities
            rx = c * offs[:, 0] - s * offs[:, 1]
            ry = s * offs[:, 0] + c * offs[:, 1]
            ix = jnp.clip(jnp.round(rx).astype(jnp.int32) + half, 0, p - 1)
            iy = jnp.clip(jnp.round(ry).astype(jnp.int32) + half, 0, p - 1)
            return patch[iy, ix]

        bits = sample(ax) > sample(ay)
        return jnp.where(bits, scale, -scale)

    return jax.vmap(one)(xy)


@partial(jax.jit, static_argnames=("ratio", "matcher", "select"))
def match_descriptors(
    desc0: jnp.ndarray, mask0: jnp.ndarray,
    desc1: jnp.ndarray, mask1: jnp.ndarray,
    ratio: float = 0.8,
    matcher: str = "bf",
    select: str = "knn",
):
    """Descriptor matching (matchDescriptors, image_util.cpp:214-296) on one
    [K0, K1] similarity matmul. matcher: "bf" = exact top-k (BFMatcher);
    "flann" = lax.approx_max_k (the FLANN analogue, image_util.cpp:240-249:
    approximate where the platform has an approximate top-k, exact on GPUs
    and CPUs).
    select: "knn" = KNN(k=2) + ratio test (:270-283); "nn" = best match
    only (:264-268). Returns (idx1 [K0], valid [K0])."""
    sim = jnp.dot(desc0, desc1.T, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    d = jnp.sqrt(jnp.maximum(2.0 - 2.0 * sim, 0.0))
    d = jnp.where(mask1[None, :], d, jnp.inf)
    if matcher == "flann":
        nd, ni = jax.lax.approx_max_k(-d, 2)
    else:
        nd, ni = jax.lax.top_k(-d, 2)
    d1, d2 = -nd[:, 0], -nd[:, 1]
    if select == "nn":
        valid = mask0 & jnp.isfinite(d1)
    else:
        valid = mask0 & jnp.isfinite(d1) & (d1 < ratio * d2)
    return ni[:, 0], valid

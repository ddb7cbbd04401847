"""Typed configuration tree.

Replaces the reference's two-layer ROS parameter system:
- LOAM algorithm params (reference src/lidar_odometry_mapping/launch/
  loam_velodyne_HDL_64_kitti.launch:3-16),
- pipeline flags (reference src/vloam_main/launch/vloam_main.launch:4-16),
plus the numeric constants hard-coded in the reference sources, and the
static shape caps the fixed-shape design needs (every ragged structure in
the reference becomes a padded tensor + mask here).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class LidarProfile:
    """Sensor geometry (reference scan_registration.cpp:195-226)."""

    name: str = "HDL-64"
    n_scans: int = 64
    minimum_range: float = 5.0  # loam_velodyne_HDL_64_kitti.launch:14
    scan_period: float = 0.1  # scan_registration.h scanPeriod
    # Static shape caps: points per ring after padding, total input cap.
    max_points: int = 131072
    ring_capacity: int = 2560


HDL64_KITTI = LidarProfile()
HDL32 = LidarProfile(name="HDL-32", n_scans=32, minimum_range=0.1)
VLP16 = LidarProfile(name="VLP-16", n_scans=16, minimum_range=0.3)


@dataclass(frozen=True)
class ScanRegistrationConfig:
    """Feature extraction (reference scan_registration.cpp:288-440)."""

    n_sectors: int = 6
    curvature_threshold: float = 0.1  # sharp/flat split (":332,:385")
    max_sharp_per_sector: int = 2
    max_less_sharp_per_sector: int = 20
    max_flat_per_sector: int = 4
    neighbor_suppress_gap_sq: float = 0.05  # ":358"
    less_flat_leaf: float = 0.2  # VoxelGrid leaf (":436")
    # True (default) is the reference-exact sequential sector order
    # (scan_registration.cpp:312-440): one flat loop of 144 pick rounds,
    # compiled for a CUDA device as one Triton program per ring
    # (scan_registration._select_ring_kernel). False runs the 6 sectors'
    # k-th picks simultaneously (6x fewer serialized pick rounds; differs
    # only when a suppression window crosses a sector boundary within one
    # round, <1% of labels —
    # test_batched_sector_selection_near_equals_strict).
    strict_sector_order: bool = True
    # Static caps for the padded feature tensors. sharp/flat are EXACT
    # upper bounds (n_scans * n_sectors * max picks: 64*6*2=768 sharp,
    # 64*6*4=1536 flat — the selection can never overflow them), so the
    # association query count pays zero padding. less_sharp's per-ring
    # slice (8192/64 = 128) is 4 short of the 132 theoretical max — a
    # rare-frame tail truncation, kept for the 128-lane alignment.
    sharp_cap: int = 768
    less_sharp_cap: int = 8192
    flat_cap: int = 1536
    less_flat_cap: int = 32768


@dataclass(frozen=True)
class LaserOdometryConfig:
    """Frame-to-frame scan matching (reference laser_odometry.cpp)."""

    outer_rounds: int = 2  # ":211"
    gn_iterations: int = 4  # ceres max_num_iterations (":460")
    distance_sq_threshold: float = 25.0  # laser_odometry.h:94
    nearby_scan: float = 2.5  # laser_odometry.h:95
    huber_delta: float = 0.1  # ":217"
    distortion: bool = False  # laser_odometry.h:90 (KITTI clouds pre-deskewed)
    mapping_skip_frame: int = 1  # launch:6
    # Warn when corner+surf correspondences drop below this after the final
    # round (reference "less correspondence!" laser_odometry.cpp:452-455).
    min_correspondences: int = 10


@dataclass(frozen=True)
class LaserMappingConfig:
    """Scan-to-map refinement (reference laser_mapping.cpp)."""

    cube_size: float = 50.0  # laser_mapping.h:110-114
    cube_width: int = 21
    cube_height: int = 21
    cube_depth: int = 11
    line_resolution: float = 0.4  # launch:15
    plane_resolution: float = 0.8  # launch:16
    outer_rounds: int = 2  # ":458"
    gn_iterations: int = 4  # ":612"
    huber_delta: float = 0.1
    neighbor_radius_sq: float = 1.0  # 5-NN gate (":479,:547")
    eigen_ratio: float = 3.0  # line test λ2 > 3 λ1 (":506")
    plane_fit_tolerance: float = 0.2  # ":568"
    edge_half_length: float = 0.1  # synthetic edge points (":510-511")
    min_corner_map_points: int = 10  # ":448"
    min_surf_map_points: int = 50
    # Static caps for the per-frame voxel-downsampled stacks (:432-440),
    # sized ~1.3-1.5x the occupancy measured on dense HDL-64 frames
    # (corner ~1.6k, surf ~3.9k): every mapping gather/knn/insert costs
    # O(cap), so slack is paid for in device time; overflow drops the densest
    # frames' tail, which the reference also bounds via its cube
    # capacities.
    corner_stack_cap: int = 2048
    surf_stack_cap: int = 6144
    knn: int = 5
    # publish the accumulated map every N mapped frames (reference
    # map_pub_number, loam_velodyne_HDL_64_kitti.launch + the publisher at
    # laser_mapping.cpp:778-793); consumed by the engines' map_callback
    map_pub_number: int = 20
    # Incremental hashed cell-slab map (gridmap.py): the map's storage IS
    # the k-NN structure; nothing is rebuilt per frame. Cells must be
    # integer multiples of the matching resolution (voxel dedup at insert)
    # and >= 2 * sqrt(neighbor_radius_sq) (8-probe query exactness).
    # Bucket capacities bound per-cell density; overfull buckets drop new
    # points, as the reference drops points beyond its cube bounds.
    map_n_buckets: int = 1 << 17
    corner_cell: float = 2.0
    surf_cell: float = 2.4
    corner_bucket_cap: int = 32
    surf_bucket_cap: int = 16


@dataclass(frozen=True)
class VisualOdometryConfig:
    """DEMO-style depth-enhanced VO (reference visual_odometry.cpp,
    image_util.cpp, point_cloud_util.cpp)."""

    img_width: int = 1242
    img_height: int = 375
    # image_util.h DetectorType (:16-23): ShiTomasi|FAST|ORB|BRISK|SIFT|AKAZE
    detector: str = "shi_tomasi"  # | fast | orb | brisk | sift | akaze
    # image_util.h DescriptorType (:25-31): zncc (patch correlation) | orb
    # (oriented BRIEF-256, Hamming-via-matmul)
    descriptor: str = "zncc"
    matcher: str = "bf"  # image_util.h MatcherType: bf (exact) | flann (approx_max_k)
    match_select: str = "knn"  # image_util.h SelectType: knn (ratio test) | nn
    fast_threshold: float = 100.0 / 255.0  # image_util.cpp:39 (uint8 scale)
    # reference caps at 1024 corners, quality 0.03 (image_util.cpp:20,:22);
    # 2048 @ 0.01 measured 17->14 mm f2f error (scripts/diag_vo.py)
    max_keypoints: int = 2048
    shi_tomasi_block: int = 5  # image_util.cpp:15
    shi_tomasi_quality: float = 0.01
    shi_tomasi_min_distance: float = 7.5  # block*1.5 (image_util.cpp:18)
    match_ratio: float = 0.8  # KNN ratio test (image_util.cpp:278)
    # ZNCC patch side; 24 px measured more
    # discriminative than 16 (f2f err 21->17 mm, scripts/diag_vo.py)
    descriptor_patch: int = 24
    optical_flow_match: bool = False  # vloam_main.launch:10
    flow_window: int = 15  # image_util.cpp:365 cv::Size(15,15)
    flow_levels: int = 3  # maxLevel=2 -> 3 pyramid levels
    flow_iterations: int = 10
    remove_VO_outlier: float = 100.0  # px gate, vloam_main.launch:6
    reset_VO_to_identity: bool = False  # vloam_main.launch:5
    clahe: bool = False  # vloam_main.launch:8
    keypoint_nms: bool = False  # vloam_main.launch:7 (bucketed NMS, <=400)
    nms_bucket: int = 100  # image_util.h keyPointsNMS defaults
    nms_max_total: int = 400
    downsample_grid_size: int = 5  # point_cloud_util.h:26
    depth_search_radius: int = 2  # point_cloud_util.h:35 queryDepth r
    min_depth_neighbors: int = 10  # point_cloud_util.cpp:337
    # reject depth queries whose 3 nearest buckets span more than this many
    # meters (depth-discontinuity guard; 0 = reference behavior, which
    # blends across object boundaries and biases the 3D-2D residuals)
    max_depth_spread: float = 0.0
    min_depth: float = 0.1  # projection front-filter (":157")
    # reference uses Huber(0.1) (visual_odometry.cpp:258); 0.05 downweights
    # the ~30% mismatch tail harder and cut f2f error 27->21 mm
    huber_delta: float = 0.05
    # ceres allows 100 (":67"); LM converges long before. 24 measured
    # metric-identical to 32 on the synthetic eval (VO t_rel/ATE unchanged
    # to 3 digits) and saves 8 latency-chained LM rounds per frame.
    max_iterations: int = 24
    max_matches: int = 2048  # static residual cap
    # Minimum accepted matches for a VO solve to count as valid: with near
    # zero residuals the LM returns its seed, and in the chunked engine
    # that seed is the PREVIOUS VO estimate — an unchecked bad solve would
    # recycle itself into the next frame's seed and poison the LO prior
    # (observed at frame 60 of the synthetic eval: 2 matches -> t_vo wild
    # -> LO diverged). Below the gate the frame's VO is rejected: LO falls
    # back to its own f2f continuity.
    min_vo_matches: int = 20
    # Low-texture degrade-don't-die (the KITTI seq-01 regime, reference
    # TABLE I row 01: VO 50.5% t_rel but still a finite trajectory). When
    # descriptor matching collapses below min_vo_matches, (a) re-match the
    # frame pair by pyramidal LK flow (the reference's alternative matcher,
    # image_util.cpp:351-372) and solve on the flow pairs, and (b) if the
    # solve still fails the gate, export the LO-derived seed as the VO
    # motion (the reference seeds VO from LO, visual_odometry.cpp:269-281;
    # with zero usable residuals its solve returns that seed) instead of
    # freezing the stream at identity. The min_vo_matches gate still
    # protects LO/MO seeding either way. Off by default: the fused engine
    # runs the flow pass every frame whether or not it is needed.
    lowtex_fallback: bool = False
    # Polar-ingest only: fraction of the range image's azimuth columns
    # (centered on the forward direction) decoded for the camera depth
    # grid. The camera's half-FOV is ~41 deg on KITTI (atan((W/2)/fx)),
    # so the default 1/3 (+-60 deg) keeps every projectable return while
    # the depth-grid scatter processes 3x fewer points.
    # Set to 1.0 for the full sweep (e.g. unusual camera yaw mounting).
    polar_fov_fraction: float = 1.0 / 3.0
    # True adds quadratic-peak subpixel corner refinement and keeps
    # subpixel coordinates in the residuals (depth bucket lookup still
    # truncates). False preserves the reference's int-truncation quirk
    # (visual_odometry.cpp:283-307). Integer corners cost +-0.5 px
    # quantization on every residual: f2f error 36->27 mm measured.
    subpixel: bool = True


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level orchestration flags (reference vloam_main.launch)."""

    detach_VO_LO: bool = True  # launch:4 default
    save_traj: bool = True
    verbose_level: int = 0
    lidar: LidarProfile = field(default_factory=lambda: HDL64_KITTI)
    scanreg: ScanRegistrationConfig = field(default_factory=ScanRegistrationConfig)
    lo: LaserOdometryConfig = field(default_factory=LaserOdometryConfig)
    mapping: LaserMappingConfig = field(default_factory=LaserMappingConfig)
    vo: VisualOdometryConfig = field(default_factory=VisualOdometryConfig)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def kitti_hdl64() -> PipelineConfig:
    """The KITTI eval profile used for all baseline numbers."""
    return PipelineConfig()


def reference_exact() -> PipelineConfig:
    """KITTI profile with every accuracy-motivated default divergence rolled
    back to the reference's values, for one-liner parity comparisons against
    the upstream framework. The defaults this undoes (all measured
    improvements, scripts/diag_vo.py):

    - vo.max_keypoints 2048 -> 1024          (image_util.cpp:20)
    - vo.shi_tomasi_quality 0.01 -> 0.03     (image_util.cpp:22)
    - vo.huber_delta 0.05 -> 0.1             (visual_odometry.cpp:258)
    - vo.descriptor_patch 24 -> 16           (nearest ZNCC analogue of ORB's
                                              31 px oriented-BRIEF window)
    - vo.subpixel True -> False              (int-truncation quirk,
                                              visual_odometry.cpp:283-307)
    - vo.max_depth_spread disabled (0.0 is already the reference behavior)

    scanreg.strict_sector_order already defaults to True (reference-exact
    sequential sector selection), so no scanreg override is needed."""
    return PipelineConfig(
        vo=VisualOdometryConfig(
            max_keypoints=1024,
            shi_tomasi_quality=0.03,
            huber_delta=0.1,
            descriptor_patch=16,
            subpixel=False,
        ),
    )


def tiny_test_profile() -> PipelineConfig:
    """Small shapes for fast unit tests / CPU meshes."""
    return PipelineConfig(
        lidar=LidarProfile(name="tiny", n_scans=16, minimum_range=0.5,
                           max_points=8192, ring_capacity=512),
        scanreg=ScanRegistrationConfig(sharp_cap=256, less_sharp_cap=2048,
                                       flat_cap=512, less_flat_cap=4096),
        mapping=LaserMappingConfig(cube_width=11, cube_height=11, cube_depth=5,
                                   map_n_buckets=1 << 13,
                                   corner_bucket_cap=16, surf_bucket_cap=16,
                                   corner_stack_cap=1024, surf_stack_cap=2048),
        vo=VisualOdometryConfig(img_width=320, img_height=96, max_keypoints=256,
                                max_matches=512),
    )

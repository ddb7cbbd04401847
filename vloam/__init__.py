"""vloam — a visual-LiDAR odometry and mapping (VLOAM) engine in JAX.

Re-implements the capabilities of the VLOAM-CMU-16833 reference (ROS/C++/
Ceres/PCL/OpenCV) as an idiomatic JAX/XLA framework running on NVIDIA GPUs:

- LOAM scan registration as fixed-shape vectorized kernels,
- KD-tree correspondence search as exact per-ring reductions / grid top-k,
- Ceres auto-diff LM as batched Huber-IRLS Levenberg-Marquardt in jit,
- the voxel-cube map + KD-tree + per-cube voxel filter as ONE incremental
  hashed cell-slab grid (the map's storage layout is the k-NN index),
- visual odometry (DEMO residuals) with JAX feature detection + LK flow,
- multi-device scaling via sharded normal equations over jax.sharding meshes.
"""

__version__ = "0.1.0"

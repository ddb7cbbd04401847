"""Trajectory visualization (reference scripts/plotTrajectory.py:1-13).

Renders the VO/LO/MO trajectories (KITTI 3x4 pose files or arrays) to a
figure — the matplotlib stand-in for the rviz path displays.
"""

from __future__ import annotations

import numpy as np


def plot_trajectories(trajs: dict[str, np.ndarray], out_path: str | None = None,
                      title: str = "vloam trajectories"):
    """trajs: name -> [N, 3, 4] (or [N, 12]) pose arrays."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_xy, ax_z) = plt.subplots(1, 2, figsize=(12, 5))
    for name, poses in trajs.items():
        poses = np.asarray(poses)
        if poses.ndim == 2:
            poses = poses.reshape(-1, 3, 4)
        t = poses[:, :, 3]
        # KITTI camera frame: x right, y down, z forward -> plot z vs x
        ax_xy.plot(t[:, 0], t[:, 2], label=name)
        ax_z.plot(t[:, 1], label=name)
    ax_xy.set_xlabel("x [m]")
    ax_xy.set_ylabel("z [m]")
    ax_xy.axis("equal")
    ax_xy.legend()
    ax_xy.set_title(title)
    ax_z.set_xlabel("frame")
    ax_z.set_ylabel("y (height) [m]")
    ax_z.legend()
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
    return fig


def plot_pose_files(paths: dict[str, str], out_path: str | None = None):
    from .kitti_metrics import load_kitti_poses

    return plot_trajectories(
        {name: load_kitti_poses(p)[:, :3, :] for name, p in paths.items()},
        out_path=out_path,
    )

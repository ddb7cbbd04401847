"""Quick lidar-only accuracy check on cached synthetic frames (bisect aid).

Runs the fused LOAM path over the same 100-frame drive as eval_synthetic.py
(frames come from the checkout's .cache/synth, so no generation cost) and prints
LO/MO ATE. Used to bisect accuracy regressions; not part of CI.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from eval_synthetic import build_frames
from vloam.config import kitti_hdl64
from vloam.eval.kitti_metrics import kitti_metrics
from vloam.pipeline import run_sequence_fused
from vloam.runtime.cache import enable_compile_cache


def main(n_frames=100):
    enable_compile_cache()
    cfg = kitti_hdl64()
    calib, frames, gt = build_frames(n_frames, with_cam=False, cfg=cfg)
    t0 = time.time()
    res = run_sequence_fused(cfg, calib, iter(frames), lidar_only=True,
                             chunk=10)
    wall = time.time() - t0
    for which in ("LO", "MO"):
        m = kitti_metrics(gt, res[which], step=1)
        print(which, json.dumps(m), flush=True)
    print(f"{res['fps']:.1f} fps (wall {wall:.1f}s)")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 100)

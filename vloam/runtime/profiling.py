"""Timing + observability utilities.

Replaces the reference's TicToc stopwatch (tic_toc.h:10-32), the
loam_verbose_level gated prints, and the >100 ms frame-budget watchdog
(lidar_odometry_mapping.cpp:150-153). Adds a jax.profiler trace context for
device-level profiling.
"""

from __future__ import annotations

import contextlib
import logging
import time

log = logging.getLogger("vloam")


class TicToc:
    def __init__(self):
        self.tic()

    def tic(self):
        self.t0 = time.perf_counter()

    def toc_ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1000.0


class Watchdog:
    """Frame-budget monitor: warns when a frame exceeds the budget."""

    def __init__(self, budget_ms: float = 100.0, verbose: bool = False):
        self.budget_ms = budget_ms
        self.verbose = verbose
        self.overruns = 0
        self.frames = 0

    def check(self, elapsed_ms: float) -> bool:
        self.frames += 1
        over = elapsed_ms > self.budget_ms
        if over:
            self.overruns += 1
            if self.verbose:
                log.warning("frame took %.1f ms (budget %.0f ms)",
                            elapsed_ms, self.budget_ms)
        return over


def fence(tree) -> None:
    """Block until every program producing `tree` has finished. All timing
    in this framework ends its window with this."""
    import jax

    jax.block_until_ready(tree)


def card_info() -> str:
    """The GPU's name and power limit as nvidia-smi reports them (one line
    per card, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"), read by a child
    process that does not touch JAX. Raises if nvidia-smi is missing or
    fails."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


@contextlib.contextmanager
def device_trace(out_dir: str):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def summarize_timings(stats: list[dict]) -> dict:
    """Mean per-stage ms over a run (skipping warmup frame 0/1 compiles)."""
    if not stats:
        return {}
    keys = set().union(*stats)
    body = stats[2:] if len(stats) > 4 else stats
    out = {}
    for k in sorted(keys):
        vals = [s[k] for s in body if k in s]
        if vals:
            out[k] = sum(vals) / len(vals)
    return out

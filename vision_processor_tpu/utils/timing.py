"""Profiling and tracing utilities.

JAX equivalents of the reference's OpenCL event profiling + printRuntimes
(reference src/opencl.cpp:94-101, src/main.cpp:363-366):

* ``StageTimer``    — per-stage wall times with block_until_ready fences,
                      printable like the per-kernel runtime dump.
* ``trace``         — context manager around jax.profiler for full XLA traces
                      viewable in TensorBoard/Perfetto.
* ``FrameStats``    — rolling frame-time statistics + overrun counting.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax

from .log import get_logger

log = get_logger(__name__)


class StageTimer:
    """Accumulates wall time per named stage, fencing device work."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            jax.block_until_ready(result)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def measure(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def print_runtimes(self) -> None:
        for name in self.totals:
            n = self.counts[name]
            log.info(
                "%-24s %8.3f ms avg over %d runs",
                name, 1e3 * self.totals[name] / max(n, 1), n,
            )

    def clear(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/vptpu-trace"):
    """XLA profiler trace around a block; open with TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", log_dir)


class FrameStats:
    """Rolling frame statistics + budget overrun counter."""

    def __init__(self, window: int = 256):
        self.window = window
        self.samples: list[float] = []
        self.overruns = 0
        self.frames = 0

    def add(self, frame_time: float, budget: float) -> bool:
        """Record one frame; returns True when the budget was overrun."""
        self.frames += 1
        self.samples.append(frame_time)
        if len(self.samples) > self.window:
            self.samples.pop(0)
        over = frame_time > budget
        if over:
            self.overruns += 1
        return over

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        ordered = sorted(self.samples)
        idx = min(int(len(ordered) * q / 100.0), len(ordered) - 1)
        return ordered[idx]

    def summary(self) -> str:
        return (
            f"frames={self.frames} p50={self.percentile(50) * 1e3:.2f}ms "
            f"p90={self.percentile(90) * 1e3:.2f}ms "
            f"p99={self.percentile(99) * 1e3:.2f}ms overruns={self.overruns}"
        )

"""Timing, benchmark and ray counters.

Counterpart of ``raytpu/utils/profiling.py`` (reference: source/Timer.{h,cpp}):
a frame clock with 1 Hz FPS windows, the N-sample FPS benchmark written in
the reference's four-line ``benchmark.txt`` format, and rays/s counters.

CUDA launches return before the card has finished, so a host clock around a
launch measures only the enqueue.  ``FrameTimer.tick`` is to be called after
the frame's result has reached the host (which waits for the card), and
``device_ms`` times on the card's own clock with CUDA events, and ``trace``
records a ``torch.profiler`` timeline (Chrome-trace JSON).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


class FrameTimer:
    """Frame clock with FPS windows, 1 s by default (reference:
    source/Timer.cpp:67-132)."""

    def __init__(self, fps_window: float = 1.0, elapsed_upper_bound: float | None = None):
        """``elapsed_upper_bound`` clamps each frame's ``elapsed``, so that
        one hitch (a kernel build) cannot fling the fly camera
        (reference: source/Timer.cpp:83-89 ForceElapsedUpperBound)."""
        self._window = fps_window
        self._upper = elapsed_upper_bound
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._last = self._start
        self.elapsed = 0.0
        self.total = 0.0
        self._frames_in_window = 0
        self._window_start = self._start
        self.fps = 0.0
        self.dfps = 0.0
        self._fps_ready = False

    def tick(self) -> None:
        now = time.perf_counter()
        self.elapsed = max(now - self._last, 0.0)
        if self._upper is not None and self.elapsed > self._upper:
            self.elapsed = self._upper
        self._last = now
        self.total = now - self._start
        self._frames_in_window += 1
        self._fps_ready = False
        w = now - self._window_start
        if w >= self._window:
            self.dfps = self._frames_in_window / w
            self.fps = self.dfps
            self._frames_in_window = 0
            self._window_start = now
            self._fps_ready = True

    @property
    def fps_window_closed(self) -> bool:
        return self._fps_ready


@dataclass
class Benchmark:
    """N-sample FPS benchmark (reference: source/Timer.cpp:44-65,103-130)."""

    num_samples: int = 10
    samples: list = field(default_factory=list)
    active: bool = False

    def start(self):
        self.samples = []
        self.active = True

    def record(self, dfps: float) -> bool:
        """Feed one FPS-window sample; True when the benchmark finishes."""
        if not self.active:
            return False
        self.samples.append(dfps)
        if len(self.samples) >= self.num_samples:
            self.active = False
            return True
        return False

    @property
    def high(self):
        return max(self.samples)

    @property
    def low(self):
        return min(self.samples)

    @property
    def avg(self):
        return sum(self.samples) / len(self.samples)

    def report(self) -> str:
        """Four lines, as benchmark.txt (reference: source/Timer.cpp:123-128)."""
        return (
            f"FPS BENCHMARK of {len(self.samples)} frames\n"
            f"HIGH: {self.high}\n"
            f"LOW: {self.low}\n"
            f"AVERAGE: {self.avg}\n"
        )

    def write(self, path: str = "benchmark.txt"):
        with open(path, "w") as f:
            f.write(self.report())


@dataclass
class RayStats:
    """Primary and shadow rays per second over the frames added."""

    primary_rays: int = 0
    shadow_rays: int = 0
    frames: int = 0
    seconds: float = 0.0

    def add_frame(self, width: int, height: int, num_lights: int, seconds: float,
                  shadows: bool = True):
        n = width * height
        self.primary_rays += n
        if shadows:
            self.shadow_rays += n * num_lights
        self.frames += 1
        self.seconds += seconds

    @property
    def primary_rays_per_s(self) -> float:
        return self.primary_rays / self.seconds if self.seconds else 0.0

    @property
    def total_rays_per_s(self) -> float:
        return (self.primary_rays + self.shadow_rays) / self.seconds if self.seconds else 0.0


def device_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn()`` on the current CUDA device,
    from CUDA events around ``iters`` back-to-back calls after ``warmup``."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms times on a CUDA device; none is available")
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` timeline of the block: CPU activity, and
    CUDA activity where a card is present.  On exit one Chrome-trace JSON
    (``trace_<pid>_<ns>.json``, open it in Perfetto or chrome://tracing) is
    written into ``log_dir`` and its path is kept in the yielded dict under
    ``"path"``.  CUPTI sees every launch of the process, so the kernels
    launched through ctypes appear under their own symbols.  Counterpart of
    raytpu's ``jax.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    out = {"path": None}
    with profile(activities=activities) as prof:
        yield out
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    out["path"] = path

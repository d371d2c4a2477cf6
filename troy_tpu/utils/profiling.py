"""Profiling helpers: wall-clock accumulation, timing windows, the GPU
check, and XLA trace capture.

The reference ships only benchmark Timer classes (reference:
test/timetest.cu:16-60, test/app/linear.cu:8-49); the richer tool is the
JAX profiler, whose traces show every fused executable on the device and
every collective. This module provides both: a Timer with the reference
harness's tic/toc shape, and a trace context manager writing a profile
that ``jax.profiler.ProfileData.from_file`` or TensorBoard can read.

Usage:
    from troy_tpu.utils.profiling import Timer, trace

    t = Timer()
    with t.measure("multiply"):
        out = ev.multiply(a, b)
    print(t.report())

    with trace("traces/pipeline"):
        run_pipeline()

    require_gpu(jax.devices())              # SystemExit on any other platform
    med, lo, hi = time_ms(lambda: ev.multiply(a, b))
    print(gpu_name_and_power())             # e.g. "NVIDIA H100 ..., 700.00 W"
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time
from typing import Dict, List, Optional


class Timer:
    """Accumulating wall-clock timer (timetest.cu Timer analogue).

    Blocks on JAX async dispatch only if the caller synchronizes; for
    device work, call ``block_until_ready`` inside the measured region."""

    def __init__(self):
        self._acc: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._tick_at = None

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._acc[name] = self._acc.get(name, 0.0) + dt
            self._count[name] = self._count.get(name, 0) + 1

    def tick(self, name: str):
        """Manual interval start (reference Timer::registerTimer+tick)."""
        self._acc.setdefault(name, 0.0)
        self._count.setdefault(name, 0)
        self._tick_at = (name, time.perf_counter())

    def tock(self, name: str):
        if self._tick_at is None:
            raise ValueError(f"tock({name}) without tick({name})")
        tag, t0 = self._tick_at
        if tag != name:
            raise ValueError(f"tock({name}) without tick({name})")
        self._tick_at = None
        self._acc[name] += time.perf_counter() - t0
        self._count[name] += 1

    def seconds(self, name: str) -> float:
        return self._acc[name]

    def mean_ms(self, name: str) -> float:
        return 1e3 * self._acc[name] / max(1, self._count[name])

    def report(self) -> str:
        lines = []
        for name in self._acc:
            lines.append(f"{name:28s} {self.mean_ms(name):10.3f} ms/op "
                         f"x{self._count[name]}")
        return "\n".join(lines)

    def clear(self):
        self._acc.clear()
        self._count.clear()


def time_ms(fn, reps: int = 10, windows: int = 3):
    """(median, min, max) ms per call over `windows` windows of `reps`
    calls each, after one warm-up call; every window ends in
    block_until_ready."""
    import jax
    jax.block_until_ready(fn())
    per = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        jax.block_until_ready(out)
        per.append((time.perf_counter() - t0) / reps * 1e3)
    return statistics.median(per), min(per), max(per)


def require_gpu(devices, count: int = 1) -> None:
    """Refuse any platform but the GPU, and fewer than `count` devices."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU, JAX found platform "
                         f"{platform!r}")
    if len(devices) < count:
        raise SystemExit(f"needs {count} GPUs, JAX found {len(devices)}")


def gpu_name_and_power() -> str:
    """The first card's name and power limit, as nvidia-smi reports them;
    a time means little without them (a card may be capped below its
    maximum power and then runs slower under load)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def trace(log_dir: str, host_tracer_level: Optional[int] = None):
    """Capture a profile of the device and the host into ``log_dir``.
    Raises if the profiler cannot start or stop: a run that asked for a
    trace never goes on without one."""
    import jax
    if host_tracer_level is not None:
        opts = jax.profiler.ProfileOptions()
        opts.host_tracer_level = host_tracer_level
        jax.profiler.start_trace(log_dir, profiler_options=opts)
    else:
        jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()

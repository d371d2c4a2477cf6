"""The measurement harness that chip_smoke.py and bench.py share
(troy_tpu.utils.profiling): the window reduction, the device refusal,
and chip_smoke.py's result line. The scripts need a GPU to run; these
parts are checked on any platform."""

import importlib.util
import json
import os
import types

import pytest

from troy_tpu.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_mod", os.path.join(REPO, f"{name}.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _device(platform, kind):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


@pytest.mark.parametrize("window_s,median,lo,hi", [
    ((0.002, 0.001, 0.004), 2.0, 1.0, 4.0),
    ((0.003, 0.003, 0.001, 0.002, 0.005), 3.0, 1.0, 5.0),
])
def test_time_ms_reduces_windows_to_median_min_max(monkeypatch, window_s,
                                                   median, lo, hi):
    """Each window's length, over its calls, in ms; the median and the
    extremes of the windows (the fake clock ticks once per window start
    and end)."""
    ticks = []
    for w in window_s:
        ticks += [0.0, w * 2]           # 2 calls per window
    clock = iter(ticks)
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    got = profiling.time_ms(lambda: 0, reps=2, windows=len(window_s))
    assert got == pytest.approx((median, lo, hi))


def test_chip_smoke_refuses_a_non_gpu_platform():
    import jax
    cs = _load("chip_smoke")
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        cs.require_gpu(jax.devices())
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        cs.require_gpu([])
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        cs.require_gpu([_device("gpu", "NVIDIA H100 80GB HBM3")], count=4)
    cs.require_gpu([_device("gpu", "NVIDIA H100 80GB HBM3")])


@pytest.mark.parametrize("count", [1, 4])
def test_chip_smoke_result_line_shape(count):
    devices = [_device("gpu", "NVIDIA H100 80GB HBM3")] * count
    line = _load("chip_smoke").result_line(devices)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


def test_chip_smoke_time_ms_median_of_windows():
    calls = []
    med, lo, hi = profiling.time_ms(lambda: calls.append(1), reps=2,
                                    windows=3)
    assert len(calls) == 1 + 2 * 3          # one warm-up call, then windows
    assert lo <= med <= hi

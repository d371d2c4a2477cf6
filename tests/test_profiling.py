"""Profiling utilities (the reference has only benchmark Timers,
test/timetest.cu:16-60; ours adds XLA trace capture)."""

import time

import numpy as np

from troy_tpu.utils.profiling import Timer, trace


def test_timer_measure_and_report():
    t = Timer()
    for _ in range(3):
        with t.measure("op"):
            time.sleep(0.01)
    assert t.seconds("op") >= 0.03
    assert 5 < t.mean_ms("op") < 100
    assert "op" in t.report()


def test_timer_tick_tock():
    t = Timer()
    t.tick("x")
    time.sleep(0.005)
    t.tock("x")
    assert t.seconds("x") >= 0.004
    try:
        t.tick("a")
        t.tock("b")
        raise AssertionError("expected mismatched tock to raise")
    except ValueError:
        pass


def test_trace_captures_profile(tmp_path):
    import pathlib
    import jax.numpy as jnp
    d = tmp_path / "trace"
    with trace(str(d)):
        (jnp.arange(128) * 2).block_until_ready()
    assert list(d.rglob("*.xplane.pb"))


def test_trace_raises_when_the_profiler_cannot_start(tmp_path, monkeypatch):
    import jax
    import pytest

    def refuse(*a, **k):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(jax.profiler, "start_trace", refuse)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with trace(str(tmp_path / "t")):
            pass

"""The port's profiler hook (``utils/tracing``): ``enable_profiler``,
``phase``'s ``torch.profiler.record_function`` ranges and
``device_trace``'s Chrome traces, on the CPU; and the CLI's
``--trace-dir``. The JAX package's hook (``jax.profiler``) has the same
surface; these hold the port's own contract."""

from __future__ import annotations

import json
import os

import pytest
import torch

from k8s_spot_rescheduler_tpu_torch.cli.main import main as port_main
from k8s_spot_rescheduler_tpu_torch.utils import tracing

torch.set_num_threads(1)


@pytest.fixture
def trace_dir(tmp_path):
    tracing.enable_profiler(str(tmp_path))
    yield tmp_path
    tracing.disable_profiler()


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_device_trace_writes_a_chrome_trace_with_the_phase_span(trace_dir):
    with tracing.device_trace() as trace:
        with tracing.phase("plan-fetch"):
            torch.ones(64).cumsum(0)
    assert trace.path and os.path.dirname(trace.path) == str(trace_dir)
    names = {e.get("name") for e in _events(trace.path)}
    assert "plan-fetch" in names


def test_each_call_writes_its_own_trace(trace_dir):
    paths = []
    for _ in range(2):
        with tracing.device_trace() as trace:
            with tracing.phase("observe"):
                pass
        paths.append(trace.path)
    assert len(set(paths)) == 2 and all(os.path.exists(p) for p in paths)


def test_an_error_inside_device_trace_reaches_the_caller(trace_dir):
    with pytest.raises(ZeroDivisionError):
        with tracing.device_trace() as trace:
            with tracing.phase("actuate"):
                1 / 0
    # the profiler stopped and still wrote the region up to the error
    assert trace.path and "actuate" in {e.get("name") for e in _events(trace.path)}
    with tracing.device_trace() as again:  # and it can trace again
        pass
    assert again.path


def test_without_a_trace_dir_nothing_is_traced(tmp_path):
    tracing.disable_profiler()
    with tracing.device_trace() as trace:
        with tracing.phase("observe"):
            pass
    assert trace.path is None
    assert not os.listdir(tmp_path)


def test_a_failing_profiler_leaves_the_region_running(trace_dir, monkeypatch):
    """Best effort: torch.profiler failing to start is logged and the
    region runs untraced; the region's own errors still propagate."""

    def broken(*a, **k):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with tracing.device_trace() as trace:
        ran.append(1)
    assert ran == [1] and trace.path is None
    with pytest.raises(KeyError):
        with tracing.device_trace():
            raise KeyError("x")


def test_cli_trace_dir_writes_a_trace_a_tick(tmp_path):
    out = tmp_path / "traces"
    rc = port_main(["--cluster", "synthetic:1", "--ticks", "2",
                    "--device", "cpu", "--no-metrics-server",
                    "--node-drain-delay", "1s", "--trace-dir", str(out)])
    assert rc == 0
    files = sorted(os.listdir(out))
    assert len(files) == 2
    names = {e.get("name") for e in _events(out / files[0])}
    assert {"observe", "actuate"} <= names
    assert tracing._trace_dir == str(out)
    tracing.disable_profiler()

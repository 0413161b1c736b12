"""The device trace of a traced window, reduced.

``Profiler`` wraps ``torch.profiler`` (CPU and CUDA activities) over the
first calls of a ``--trace 1`` window, writes its Chrome trace to a
temporary file, reads it back and deletes it. ``reduce`` turns the
events into what the per-layer readers and the result's ``breakdown``
need: device intervals (kernels, copies, sets), each kernel's time by
name and by call, the busy seconds of their union, and the idle gaps,
each named by the host span it fell in.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "bench.call"


class Profiler:
    """``start()``/``end()`` around the traced calls, ``read()`` after
    the window; ``mark(i)`` is a
    context around call ``i`` (a ``record_function`` range, whose start
    ties the profiler's clock to ``time.perf_counter``)."""

    def __init__(self):
        import torch

        self.torch = torch
        self.prof = None
        self.marks: Dict[int, float] = {}  # call -> perf_counter at its mark
        self.events: Optional[list] = None

    def start(self) -> None:
        tp = self.torch.profiler
        self.prof = tp.profile(
            activities=[tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA])
        self.prof.__enter__()

    def mark(self, call: int):
        self.marks[call] = time.perf_counter()
        return self.torch.profiler.record_function(f"{MARK}#{call}")

    def end(self) -> None:
        """Stop tracing (the events stay in the profiler until ``read``)."""
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def read(self) -> None:
        """The ended trace's events, through a temporary Chrome trace."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None


class Reduced:
    """``busy_s`` the union of device intervals over the window;
    ``window_s``; ``idle`` {host label: idle seconds}; ``ops`` {name:
    device seconds}; ``per_call`` {call: [(name, dur_us)]} of the
    kernels each traced call ran."""

    def __init__(self):
        self.busy_s = 0.0
        self.window_s = 0.0
        self.idle: Dict[str, float] = defaultdict(float)
        self.ops: Dict[str, float] = defaultdict(float)
        self.per_call: Dict[int, List[Tuple[str, float]]] = defaultdict(list)


def reduce(events: list, marks: Dict[int, float],
           windows: Dict[int, Tuple[float, float, float]],
           spans: Dict[int, list], t_start: float, t_end: float,
           left_out: List[Tuple[float, float]] = ()) -> Reduced:
    """``marks``: perf_counter at each call's mark; ``windows``: per
    call (churn start, call start, call end) on perf_counter;
    ``spans``: per call [(name, start, end, depth)] of the program's spans on
    perf_counter; ``t_start``/``t_end`` bound the traced window;
    ``left_out`` are intervals (perf_counter) that the window does not
    count (the load generator's draws), taken off its length and off its
    idle gaps."""
    out = Reduced()
    offset = None  # profiler us - perf_counter us
    dev = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat == "user_annotation" and name.startswith(MARK + "#"):
            call = int(name.split("#", 1)[1])
            if call in marks and offset is None:
                offset = float(ev["ts"]) - marks[call] * 1e6
        elif cat in DEVICE_CATS:
            dev.append((name, float(ev["ts"]), float(ev.get("dur", 0.0)), cat))
    if offset is None:
        raise RuntimeError("the device trace holds no call mark")
    lo, hi = t_start * 1e6 + offset, t_end * 1e6 + offset
    cut = [(a * 1e6 + offset, b * 1e6 + offset) for a, b in left_out]
    out.window_s = (hi - lo - sum(_overlap(lo, hi, cut))) / 1e6
    dev.sort(key=lambda d: d[1])
    call_bounds = sorted(
        (w[1] * 1e6 + offset, w[2] * 1e6 + offset, call)
        for call, w in windows.items())
    for name, ts, dur, cat in dev:
        out.ops[name] += dur / 1e6
        if cat == "kernel":
            for a, b, call in call_bounds:
                if a <= ts <= b:
                    out.per_call[call].append((name, dur))
                    break
    # the busy union and the gaps between device intervals
    labels = _labeller(windows, spans, offset)
    cur_end = lo
    for name, ts, dur, cat in dev:
        start, end = max(ts, lo), min(ts + dur, hi)
        if end <= start:
            continue
        if start > cur_end:
            _gap(out, labels, cur_end, start, cut)
            cur_end = start
        if end > cur_end:
            out.busy_s += (end - cur_end) / 1e6
            cur_end = end
    if hi > cur_end:
        _gap(out, labels, cur_end, hi, cut)
    return out


def _labeller(windows, spans, offset):
    """A function of a profiler time (us) to the host span it lies in:
    the innermost of the program's spans, else the harness's phase."""
    items = []
    for call, (churn0, call0, call1) in windows.items():
        items.append((churn0 * 1e6 + offset, call0 * 1e6 + offset,
                      0, "bench.churn"))
        items.append((call0 * 1e6 + offset, call1 * 1e6 + offset,
                      0, "bench.call"))
        for name, a, b, depth in spans.get(call, ()):
            items.append((a * 1e6 + offset, b * 1e6 + offset, depth + 1, name))

    def label(t: float) -> str:
        best, depth = "bench.between", -1
        for a, b, d, name in items:
            if a <= t < b and d > depth:
                best, depth = name, d
        return best

    return label


def _overlap(a: float, b: float, cut) -> List[float]:
    return [max(0.0, min(b, y) - max(a, x)) for x, y in cut]


def _gap(out: Reduced, label, a: float, b: float, cut=()) -> None:
    length = b - a - sum(_overlap(a, b, cut))
    if length > 0:
        out.idle[label((a + b) / 2)] += length / 1e6

"""Injectable time source.

The reference calls ``time.Now()``/``time.After``/``time.Sleep`` directly
(rescheduler.go:159-167, scaler/scaler.go:47-62, 119-144), which is why its
control loop and actuator are untested (SURVEY.md §4). The framework routes
all time through a ``Clock`` so the loop/actuator state machines are unit
testable with a virtual clock.
"""

from __future__ import annotations

import heapq
import threading
import time as _time
from typing import Protocol


class Clock(Protocol):
    def now(self) -> float: ...
    def sleep(self, seconds: float) -> None: ...
    # wall-clock epoch seconds: unlike ``now`` (monotonic — resets with
    # the process), comparable across restarts and replicas; used for
    # durable timestamps written into the cluster (taint ownership)
    def wall(self) -> float: ...


class RealClock:
    def now(self) -> float:
        return _time.monotonic()

    def wall(self) -> float:
        return _time.time()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            _time.sleep(seconds)


class FakeClock:
    """Deterministic virtual clock. ``sleep`` advances time instantly and
    fires any timers scheduled via ``call_at`` (used by the fake cluster to
    model pod-termination latency)."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._timers: list = []  # heap of (when, seq, fn)
        self._seq = 0
        # the actuator's eviction fan-out schedules termination timers
        # from worker threads (actuator/drain.py)
        self._lock = threading.Lock()

    def now(self) -> float:
        return self._now

    def wall(self) -> float:
        # the virtual timeline IS the wall clock in tests
        return self._now

    def call_at(self, when: float, fn) -> None:
        with self._lock:
            heapq.heappush(self._timers, (float(when), self._seq, fn))
            self._seq += 1

    def sleep(self, seconds: float) -> None:
        self.advance(max(0.0, seconds))

    def advance(self, seconds: float) -> None:
        deadline = self._now + float(seconds)
        while True:
            with self._lock:
                if not self._timers or self._timers[0][0] > deadline:
                    break
                when, _, fn = heapq.heappop(self._timers)
                self._now = max(self._now, when)
            fn()  # outside the lock: fn may schedule follow-up timers
        with self._lock:  # call_at readers see a coherent (_now, heap)
            self._now = deadline

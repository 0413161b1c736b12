"""Controller health state, shared process-wide.

The control loop's degradation machinery (planner fallback, observe-error
circuit breaker, taint recovery — loop/controller.py) needs a surface an
operator's probe can read without scraping Prometheus: the sidecar's
``GET /healthz`` (sidecar/server.py) merges ``snapshot()`` into its
response, so a kubelet liveness/readiness probe sees ``degraded`` and
the last-successful-tick age directly.

One module-level ``STATE`` because one controller runs per process
(leader election guarantees one actor per cluster); tests reset it via
``STATE.reset()``. Timestamps come from the controller's injected clock
(``set_clock``) so virtual-clock tests read coherent ages.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class HealthState:
    def __init__(self):
        self._lock = threading.Lock()
        self._now: Optional[Callable[[], float]] = None
        # degraded = OR over independent causes — tracked per cause, so
        # a recovering breaker clears its half without masking a
        # still-fallback planner (and vice versa): planner fallback,
        # breaker engaged, watch mirror past its freshness budget, and
        # the sticky startup watch-sync fallback.
        self._fallback_degraded = False
        self._breaker_degraded = False
        self._freshness_degraded = False
        self._startup_degraded = False
        self.degraded = False
        self.last_success: Optional[float] = None
        self.planner_fallback_total = 0
        self.consecutive_errors = 0
        self.breaker_interval: Optional[float] = None
        self.taints_recovered_total = 0
        self.mirror_staleness_s: Optional[float] = None
        # last dispatched solver program (planner/solver_planner):
        # running label + the carry-streamed tier's chunk count and
        # estimated resident carry bytes — mirrored beside the
        # solver_mode / solver_carry_* gauges from the SAME call site
        self.solver_mode: Optional[str] = None
        self.carry_chunks = 0
        self.solver_carry_bytes: Optional[int] = None

    def reset(self) -> None:
        """Back to process-start state (test isolation)."""
        with self._lock:
            self._now = None
            self._fallback_degraded = False
            self._breaker_degraded = False
            self._freshness_degraded = False
            self._startup_degraded = False
            self.degraded = False
            self.last_success = None
            self.planner_fallback_total = 0
            self.consecutive_errors = 0
            self.breaker_interval = None
            self.taints_recovered_total = 0
            self.mirror_staleness_s = None
            self.solver_mode = None
            self.carry_chunks = 0
            self.solver_carry_bytes = None
        self._mirror_gauge(False)

    def set_clock(self, now_fn: Callable[[], float]) -> None:
        with self._lock:
            self._now = now_fn

    def _clock(self) -> float:
        return (self._now or time.monotonic)()

    @staticmethod
    def _mirror_gauge(degraded: bool) -> None:
        from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics

        metrics.update_degraded(degraded)

    def _degraded_locked(self) -> bool:
        """Recompute the OR over causes; caller holds the lock."""
        self.degraded = (
            self._fallback_degraded
            or self._breaker_degraded
            or self._freshness_degraded
            or self._startup_degraded
        )
        return self.degraded

    def note_success(self, *, fallback: bool = False) -> None:
        """A tick completed (observe + plan + actuate all ran).
        ``fallback``: the plan came from the CPU fallback planner — the
        tick counts as degraded until a clean primary tick follows.
        (``planner_fallback_total`` is driven by ``note_planner_fallback``
        per contained exception, not here.)"""
        with self._lock:
            self.last_success = self._clock()
            self.consecutive_errors = 0
            self.breaker_interval = None
            self._breaker_degraded = False
            self._fallback_degraded = bool(fallback)
            degraded = self._degraded_locked()
        self._mirror_gauge(degraded)

    def note_planner_fallback(self) -> None:
        """One contained planner exception — called alongside
        ``metrics.update_planner_fallback()`` from the same event, so
        /healthz and the Prometheus counter of the same name agree."""
        with self._lock:
            self.planner_fallback_total += 1

    def note_observe_ok(self) -> None:
        """Observation succeeded but a healthy gate skipped the tick
        (unschedulable pods pending): the apiserver is provably fine, so
        the observe-error breaker resets — while any fallback-planner
        degradation stands until a tick actually completes."""
        with self._lock:
            self.consecutive_errors = 0
            self.breaker_interval = None
            self._breaker_degraded = False
            degraded = self._degraded_locked()
        self._mirror_gauge(degraded)

    def note_error(
        self, consecutive: int, breaker_interval: Optional[float] = None
    ) -> None:
        """A tick was skipped on an observe/plan error. ``breaker_interval``
        is the widened housekeeping interval when the circuit breaker is
        engaged (None below threshold)."""
        with self._lock:
            self.consecutive_errors = int(consecutive)
            self.breaker_interval = breaker_interval
            self._breaker_degraded = breaker_interval is not None
            degraded = self._degraded_locked()
        self._mirror_gauge(degraded)

    def note_mirror_staleness(self, staleness: float, budget: float) -> None:
        """The freshness gate's per-tick verdict: the watch mirror's age
        versus its budget. Over-budget marks the loop degraded until a
        later gate finds the mirror fresh again — the bypassed ticks
        still complete, so ``note_success`` alone must not clear it."""
        with self._lock:
            self.mirror_staleness_s = (
                None if staleness == float("inf") else round(staleness, 3)
            )
            self._freshness_degraded = budget > 0 and staleness > budget
            degraded = self._degraded_locked()
        self._mirror_gauge(degraded)

    def note_startup_degraded(self) -> None:
        """The watch caches failed to sync at startup and the loop fell
        back to the polling client — sticky for the process lifetime
        (the cache path never re-engages without a restart)."""
        with self._lock:
            self._startup_degraded = True
            degraded = self._degraded_locked()
        self._mirror_gauge(degraded)

    def note_solver_mode(
        self, running: str, carry_chunks: int, carry_bytes: int
    ) -> None:
        """What the last solve actually ran (the dispatch ladder's
        verdict), called beside ``metrics.update_solver_mode`` so
        /healthz and the gauges agree. Negative ``carry_bytes`` =
        estimate unavailable (non-auto-shard paths) — left as-is."""
        with self._lock:
            self.solver_mode = running
            self.carry_chunks = int(carry_chunks)
            if carry_bytes >= 0:
                self.solver_carry_bytes = int(carry_bytes)

    def note_taint_recovered(self) -> None:
        with self._lock:
            self.taints_recovered_total += 1

    def snapshot(self) -> dict:
        """JSON-ready view for /healthz."""
        with self._lock:
            age = (
                None
                if self.last_success is None
                else max(0.0, self._clock() - self.last_success)
            )
            return {
                "degraded": self.degraded,
                "last_successful_tick_age_s": (
                    None if age is None else round(age, 3)
                ),
                "planner_fallback_total": self.planner_fallback_total,
                "consecutive_tick_errors": self.consecutive_errors,
                "breaker_interval_s": self.breaker_interval,
                "taints_recovered_total": self.taints_recovered_total,
                "mirror_staleness_s": self.mirror_staleness_s,
                "solver_mode": self.solver_mode,
                "carry_chunks": self.carry_chunks,
                "solver_carry_bytes": self.solver_carry_bytes,
            }


STATE = HealthState()


def snapshot() -> dict:
    return STATE.snapshot()

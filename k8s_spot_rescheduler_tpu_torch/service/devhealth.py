"""Device-health watchdog: detect the slow-degrading accelerator.

A copy of the JAX package's ``service/devhealth.py``. The failure mode
it watches for: an accelerator that neither crashes nor disappears, it
just gets slow, and every latency number and fleet plan it touches
silently degrades, though it looks healthy to every other guard.

This module is the detector. The planner service times every batched
device solve on its injected clock and feeds the watchdog:

- a **calibrated baseline**: an EMA over the first ``CALIBRATION_BATCHES``
  solves (and, while healthy, every later solve). Slowness is judged
  RELATIVE to this baseline — a solver that is uniformly slow from boot
  is a slow solver, not a sick device, and never flips the watchdog.
- **sick detection**: ``device_sick_threshold`` CONSECUTIVE batches
  slower than ``SLOW_RATIO x baseline`` (with an absolute floor so a
  zero-ish virtual-clock baseline cannot make noise look sick), OR any
  device-solve exception, OR a canary solve past its timeout, flips the
  watchdog to ``sick``.
- **while sick** the service serves every batch from its numpy-oracle
  host path (the same ``solver/numpy_oracle`` union the CI path runs),
  so a fleet keeps getting *correct* plans at host speed instead of
  poisoned latency — and ``/healthz`` says ``device: "sick"``, the
  ``service_device_sick`` gauge reads 1, and the flight recorder holds a
  ``device-sick`` degradation event, all driven by the same edge.
- **hysteresis-gated recovery**: every ``PROBE_INTERVAL_S`` a batch is
  routed through the device path as a probe; only ``RECOVERY_PROBES``
  consecutive healthy probes flip the watchdog back (a device limping in
  and out of its sick phase must not flap the fleet's solve path).
- a **canary**: while the service is idle (no batches to time), the
  scheduler loop periodically runs a tiny all-invalid solve through the
  device path so a wedging device is noticed before the next real
  request pays for the discovery. A canary that raises or overruns
  ``CANARY_TIMEOUT_S`` is a sick edge like any other. (A canary that
  never *returns* cannot be preempted in-process — that terminal wedge
  surfaces as /healthz batch-cadence age, not here.)

The watchdog is pure bookkeeping over an injected clock: no device
access of its own, fully deterministic under ``FakeClock``.

In the port a fault of the card's kernels (``ops/ffd_kernels.
is_device_fault``) never reaches ``note_error``: the service fails that
batch and ends (``service/server.py``). On a cuda service the other
verdicts (latency, canary, other device errors) only report: the gauge,
``/healthz`` and the flight event fire as above, but no batch moves to
the host path; each solve while sick is a probe on the card, and a
failing one fails its batch. The "while sick" host path above is the
service's off the card only.
"""

from __future__ import annotations

from typing import Optional

from k8s_spot_rescheduler_tpu_torch.utils.clock import Clock


class DeviceHealthWatchdog:
    """Latency-EMA + canary sick-device detector with hysteresis.

    State machine: ``calibrating`` -> ``ok`` <-> ``sick``. Edges are
    returned from the ``note_*`` methods ("sick" / "recovered" / None)
    so the caller (service/server.py) fires the gauge, the flight event
    and the log line from ONE place per edge.
    """

    # a batch counts "slow" past this multiple of the calibrated baseline
    SLOW_RATIO = 4.0
    # absolute slowness floor: protects a near-zero baseline (virtual
    # clocks, sub-ms CPU stubs) from flagging measurement noise — and is
    # itself the slow bar when the baseline is that small
    MIN_SLOW_S = 0.05
    # healthy solves that seed the baseline before slowness is judged
    CALIBRATION_BATCHES = 5
    # EMA weight of the newest healthy sample
    EMA_ALPHA = 0.3
    # consecutive healthy probes required to leave ``sick`` (hysteresis)
    RECOVERY_PROBES = 2
    # minimum spacing of recovery probes while sick
    PROBE_INTERVAL_S = 2.0
    # idle-canary cadence while healthy, and its hard latency budget
    CANARY_INTERVAL_S = 10.0
    CANARY_TIMEOUT_S = 5.0

    def __init__(self, clock: Clock, threshold: int):
        self.clock = clock
        # consecutive slow batches that flip sick (config
        # ``device_sick_threshold``; callers gate construction on > 0)
        self.threshold = max(1, int(threshold))
        self.sick = False
        self.sick_reason = ""
        self.sick_since: Optional[float] = None
        self.sick_total = 0  # lifetime sick transitions
        self.detect_streak = 0  # streak length at the last sick flip
        self._baseline: Optional[float] = None
        self._samples = 0
        self._slow_streak = 0
        self._healthy_probes = 0
        self._last_probe = float("-inf")
        self._last_activity = clock.now()

    # ------------------------------------------------------------------
    # healthy-path accounting

    def _is_slow(self, dur_s: float) -> bool:
        if self._samples < self.CALIBRATION_BATCHES or self._baseline is None:
            return False
        return dur_s > max(self.SLOW_RATIO * self._baseline, self.MIN_SLOW_S)

    def note_batch(self, dur_s: float) -> Optional[str]:
        """One timed healthy-path device solve; returns "sick" on the
        detection edge (the slow result itself is still valid — latency
        is the symptom, not corruption)."""
        self._last_activity = self.clock.now()
        if self.sick:
            return None
        if self._is_slow(dur_s):
            self._slow_streak += 1
            if self._slow_streak >= self.threshold:
                return self._flip_sick(
                    "latency",
                    f"{self._slow_streak} consecutive batches past "
                    f"{self.SLOW_RATIO:g}x the {self._baseline * 1e3:.1f} ms "
                    "baseline",
                )
            return None
        self._slow_streak = 0
        self._samples += 1
        self._baseline = (
            dur_s
            if self._baseline is None
            else (1 - self.EMA_ALPHA) * self._baseline + self.EMA_ALPHA * dur_s
        )
        return None

    def note_error(self, err: BaseException) -> Optional[str]:
        """A device solve raised: immediate sick edge."""
        self._last_activity = self.clock.now()
        if self.sick:
            return None
        return self._flip_sick("solve-error", f"device solve raised: {err}")

    # ------------------------------------------------------------------
    # recovery probes (while sick)

    def should_probe(self) -> bool:
        """While sick: is it time to route one batch through the device
        path as a recovery probe? Stamps the probe clock when it says
        yes — callers must then report via ``note_probe``."""
        if not self.sick:
            return False
        now = self.clock.now()
        if now - self._last_probe < self.PROBE_INTERVAL_S:
            return False
        self._last_probe = now
        return True

    def note_probe(self, dur_s: float, ok: bool) -> Optional[str]:
        """One recovery-probe outcome; returns "recovered" only after
        ``RECOVERY_PROBES`` consecutive healthy probes (hysteresis)."""
        self._last_activity = self.clock.now()
        if not self.sick:
            return None
        if ok and not self._is_slow(dur_s):
            self._healthy_probes += 1
            if self._healthy_probes >= self.RECOVERY_PROBES:
                return self._recover()
        else:
            self._healthy_probes = 0
        return None

    # ------------------------------------------------------------------
    # idle canary (while healthy)

    def should_canary(self) -> bool:
        """While healthy and idle: is the device overdue a tiny canary
        solve? (Sick-state probing is ``should_probe``'s job.)"""
        if self.sick:
            return False
        return (
            self.clock.now() - self._last_activity >= self.CANARY_INTERVAL_S
        )

    def note_canary(self, dur_s: float, ok: bool) -> Optional[str]:
        self._last_activity = self.clock.now()
        if self.sick:
            return None
        if not ok:
            return self._flip_sick("canary-error", "canary solve raised")
        if dur_s > self.CANARY_TIMEOUT_S:
            return self._flip_sick(
                "canary-timeout",
                f"canary solve took {dur_s:.2f}s "
                f"(budget {self.CANARY_TIMEOUT_S:g}s)",
            )
        # a healthy canary is a liveness sample, not a baseline one (its
        # problem shape is not the fleet's)
        return None

    # ------------------------------------------------------------------

    def _flip_sick(self, reason: str, detail: str) -> str:
        self.sick = True
        self.sick_reason = f"{reason}: {detail}"
        self.sick_since = self.clock.now()
        self.sick_total += 1
        self.detect_streak = self._slow_streak
        self._healthy_probes = 0
        self._last_probe = float("-inf")
        return "sick"

    def _recover(self) -> str:
        self.sick = False
        self.sick_reason = ""
        self.sick_since = None
        self._slow_streak = 0
        self._healthy_probes = 0
        return "recovered"

    def snapshot(self) -> dict:
        """The /healthz half: ``device`` plus the numbers an operator
        needs to trust (or distrust) it."""
        state = "sick" if self.sick else (
            "calibrating"
            if self._samples < self.CALIBRATION_BATCHES
            else "ok"
        )
        out = {
            "device": state,
            "device_baseline_ms": (
                None
                if self._baseline is None
                else round(self._baseline * 1e3, 3)
            ),
            "device_slow_streak": self._slow_streak,
            "device_sick_total": self.sick_total,
        }
        if self.sick:
            out["device_sick_reason"] = self.sick_reason
            out["device_sick_age_s"] = round(
                max(0.0, self.clock.now() - (self.sick_since or 0.0)), 3
            )
        return out

"""Seeded deterministic fault injection over any ClusterClient.

The port of the JAX package's ``io/chaos.py``. The reference has no way
to *test* its failure behavior — its recovery story ("recompute
everything next tick") is asserted, never exercised. ``FakeCluster``
injects only per-pod eviction-failure counts (io/fake.py); everything
else an apiserver can do to a controller — flaky LISTs, 429 PDB-blocked
evictions, stale reads, dropped, stalled or expired watch streams, a
process dying between the taint and the evictions — replays here from a
seeded ``FaultPlan``, so every chaos scenario is deterministic in tests
(``tests/test_torch_chaos.py``) and on the CLI (``--chaos-profile``).
All draws come from one ``random.Random(plan.seed)``, so a run of the
port and one of the JAX package that make the same client calls in the
same order inject the same faults.

Layering: this sits ABOVE the client (ClusterClient verbs), so it
composes with every backend — fake, polling kube, watch-backed — and
below the control loop, whose degradation paths (skip-tick, planner
fallback, breaker, taint reconciliation) are what the chaos soak proves.
The wrapper deliberately does NOT forward ``columnar_store``: the
vectorized observe path bypasses the read verbs, so chaos forces the
object path where every read passes the fault layer.
"""

from __future__ import annotations

import collections
import dataclasses
import random
from typing import Dict, List, Mapping, Optional

from k8s_spot_rescheduler_tpu_torch.io.cluster import EvictionError
from k8s_spot_rescheduler_tpu_torch.models.cluster import (
    NodeSpec,
    PDBSpec,
    PodSpec,
    Taint,
)
from k8s_spot_rescheduler_tpu_torch.utils import logging as log


class ChaosError(Exception):
    """An injected transient API failure (connection reset / 5xx class)."""


class ChaosInterrupt(BaseException):
    """Simulated process death mid-actuation.

    A ``BaseException`` on purpose: the drain state machine and the
    control loop deliberately survive every ``Exception`` (that is the
    robustness contract under test), so a simulated crash must ride a
    channel none of those guards can swallow. The soak harness catches
    it at top level and "restarts" the controller against the same
    cluster, inheriting whatever residue — an orphaned ``ToBeDeleted``
    taint, half-evicted pods — the crash left behind.
    """


# Read verbs eligible for error-rate / latency / stale-read injection.
_READS = (
    "list_ready_nodes",
    "list_unready_nodes",
    "list_pods_on_node",
    "list_unschedulable_pods",
    "list_pdbs",
    "get_pod",
)
_WRITES = ("evict_pod", "add_taint", "remove_taint")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to break, how often — all draws from one seeded stream.

    - ``error_rates``: per-method probability of raising ``ChaosError``
      (use method names from the ClusterClient surface; reads AND writes).
    - ``latency_s``: per-method injected latency, slept on the wrapper's
      clock before the call (virtual clocks advance instantly).
    - ``fail_n``: per-method "fail the first N calls, then succeed" —
      the deterministic script for retry/backoff tests.
    - ``evict_429``: pod uid -> number of HTTP-429 PDB-blocked eviction
      rejections before the eviction is allowed through.
    - ``stale_read_rate``: probability a list verb returns the PREVIOUS
      successful result for the same query instead of a fresh one.
    - ``watch_drop_rate``: per-event probability a watch stream dies
      with a connection reset (clients with a ``_stream`` hook only).
    - ``watch_stall_rate``: per-stream-open probability the stream is
      OPEN BUT SILENT — it yields nothing until the caller's read
      timeout elapses (slept on the wrapper's clock), then raises the
      same ``TimeoutError`` the wedged socket would. The failure mode
      the client-side watch progress deadline exists to catch: no
      error, no close, no data.
    - ``watch_410_streams``: 1-based stream-open indices that
      immediately deliver a 410-Expired ERROR event and end — the
      scripted "410 right after a resume" that must trigger exactly
      one throttled re-LIST.
    - ``interrupt_on_taint``: 1-based index of the ``add_taint`` call
      that raises ``ChaosInterrupt`` AFTER the taint is applied — the
      canonical mid-drain crash leaving an orphaned taint. 0 = never.

    Mirror corruption (the audit's third chaos scenario) needs no knob
    here: the wrapper sits below the watch stores, so the soak harness
    corrupts a ``ResourceStore`` entry directly and the anti-entropy
    audit must detect and heal it.
    """

    seed: int = 0
    error_rates: Mapping[str, float] = dataclasses.field(default_factory=dict)
    latency_s: Mapping[str, float] = dataclasses.field(default_factory=dict)
    fail_n: Mapping[str, int] = dataclasses.field(default_factory=dict)
    evict_429: Mapping[str, int] = dataclasses.field(default_factory=dict)
    stale_read_rate: float = 0.0
    watch_drop_rate: float = 0.0
    watch_stall_rate: float = 0.0
    watch_410_streams: tuple = ()
    interrupt_on_taint: int = 0

    # the single source for profile names: profile() accepts exactly
    # these, and cli/main.py builds its --chaos-profile choices from it
    PROFILES = ("", "off", "none", "light", "heavy")

    @classmethod
    def profile(cls, name: str, seed: int = 0) -> "FaultPlan":
        """Named presets behind ``--chaos-profile`` (CLI)."""
        if name in ("", "off", "none"):
            return cls(seed=seed)
        if name == "light":
            return cls(
                seed=seed,
                error_rates={m: 0.05 for m in _READS},
            )
        if name == "heavy":
            rates = {m: 0.15 for m in _READS}
            rates.update({m: 0.05 for m in _WRITES})
            return cls(
                seed=seed,
                error_rates=rates,
                stale_read_rate=0.05,
                watch_drop_rate=0.10,
            )
        raise ValueError(
            f"unknown chaos profile {name!r} (known: light, heavy)"
        )


class ChaosClusterClient:
    """ClusterClient + EventSink decorator replaying a ``FaultPlan``.

    Deterministic: all probabilistic draws come from one
    ``random.Random(plan.seed)`` stream, so a fixed (plan, call
    sequence) pair always injects the same faults. ``enabled = False``
    quiesces every fault source at once — the soak's "faults clear"
    phase — while scripted counters (``fail_n``/``evict_429``) keep
    their remaining state for when it flips back.
    """

    def __init__(self, inner, plan: FaultPlan, *, clock=None):
        self.inner = inner
        self.plan = plan
        self.clock = clock
        self.enabled = True
        self.rng = random.Random(plan.seed)
        # injected-fault audit: method -> count (tests assert determinism
        # and coverage on this)
        self.stats: collections.Counter = collections.Counter()
        self._fail_n: Dict[str, int] = dict(plan.fail_n)
        self._evict_429: Dict[str, int] = dict(plan.evict_429)
        self._taint_calls = 0
        self._watch_streams = 0
        self._last_read: Dict[tuple, object] = {}

    # --- fault primitives ---

    def _latency(self, method: str) -> None:
        delay = self.plan.latency_s.get(method, 0.0)
        if self.enabled and delay > 0 and self.clock is not None:
            self.clock.sleep(delay)

    def _maybe_fault(self, method: str) -> None:
        """Raise per the scripted fail-N counter or the error rate."""
        if not self.enabled:
            return
        remaining = self._fail_n.get(method, 0)
        if remaining > 0:
            self._fail_n[method] = remaining - 1
            self.stats[method] += 1
            raise ChaosError(f"chaos: scripted failure of {method} "
                             f"({remaining - 1} more)")
        if self.rng.random() < self.plan.error_rates.get(method, 0.0):
            self.stats[method] += 1
            raise ChaosError(f"chaos: injected {method} failure "
                             "(connection reset by peer)")

    def _read(self, method: str, *args):
        """One faulted read: latency, then scripted/random failure, then
        possibly a stale (previous) result, else the fresh one."""
        self._latency(method)
        self._maybe_fault(method)
        key = (method,) + args
        if (
            self.enabled
            and key in self._last_read
            and self.rng.random() < self.plan.stale_read_rate
        ):
            self.stats["stale_read"] += 1
            return self._last_read[key]
        result = getattr(self.inner, method)(*args)
        self._last_read[key] = result
        return result

    # --- read path ---

    def list_ready_nodes(self) -> List[NodeSpec]:
        return self._read("list_ready_nodes")

    def list_unready_nodes(self) -> List[NodeSpec]:
        return self._read("list_unready_nodes")

    def list_pods_on_node(self, node_name: str) -> List[PodSpec]:
        return self._read("list_pods_on_node", node_name)

    def list_unschedulable_pods(self) -> List[PodSpec]:
        return self._read("list_unschedulable_pods")

    def list_pdbs(self) -> List[PDBSpec]:
        return self._read("list_pdbs")

    def get_pod(self, namespace: str, name: str) -> Optional[PodSpec]:
        return self._read("get_pod", namespace, name)

    def _invalidate(self, *keys: tuple) -> None:
        """Read-your-own-writes floor: the apiserver never serves THIS
        client a read older than its own acknowledged write (stale reads
        model cache/replication lag, not time travel past the caller's
        writes). A successful write drops the stale-serving cache for
        the queries it changes — without this, a stale pod LIST can
        resurrect pods the controller itself already evicted and induce
        a phantom double-drain no real apiserver would permit."""
        for key in keys:
            self._last_read.pop(key, None)

    # --- write path ---

    def evict_pod(self, pod: PodSpec, grace_seconds: int) -> None:
        self._latency("evict_pod")
        if self.enabled:
            blocked = self._evict_429.get(pod.uid, 0)
            if blocked > 0:
                self._evict_429[pod.uid] = blocked - 1
                self.stats["evict_429"] += 1
                raise EvictionError(
                    f"chaos: evict {pod.uid}: HTTP 429 Too Many Requests "
                    "(disruption budget exhausted)"
                )
        self._maybe_fault("evict_pod")
        self.inner.evict_pod(pod, grace_seconds)
        self._invalidate(
            ("list_pods_on_node", pod.node_name),
            ("list_unschedulable_pods",),
            ("get_pod", pod.namespace, pod.name),
        )

    def add_taint(self, node_name: str, taint: Taint) -> None:
        self._latency("add_taint")
        self._maybe_fault("add_taint")
        self.inner.add_taint(node_name, taint)
        self._invalidate(("list_ready_nodes",), ("list_unready_nodes",))
        self._taint_calls += 1
        if (
            self.enabled
            and self.plan.interrupt_on_taint
            and self._taint_calls == self.plan.interrupt_on_taint
        ):
            self.stats["interrupt"] += 1
            log.error(
                "chaos: simulating process death right after tainting %s",
                node_name,
            )
            raise ChaosInterrupt(f"chaos: crashed after tainting {node_name}")

    def remove_taint(self, node_name: str, taint_key: str) -> None:
        self._latency("remove_taint")
        self._maybe_fault("remove_taint")
        self.inner.remove_taint(node_name, taint_key)
        self._invalidate(("list_ready_nodes",), ("list_unready_nodes",))

    # --- event sink (never faulted: events are best-effort already) ---

    def event(
        self, kind: str, name: str, event_type: str, reason: str, message: str
    ) -> None:
        self.inner.event(kind, name, event_type, reason, message)

    # --- watch hook (clients with a raw stream, io/kube.py) ---

    def _stream(self, path: str, read_timeout: float = 330.0):
        inner_stream = getattr(self.inner, "_stream")
        self._watch_streams += 1
        stream_no = self._watch_streams
        self._maybe_fault("watch")
        if self.enabled and stream_no in self.plan.watch_410_streams:
            # scripted 410-after-resume: the stream opens fine and
            # immediately reports the resourceVersion expired — the
            # watcher must fall back to exactly one throttled re-LIST
            self.stats["watch_410"] += 1
            yield {
                "type": "ERROR",
                "object": {
                    "kind": "Status", "code": 410, "reason": "Expired",
                    "message": "chaos: scripted resourceVersion expiry",
                },
            }
            return
        if (
            self.enabled
            and self.plan.watch_stall_rate
            and self.rng.random() < self.plan.watch_stall_rate
        ):
            # open-but-silent: no event, no error, no close — exactly
            # what a wedged transport looks like. Sleep out the
            # caller's read timeout on the injected clock (instant on
            # a virtual clock), then raise what the socket would.
            self.stats["watch_stall"] += 1
            if self.clock is not None:
                self.clock.sleep(read_timeout)
            raise TimeoutError(
                "chaos: watch stream open but silent (stalled past the "
                "read timeout)"
            )
        for obj in inner_stream(path, read_timeout):
            yield obj
            if (
                self.enabled
                and self.plan.watch_drop_rate
                and self.rng.random() < self.plan.watch_drop_rate
            ):
                self.stats["watch_drop"] += 1
                raise ConnectionResetError("chaos: watch stream dropped")

    # --- passthrough ---

    def __getattr__(self, name):
        if name == "columnar_store":
            # Refuse the vectorized observe shortcut: it reads the store
            # directly, bypassing every faulted verb — chaos must force
            # the control loop onto the object path.
            raise AttributeError(name)
        return getattr(self.inner, name)

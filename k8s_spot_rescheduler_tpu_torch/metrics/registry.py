"""Metrics, held in process.

The port of the JAX package's ``metrics/registry.py``, as far as the
controller, the actuator, the planner and ``loop/health`` call it: the
reference's four series under namespace ``spot_rescheduler`` (reference
metrics/metrics.go:28-64), name for name and label for label, plus the
planner, robustness and freshness series the port's controller updates,
and the kube client's and the watch mirror's (``io/kube``, ``io/watch``).

The values live in a small store of counters, gauges and histograms in
this module, so nothing here needs ``prometheus_client``. ``serve``
imports it when it is called and exposes the store over HTTP like the
reference's promhttp handler (rescheduler.go:126-130); without the
package it raises.
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence, Tuple

NAMESPACE = "spot_rescheduler"

_LOCK = threading.Lock()


class _Metric:
    """One metric family: ``kind`` is counter, gauge or histogram;
    ``values`` maps a label-value tuple to a float (counter, gauge) or to
    [bucket counts..., count, sum] (histogram)."""

    def __init__(self, kind: str, name: str, doc: str,
                 labelnames: Sequence[str] = (), buckets=()):
        self.kind = kind
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self.values: Dict[Tuple[str, ...], object] = {}
        _REGISTRY.append(self)

    def labels(self, *values) -> "_Child":
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got {values}"
            )
        return _Child(self, tuple(str(v) for v in values))

    # unlabeled shorthands
    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def value(self, *labels) -> float:
        """Counter or gauge value (0 when never written)."""
        return float(self.values.get(tuple(str(v) for v in labels), 0.0))


class _Child:
    def __init__(self, metric: _Metric, key: Tuple[str, ...]):
        self._m = metric
        self._key = key

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with _LOCK:
            self._m.values[self._key] = self._m.values.get(self._key, 0.0) + n

    def set(self, v: float) -> None:
        with _LOCK:
            self._m.values[self._key] = float(v)

    def observe(self, v: float) -> None:
        m = self._m
        with _LOCK:
            row = m.values.get(self._key)
            if row is None:
                row = m.values[self._key] = [0.0] * (len(m.buckets) + 2)
            for i, le in enumerate(m.buckets):
                if v <= le:
                    row[i] += 1
            row[-2] += 1
            row[-1] += v


_REGISTRY = []


def _gauge(name, doc, labels=()):
    return _Metric("gauge", name, doc, labels)


def _counter(name, doc, labels=()):
    return _Metric("counter", name, doc, labels)


def _histogram(name, doc, labels, buckets):
    return _Metric("histogram", name, doc, labels, buckets)


node_pods_count = _gauge(
    "node_pods_count", "Number of pods on each node.", ["node_type", "node"]
)
nodes_count = _gauge(
    "nodes_count", "Number of nodes in cluster.", ["node_type"]
)
node_drain_count = _counter(
    "node_drain_total", "Number of nodes drained by rescheduler.",
    ["drain_state", "node"],
)
evictions_count = _counter(
    "evicted_pods_total", "Number of pods evicted by the rescheduler."
)

# --- additions (no reference equivalent) ---

plan_duration = _histogram(
    "plan_duration_seconds",
    "Wall time of one drain-plan solve.",
    ["solver"],
    (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.2, 0.5, 1.0, 5.0),
)
plan_candidates = _gauge(
    "plan_candidates", "Candidate on-demand nodes evaluated in the last solve."
)
unplaceable_pods = _gauge(
    "unplaceable_pods",
    "Evictable pods on candidate nodes whose scheduling constraints the "
    "planner does not model (treated as placeable nowhere).",
)
blocked_candidates = _gauge(
    "blocked_candidates",
    "Candidate on-demand nodes whose drain could not be approved this "
    "tick, by reason: unmodeled, pdb, non-replicated, no-capacity.",
    ["reason"],
)
BLOCKED_REASONS = ("unmodeled", "pdb", "non-replicated", "no-capacity")
solver_mode = _gauge(
    "solver_mode",
    "1 for the (configured, running) solver pair of the last solve.",
    ["configured", "running"],
)
repair_unavailable = _gauge(
    "repair_unavailable",
    "1 while the last solve ran without the repair phase the config "
    "asked for.",
)
solver_repair_chunks = _gauge(
    "solver_repair_chunks",
    "Spot chunks the repair phase of the last solve ran with (1 = "
    "unchunked, 0 = repair did not run).",
)
tick_phase_duration = _histogram(
    "tick_phase_duration_seconds",
    "Wall time of each housekeeping-tick phase (observe / plan-dispatch "
    "/ observe-metrics / plan-fetch / actuate, plus the aggregate plan "
    "phase).",
    ["phase"],
    (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0),
)
solver_delta_pack_lanes = _gauge(
    "solver_delta_pack_lanes",
    "Changed candidate lanes the last tick's delta wrote into the "
    "device-resident problem tensors.",
)
solver_full_repack = _counter(
    "solver_full_repack",
    "Ticks that uploaded the whole packed problem instead of a delta "
    "(cold cache, shape growth, or a failed delta apply).",
)
solver_delta_upload_bytes = _gauge(
    "solver_delta_upload_bytes",
    "Host-to-device bytes the last tick shipped.",
)
solver_chunks_solved = _gauge(
    "solver_chunks_solved",
    "Candidate-lane chunks the staged solver solved last tick.",
)
solver_chunks_skipped = _gauge(
    "solver_chunks_skipped",
    "Candidate-lane chunks skipped last tick (prefilter-eliminated or "
    "beyond the first feasible chunk under early exit).",
)
planner_fallback = _counter(
    "planner_fallback",
    "Ticks whose configured planner raised and were degraded to the CPU "
    "numpy-oracle fallback planner instead of crashing the loop.",
)
orphaned_taints_recovered = _counter(
    "orphaned_taints_recovered",
    "Orphaned ToBeDeleted taints removed by the crash-recovery sweep.",
)
rescheduler_degraded = _gauge(
    "rescheduler_degraded",
    "1 while the control loop is degraded (fallback planner, breaker "
    "engaged, stale mirror, or startup fell back to polling).",
)
mirror_staleness = _gauge(
    "mirror_staleness_seconds",
    "Age of the watch mirror at the last tick's freshness gate.",
)
freshness_bypass = _counter(
    "freshness_bypass",
    "Ticks whose freshness gate bypassed a stale watch mirror with a "
    "direct LIST.",
)
mirror_stale_planned = _counter(
    "mirror_stale_planned",
    "Ticks skipped because the mirror aged past the staleness budget "
    "between the gate and the plan.",
)
plan_schedule_len = _gauge(
    "plan_schedule_len",
    "Drain steps in the last cut drain-to-exhaustion schedule.",
)
schedule_invalidated = _counter(
    "schedule_invalidated",
    "Drain-schedule tails invalidated before execution by churn or a "
    "failed from-scratch re-proof.",
)
kube_request_retries = _counter(
    "kube_request_retries",
    "Transient kube API read failures (HTTP 429/5xx, connection "
    "reset/timeout) retried with jittered exponential backoff (reads "
    "only; writes are single-attempt).",
)
kube_request_failures = _counter(
    "kube_request_failures",
    "Kube API reads that exhausted the transient-retry budget and "
    "surfaced their error to the caller.",
)
watch_events = _counter(
    "watch_events",
    "Object events (ADDED/MODIFIED/DELETED) applied to a watch cache.",
    ["resource"],
)
watch_relists = _counter(
    "watch_relists",
    "Full re-LISTs a watcher performed: the seeding LIST, 410-Gone "
    "recovery and post-error reconciliation.",
    ["resource"],
)
watch_stream_errors = _counter(
    "watch_stream_errors",
    "Watch streams that died with a transport or protocol error and were "
    "reconnected after a backed-off re-LIST.",
    ["resource"],
)
watch_stalls = _counter(
    "watch_stalls",
    "Watch streams killed by the client-side progress deadline: open but "
    "silent past watch_progress_deadline.",
    ["resource"],
)
watch_drift = _counter(
    "watch_drift",
    "Objects the anti-entropy resync audit found field-level diverged "
    "between a fresh LIST and the watch mirror.",
    ["resource"],
)
watch_presence_heals = _counter(
    "watch_presence_heals",
    "Objects the audit added or removed to re-sync mirror presence with "
    "a fresh LIST.",
    ["resource"],
)
resync_audits = _counter(
    "resync_audits",
    "Completed anti-entropy audits (one LIST per resource diffed against "
    "the watch mirror).",
)
observe_delta_events = _gauge(
    "observe_delta_events",
    "Watch deltas drained into the columnar mirror at the last tick's "
    "freeze.",
)


def update_nodes_map(on_demand_label: str, spot_label: str, n_on_demand: int, n_spot: int) -> None:
    """reference metrics/metrics.go:73-80 (labels carry the configured
    node-class label strings, as in the reference)."""
    nodes_count.labels(on_demand_label).set(n_on_demand)
    nodes_count.labels(spot_label).set(n_spot)


def update_node_pods_count(node_type: str, node_name: str, num_pods: int) -> None:
    node_pods_count.labels(node_type, node_name).set(num_pods)


def update_evictions_count() -> None:
    evictions_count.inc()


def update_node_drain_count(state: str, node_name: str) -> None:
    node_drain_count.labels(state, node_name).inc()


def observe_plan_duration(solver: str, seconds: float, candidates: int) -> None:
    plan_duration.labels(solver).observe(seconds)
    plan_candidates.set(candidates)


def observe_tick_phase(phase: str, seconds: float) -> None:
    tick_phase_duration.labels(phase).observe(seconds)


_last_solver_mode = [None]  # (configured, running) of the previous solve


def update_solver_mode(
    configured: str,
    running: str,
    repair_dropped: bool,
    repair_chunks: int | None = None,
) -> None:
    """Expose what the last solve actually ran. The previous label pair
    is zeroed (not removed) so dashboards see a clean 1-of-N encoding.
    ``repair_chunks`` None leaves its gauge untouched."""
    prev = _last_solver_mode[0]
    if prev is not None and prev != (configured, running):
        solver_mode.labels(*prev).set(0)
    solver_mode.labels(configured, running).set(1)
    _last_solver_mode[0] = (configured, running)
    repair_unavailable.set(1 if repair_dropped else 0)
    if repair_chunks is not None:
        solver_repair_chunks.set(repair_chunks)


def update_incremental_tick(report) -> None:
    """Mirror one PlanReport's incremental-pipeline telemetry into the
    gauges above (called by the control loop after each plan)."""
    if report.full_repack:
        solver_full_repack.inc()
    elif report.delta_pack_lanes >= 0:
        solver_delta_pack_lanes.set(report.delta_pack_lanes)
    if report.upload_bytes >= 0:
        solver_delta_upload_bytes.set(report.upload_bytes)
    if report.chunks_solved >= 0:
        solver_chunks_solved.set(report.chunks_solved)
        solver_chunks_skipped.set(report.chunks_skipped)


def update_planner_fallback() -> None:
    planner_fallback.inc()


def update_plan_schedule_len(n: int) -> None:
    plan_schedule_len.set(n)


def update_schedule_invalidated() -> None:
    schedule_invalidated.inc()


def update_taint_recovered() -> None:
    orphaned_taints_recovered.inc()


def update_degraded(degraded: bool) -> None:
    rescheduler_degraded.set(1 if degraded else 0)


def update_mirror_staleness(seconds: float) -> None:
    mirror_staleness.set(seconds)


def update_freshness_bypass() -> None:
    freshness_bypass.inc()


def update_mirror_stale_planned() -> None:
    mirror_stale_planned.inc()


def update_kube_request_retry() -> None:
    kube_request_retries.inc()


def update_kube_request_failure() -> None:
    kube_request_failures.inc()


def update_watch_event(resource: str) -> None:
    watch_events.labels(resource).inc()


def update_watch_relist(resource: str) -> None:
    watch_relists.labels(resource).inc()


def update_watch_stream_error(resource: str) -> None:
    watch_stream_errors.labels(resource).inc()


def update_watch_stall(resource: str) -> None:
    watch_stalls.labels(resource).inc()


def update_watch_drift(resource: str, n: int) -> None:
    watch_drift.labels(resource).inc(n)


def update_watch_presence_heal(resource: str, n: int) -> None:
    watch_presence_heals.labels(resource).inc(n)


def update_resync_audit() -> None:
    resync_audits.inc()


def update_observe_delta_events(n: int) -> None:
    observe_delta_events.set(n)


def update_conservatism(n_unplaceable: int, by_reason: dict) -> None:
    """Refresh the why-no-drain gauges after each solve. Every reason
    label is written every tick (absent -> 0) so a recovered cluster
    reads 0, not a stale count."""
    unplaceable_pods.set(n_unplaceable)
    for reason in BLOCKED_REASONS:
        blocked_candidates.labels(reason).set(int(by_reason.get(reason, 0)))


def robustness_snapshot() -> dict:
    """Current robustness counters (tests diff before/after; process
    counters are cumulative)."""
    return {
        "planner_fallback": planner_fallback.value(),
        "orphaned_taints_recovered": orphaned_taints_recovered.value(),
        "schedule_invalidated": schedule_invalidated.value(),
        "degraded": rescheduler_degraded.value(),
    }



def _families():
    """The store as ``prometheus_client`` metric families."""
    from prometheus_client.core import (
        CounterMetricFamily,
        GaugeMetricFamily,
        HistogramMetricFamily,
    )

    with _LOCK:
        snapshot = [(m, dict(m.values)) for m in _REGISTRY]
    for m, values in snapshot:
        name = f"{NAMESPACE}_{m.name}"
        if m.kind == "counter":
            fam = CounterMetricFamily(
                name.removesuffix("_total"), m.doc, labels=m.labelnames
            )
            for key, v in values.items():
                fam.add_metric(list(key), v)
        elif m.kind == "gauge":
            fam = GaugeMetricFamily(name, m.doc, labels=m.labelnames)
            for key, v in values.items():
                fam.add_metric(list(key), v)
        else:
            fam = HistogramMetricFamily(name, m.doc, labels=m.labelnames)
            for key, row in values.items():
                cum = [(repr(float(le)), row[i]) for i, le in enumerate(m.buckets)]
                cum.append(("+Inf", row[-2]))
                fam.add_metric(list(key), cum, sum_value=row[-1])
        yield fam


class _StoreCollector:
    def collect(self):
        return _families()


def serve(listen_address: str) -> None:
    """Start the metrics HTTP endpoint (reference rescheduler.go:126-130).
    Needs ``prometheus_client``; raises ImportError without it."""
    from prometheus_client import CollectorRegistry, start_http_server

    registry = CollectorRegistry()
    registry.register(_StoreCollector())
    host, _, port = listen_address.rpartition(":")
    start_http_server(int(port), addr=host or "localhost", registry=registry)

"""Metrics, held in process.

The port of the JAX package's ``metrics/registry.py``, as far as the
controller, the actuator, the planner and ``loop/health`` call it: the
reference's four series under namespace ``spot_rescheduler`` (reference
metrics/metrics.go:28-64), name for name and label for label, plus the
planner, robustness and freshness series the port's controller updates,
the kube client's and the watch mirror's (``io/kube``, ``io/watch``), and
the planner service's and its agents' (``service_*``, ``remote_*``:
``service/server.py``, ``service/agent.py``) with their windowed
queue-wait snapshots.

The values live in a small store of counters, gauges and histograms in
this module, so nothing here needs ``prometheus_client``. ``serve``
imports it when it is called and exposes the store over HTTP like the
reference's promhttp handler (rescheduler.go:126-130); without the
package it raises.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict, deque
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
solver_carry_chunks = _gauge(
    "solver_carry_chunks",
    "Carry chunks of the last solve's carry-streamed tier (the spot axis "
    "streamed in this many ordered chunks with narrow delta carries); "
    "0 = a wide-carry tier ran.",
)
solver_carry_bytes = _gauge(
    "solver_carry_bytes",
    "Estimated per-device resident carry bytes of the last dispatched "
    "solver program (the 'carries' term of solver/memory."
    "estimate_union_hbm_breakdown at the dispatched tier's layout).",
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


# --- the multi-tenant planner service and its agents ---

service_requests = _counter(
    "service_requests",
    "Plan requests the planner service accepted or refused, by outcome: "
    "ok (planned in a batch), rejected (depth/body caps before the body "
    "was read), expired (waited past the queue timeout and was evicted "
    "with 503 + Retry-After), error (decode or solve failure).",
    ["outcome"],
)
service_batch_lanes = _gauge(
    "service_batch_lanes",
    "Candidate lanes in the last batched solve, summed across the tenant "
    "lane-blocks that shared it.",
)
service_batch_tenants = _gauge(
    "service_batch_tenants",
    "Tenant lane-blocks sharing the last batched solve.",
)
service_queue_wait_ms = _histogram(
    "service_queue_wait_ms",
    "Milliseconds a plan request spent in the tenant queue before its "
    "batch dispatched.",
    [],
    (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 5000.0,
     30000.0),
)
service_tenant_evictions = _counter(
    "service_tenant_evictions",
    "Plan requests evicted from the service queue after waiting past the "
    "queue timeout, per tenant.",
    ["tenant"],
)
remote_planner_fallback = _counter(
    "remote_planner_fallback",
    "Agent ticks planned by the local numpy-oracle fallback because every "
    "configured planner endpoint was unusable.",
)
remote_planner_failover = _counter(
    "remote_planner_failover",
    "Agent ticks served by a planner endpoint after an earlier endpoint "
    "in the ordered list failed or was breaker-open.",
)
remote_wire_connection_reuse = _counter(
    "remote_wire_connection_reuse",
    "Agent plan requests served over an already-established pooled "
    "keep-alive connection.",
)
remote_wire_reconnects = _counter(
    "remote_wire_reconnects",
    "Pooled keep-alive sockets found stale and replaced by one retry on a "
    "fresh connection.",
)
service_delta_requests = _counter(
    "service_delta_requests",
    "Delta-shipping plan requests by outcome: applied, or resync (the "
    "service demanded one full pack).",
    ["outcome"],
)
service_wire_ingest_bytes = _counter(
    "service_wire_ingest_bytes",
    "Request-body bytes the planner service ingested on /v2/plan.",
)
service_tenant_cache = _gauge(
    "service_tenant_cache_entries",
    "Tenants with packed state cached for the delta wire.",
)
service_admission_shed = _counter(
    "service_admission_shed",
    "Plan requests the planner service shed, by the admission edge that "
    "refused them: max-inflight, queue-timeout, deadline, drain-refuse, "
    "drain-evict, resync-storm.",
    ["reason"],
)
# every reason the counter above can carry, in one importable place:
# bench/fleet_twin.induce_shed_edges enumerates THIS tuple, so a reason
# added here without a recipe that fires it fails the fleet smokes
SHED_REASONS = (
    "max-inflight",
    "queue-timeout",
    "deadline",
    "drain-refuse",
    "drain-evict",
    "resync-storm",
)
service_resync_ingest_admitted = _counter(
    "service_resync_ingest_admitted",
    "Full-pack resync ingests admitted through the bounded resync "
    "admission class.",
)
service_resync_ingest_inflight = _gauge(
    "service_resync_ingest_inflight",
    "Full-pack resync ingests currently holding an admission token.",
)
service_resync_ingest_ledger = _gauge(
    "service_resync_ingest_ledger_bytes",
    "Estimated device bytes committed by in-flight resync ingests.",
)
service_bucket_compile_hits = _counter(
    "service_bucket_compile_hits",
    "Batched solves whose stacked shape family this process had already "
    "solved.",
)
service_bucket_compile_misses = _counter(
    "service_bucket_compile_misses",
    "Batched solves that were the first of their stacked shape family in "
    "this process.",
)
service_batch_occupancy = _gauge(
    "service_batch_occupancy",
    "Tenant lane-blocks in the last batched solve as a fraction of the "
    "batch cap for its bucket.",
)
service_queue_wait_p50 = _gauge(
    "service_queue_wait_p50_ms",
    "Median queue wait over the recent window (all tenants pooled).",
)
service_queue_wait_p99 = _gauge(
    "service_queue_wait_p99_ms",
    "p99 queue wait over the recent window (all tenants pooled).",
)
service_device_sick = _gauge(
    "service_device_sick",
    "1 while the planner service's device-health watchdog holds the "
    "accelerator sick and batches are served by the numpy-oracle host "
    "path.",
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
    carry_chunks: int | None = None,
    carry_bytes: int | None = None,
) -> None:
    """Expose what the last solve actually ran. The previous label pair
    is zeroed (not removed) so dashboards see a clean 1-of-N encoding
    and a reroute is a visible edge. ``repair_chunks``, ``carry_chunks``
    and ``carry_bytes`` mirror the dispatch decision into their gauges;
    None (or a negative ``carry_bytes``: no estimate) leaves a gauge
    untouched."""
    prev = _last_solver_mode[0]
    if prev is not None and prev != (configured, running):
        solver_mode.labels(*prev).set(0)
    solver_mode.labels(configured, running).set(1)
    _last_solver_mode[0] = (configured, running)
    repair_unavailable.set(1 if repair_dropped else 0)
    if repair_chunks is not None:
        solver_repair_chunks.set(repair_chunks)
    if carry_chunks is not None:
        solver_carry_chunks.set(carry_chunks)
    if carry_bytes is not None and carry_bytes >= 0:
        solver_carry_bytes.set(carry_bytes)


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


def conservatism_snapshot() -> dict:
    """The why-no-drain gauges' current values (test and bench
    readback): ``unplaceable_pods`` and ``blocked``, reason -> value, for
    every reason written so far."""
    return {
        "unplaceable_pods": unplaceable_pods.value(),
        "blocked": _by_label(blocked_candidates),
    }


def robustness_snapshot() -> dict:
    """Current robustness counters (tests diff before/after; process
    counters are cumulative)."""
    return {
        "planner_fallback": planner_fallback.value(),
        "orphaned_taints_recovered": orphaned_taints_recovered.value(),
        "schedule_invalidated": schedule_invalidated.value(),
        "degraded": rescheduler_degraded.value(),
    }


def _counter_value(counter) -> float:
    """An unlabeled counter's value (0 when never incremented)."""
    return counter.value()


def _labeled_counter_total(counter) -> float:
    """A labeled counter summed over every label value written."""
    with _LOCK:
        return float(sum(counter.values.values()))


def freshness_snapshot() -> dict:
    """Current watch-liveness/freshness counters (tests and the soak
    harness diff before/after; labeled counters are summed across
    resources)."""
    return {
        "watch_events": _labeled_counter_total(watch_events),
        "watch_relists": _labeled_counter_total(watch_relists),
        "watch_stream_errors": _labeled_counter_total(watch_stream_errors),
        "watch_stalls": _labeled_counter_total(watch_stalls),
        "watch_drift": _labeled_counter_total(watch_drift),
        "watch_presence_heals": _labeled_counter_total(watch_presence_heals),
        "resync_audits": _counter_value(resync_audits),
        "freshness_bypass": _counter_value(freshness_bypass),
        "mirror_stale_planned": _counter_value(mirror_stale_planned),
        "mirror_staleness_seconds": mirror_staleness.value(),
        "observe_delta_events": observe_delta_events.value(),
    }



# run maxima of the batch gauges and of concurrent resync ingests
_service_batch_max = {"lanes": 0, "tenants": 0}
_resync_ingest_max = {"inflight": 0}

# windowed queue waits: a bounded ring per tenant (LRU past the tenant
# cap; tenant ids are client-supplied) and one pooled ring
WAIT_WINDOW = 128
WAIT_TENANTS_MAX = 4096
_tenant_waits: "OrderedDict[str, deque]" = OrderedDict()
_window_waits: deque = deque(maxlen=4096)
_tenant_served: "OrderedDict[str, int]" = OrderedDict()


def _percentile(values, q: float) -> float:
    """Nearest-rank percentile (0 when empty)."""
    if not values:
        return 0.0
    ranked = sorted(values)
    idx = min(len(ranked) - 1, max(0, int(math.ceil(q * len(ranked))) - 1))
    return float(ranked[idx])


def jain_fairness(shares) -> float:
    """Jain's fairness index over per-tenant shares (1.0 when empty)."""
    vals = [float(v) for v in shares]
    total = sum(vals)
    if not vals or total <= 0:
        return 1.0
    return (total * total) / (len(vals) * sum(v * v for v in vals))


def _note_tenant_wait(tenant: str, wait_ms: float) -> None:
    with _LOCK:
        ring = _tenant_waits.get(tenant)
        if ring is None:
            ring = _tenant_waits[tenant] = deque(maxlen=WAIT_WINDOW)
        ring.append(wait_ms)
        _tenant_waits.move_to_end(tenant)
        _tenant_served[tenant] = _tenant_served.get(tenant, 0) + 1
        _tenant_served.move_to_end(tenant)
        while len(_tenant_waits) > WAIT_TENANTS_MAX:
            _tenant_waits.popitem(last=False)
        while len(_tenant_served) > WAIT_TENANTS_MAX:
            _tenant_served.popitem(last=False)
        _window_waits.append(wait_ms)


def update_service_request(outcome: str) -> None:
    service_requests.labels(outcome).inc()


def update_service_admission_shed(reason: str) -> None:
    """One request shed at an admission edge (the caller fires the
    flight shed event with the same reason from the same site)."""
    service_admission_shed.labels(reason).inc()


def update_service_bucket_compile(first: bool) -> None:
    if first:
        service_bucket_compile_misses.inc()
    else:
        service_bucket_compile_hits.inc()


def update_service_batch(lanes: int, tenants: int, waits,
                         occupancy=None) -> None:
    """One batched solve dispatched: the batch gauges, each member's
    queue wait (``waits``: (tenant, wait_ms) pairs) and the windowed
    percentile gauges."""
    service_batch_lanes.set(int(lanes))
    service_batch_tenants.set(int(tenants))
    _service_batch_max["lanes"] = max(_service_batch_max["lanes"], int(lanes))
    _service_batch_max["tenants"] = max(
        _service_batch_max["tenants"], int(tenants)
    )
    if occupancy is not None:
        service_batch_occupancy.set(float(occupancy))
    for tenant, w in waits:
        service_queue_wait_ms.labels().observe(float(w))
        _note_tenant_wait(str(tenant), float(w))
    with _LOCK:
        window = list(_window_waits)
    service_queue_wait_p50.set(_percentile(window, 0.50))
    service_queue_wait_p99.set(_percentile(window, 0.99))


def service_tenant_wait_snapshot(top: int = 0) -> dict:
    """Windowed per-tenant queue-wait percentiles ``{tenant: {p50_ms,
    p99_ms, n}}``; ``top`` > 0 keeps the worst ``top`` tenants by p99."""
    with _LOCK:
        rings = [(t, list(r)) for t, r in _tenant_waits.items()]
    out = {
        tenant: {
            "p50_ms": round(_percentile(vals, 0.50), 3),
            "p99_ms": round(_percentile(vals, 0.99), 3),
            "n": len(vals),
        }
        for tenant, vals in rings
    }
    if top and len(out) > top:
        out = dict(sorted(out.items(), key=lambda kv: kv[1]["p99_ms"],
                          reverse=True)[:top])
    return out


def service_queue_wait_summary(top: int = 16) -> dict:
    """The pooled windowed percentiles plus the worst tenants' (the
    block /healthz embeds)."""
    with _LOCK:
        vals = list(_window_waits)
    return {
        "p50_ms": round(_percentile(vals, 0.50), 3),
        "p99_ms": round(_percentile(vals, 0.99), 3),
        "n": len(vals),
        "tenants": service_tenant_wait_snapshot(top=top),
    }


def reset_service_window() -> None:
    """Clear the windowed wait rings and served-count shares (the fleet
    twin resets at phase boundaries so each occupancy point's
    percentiles are its own; tests reset for isolation) and the
    concurrent-resync-ingest high-water. Cumulative counters and the
    batch run maxima are untouched."""
    with _LOCK:
        _tenant_waits.clear()
        _window_waits.clear()
        _tenant_served.clear()
        _resync_ingest_max["inflight"] = 0
    service_queue_wait_p50.set(0.0)
    service_queue_wait_p99.set(0.0)


def update_service_tenant_eviction(tenant: str) -> None:
    service_tenant_evictions.labels(tenant).inc()


def update_remote_planner_fallback() -> None:
    remote_planner_fallback.inc()


def update_remote_planner_failover() -> None:
    remote_planner_failover.inc()


def update_remote_wire_reuse() -> None:
    remote_wire_connection_reuse.inc()


def update_remote_wire_reconnect() -> None:
    remote_wire_reconnects.inc()


def update_service_device_sick(sick: bool) -> None:
    service_device_sick.set(1 if sick else 0)


def update_service_delta(outcome: str) -> None:
    service_delta_requests.labels(outcome).inc()


def update_service_wire_ingest(nbytes: int) -> None:
    service_wire_ingest_bytes.inc(max(0, int(nbytes)))


def update_service_tenant_cache(entries: int) -> None:
    service_tenant_cache.set(int(entries))


def update_service_resync_ingest(inflight: int, ledger_bytes: int,
                                 admitted: bool = False) -> None:
    """Resync-ingest admission occupancy changed (``admitted``: one more
    ingest was let in)."""
    if admitted:
        service_resync_ingest_admitted.inc()
    service_resync_ingest_inflight.set(int(inflight))
    service_resync_ingest_ledger.set(max(0, int(ledger_bytes)))
    _resync_ingest_max["inflight"] = max(
        _resync_ingest_max["inflight"], int(inflight)
    )


def _by_label(metric) -> dict:
    with _LOCK:
        return {key[0]: float(v) for key, v in metric.values.items()}


def service_snapshot() -> dict:
    """The service's and the agents' counters and gauges (tests and the
    chip smoke diff before/after), with the run's batch high-water marks
    and the windowed queue waits."""
    with _LOCK:
        window = list(_window_waits)
        served = list(_tenant_served.values())
    return {
        "requests": _by_label(service_requests),
        "batch_lanes": service_batch_lanes.value(),
        "batch_tenants": service_batch_tenants.value(),
        "batch_lanes_max": _service_batch_max["lanes"],
        "batch_tenants_max": _service_batch_max["tenants"],
        "batch_occupancy": service_batch_occupancy.value(),
        "tenant_evictions": sum(_by_label(service_tenant_evictions).values()),
        "remote_planner_fallback": remote_planner_fallback.value(),
        "remote_planner_failover": remote_planner_failover.value(),
        "wire_connection_reuse": remote_wire_connection_reuse.value(),
        "wire_reconnects": remote_wire_reconnects.value(),
        "device_sick": service_device_sick.value(),
        "delta_requests": _by_label(service_delta_requests),
        "wire_ingest_bytes": service_wire_ingest_bytes.value(),
        "tenant_cache_entries": service_tenant_cache.value(),
        "admission_shed": _by_label(service_admission_shed),
        "resync_ingest_admitted": service_resync_ingest_admitted.value(),
        "resync_ingest_inflight": service_resync_ingest_inflight.value(),
        "resync_ingest_inflight_max": _resync_ingest_max["inflight"],
        "resync_ingest_ledger_bytes": service_resync_ingest_ledger.value(),
        "compile_hits": service_bucket_compile_hits.value(),
        "compile_misses": service_bucket_compile_misses.value(),
        "queue_wait_p50_ms": round(_percentile(window, 0.50), 3),
        "queue_wait_p99_ms": round(_percentile(window, 0.99), 3),
        "tenant_queue_wait": service_tenant_wait_snapshot(),
        "jain_served": round(jain_fairness(served), 4),
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

"""Streaming spot-interruption replay (BASELINE.md config 5).

The port of the JAX package's ``bench/replay.py``, planning with the
port's ``TorchSolverPlanner`` on ``device`` (``cuda`` unless the caller
passes ``cpu``; a fault of the card's kernels ends the run).

Replays a timed stream of spot add/remove events against the fake cluster
while the housekeeping loop keeps re-planning on its 10 s cadence — the
reference's level-triggered design under churn (its recovery story is
"every tick recomputes from observed cluster state", SURVEY.md §5.3).
Measures rolling re-plan latency and drain activity; displaced pods from
interrupted nodes re-enter as unschedulable and gate the loop exactly as
the reference's unschedulable-pods gate does (rescheduler.go:172-181).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
    CONFIGS,
    REPLAY_CONSTRAINED,
    generate_replay,
)
from k8s_spot_rescheduler_tpu_torch.loop.controller import Rescheduler
from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
    TorchSolverPlanner,
)
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig


def run_replay(
    config: ReschedulerConfig,
    *,
    config_id: int = 5,
    n_events: int = 1000,
    seed: int = 0,
    constrained: bool = False,
    on_packed=None,
    device=None,
) -> Dict[str, float]:
    """Returns summary stats of a full replay run.

    ``constrained`` swaps in the REPLAY_CONSTRAINED spec — config-5
    churn with the full predicate surface loaded on (taints,
    anti-affinity groups, PDBs, sparse hostname/zone hard spread) — and
    additionally tracks the safety invariant: a pod evicted by OUR
    drain that fails to re-place immediately is a STRANDING (the plan
    proved its placement); pods displaced by spot interruptions may
    legitimately pend (capacity vanished). Conservatism gauge values
    (metrics/registry.py) ride along in the stats."""
    spec = REPLAY_CONSTRAINED if constrained else CONFIGS[config_id]
    client, events = generate_replay(spec, n_events, seed)
    # drains every cooldown-free tick so churn keeps being consolidated.
    # schedule_horizon=0 (the documented opt-out): this benchmark's
    # metric IS per-tick replan latency under event-stream churn — the
    # regime where the controller's churn hysteresis parks schedules
    # anyway — so the harness pins the per-tick path the metric names
    config = dataclasses.replace(
        config, node_drain_delay=0.0, schedule_horizon=0
    )
    planner = TorchSolverPlanner(config, device=device)
    r = Rescheduler(
        client, planner, config, clock=client.clock, recorder=client
    )

    plan_ms: List[float] = []
    drained = 0
    displaced = 0
    interruptions = 0
    stranded_by_drain = 0
    i = 0
    t_end = events[-1].at if events else 0.0
    now = 0.0
    while now < t_end:
        now += config.housekeeping_interval
        while i < len(events) and events[i].at <= now:
            ev = events[i]
            if ev.kind == "remove_spot":
                gone = client.remove_node(ev.node_name)
                displaced += len(gone)
                interruptions += 1
                for pod in gone:
                    # interrupted pods come back as pending reschedules
                    client.pending.append(dataclasses.replace(pod, node_name=""))
                client.retry_pending()
            else:
                client.add_node(ev.node)
            i += 1
        client.clock.advance(config.housekeeping_interval)
        evictions_before = len(client.evictions)
        result = r.tick()
        if on_packed is not None:
            # chain-depth analyzer tap (id-deduplicates skipped ticks)
            on_packed(getattr(planner, "last_packed", None))
        if result.report is not None:
            plan_ms.append(result.report.solve_seconds * 1e3)
        drained += len(result.drained)
        if result.drained:
            # the proven-placement invariant: none of THIS tick's drain
            # evictions may end the tick pending
            tick_evicted = set(client.evictions[evictions_before:])
            stranded_by_drain += sum(
                1 for p in client.pending if p.uid in tick_evicted
            )

    stats = {
        "ticks": len(plan_ms),
        "events": float(len(events)),
        "interruptions": float(interruptions),
        "displaced_pods": float(displaced),
        "drained_nodes": float(drained),
        "replan_ms_p50": float(np.median(plan_ms)) if plan_ms else 0.0,
        "replan_ms_p99": (
            float(np.percentile(plan_ms, 99)) if plan_ms else 0.0
        ),
        "pending_at_end": float(len(client.pending)),
        "stranded_by_drain": float(stranded_by_drain),
    }
    if constrained:
        snap = metrics.conservatism_snapshot()
        stats["unplaceable_pods_gauge"] = float(snap["unplaceable_pods"])
        stats["blocked_unmodeled_gauge"] = float(
            snap["blocked"].get("unmodeled", 0.0)
        )
    return stats

"""``--serve-smoke`` and ``--sched-smoke``: the root ``bench.py``'s
planner-service and drain-schedule smokes, on the port's service and
planner.

``serve_smoke`` (the reference's ``serve_smoke``): ``n_tenants``
synthetic tenants (config 2 cut to 8 on-demand and 8 spot nodes, 80
pods) plan solo through one ``TorchSolverPlanner`` on ``device`` (the
single-tenant truth), then together through a ``ServiceServer`` on
``device`` over real HTTP (``RemotePlanner`` agents, a 0.5 s batch
window, so they co-batch on kernels B1t/B2t). Then three delta-wire
ticks: quiet (empty deltas), churn (one pod removed a tenant) and a
forced resync (the service's tenant cache dropped), each held to the
solo plan; then the pooled-reuse phase: one agent runs ``reuse_ticks``
sequential ticks on the pooled keep-alive socket against
``fresh_ticks`` ticks of the fresh-connection-per-call baseline
(``RemotePlanner._transport_urllib``). ``ok`` is the reference's: every
selection solo-identical, no fallback, a batch of two tenants or more
carrying more lanes than any one tenant, one trace tree a tenant with
the agent's and the service's spans, the wire bytes of each tick
(fixed-size quiet deltas, churn under half a full pack, a resync over
0.9 of one, one resync a tenant), and the reuse counts plus the
reference's ``span_wire_pooled_ms < span_wire_fresh_ms``. That last
check is a wall-clock race; ``reuse_counts_ok`` is the rest of
``reuse_ok`` alone. The batch maxima are this service's own
(``PlannerService.batch_log``), not the process's run maxima.

``sched_smoke`` (the reference's ``sched_smoke``), three cases on a
quality cluster: (1) schedules on against the per-tick planner drained
to exhaustion (equal drains, planner fetches within ``ceil(drains /
horizon) + 2``, no invalidation on the quiescent run), and a spot node
removed under a pending schedule invalidating it (flight delta ==
metric delta) with the next tick re-planning; (2) the same cut through a
``ServiceServer`` over HTTP (wire v3) bit-identical to the local
``plan_schedule`` cut, with the span tree; (3) the primary replica
killed under a partly executed schedule: the in-flight steps run with
no wire traffic, the next cut fails over to the secondary (failover
metric == flight event, no local fallback). The reference plans these
on its numpy oracle; here every planner and replica runs
``solver="torch"`` on ``device``, whose plans equal the oracle's bit for
bit (B1/B2 for the local cuts, B1t/B2t for the served ones).

Each ``run_*`` returns (exit code, row) with the reference's metric and
row keys.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time

import numpy as np

from k8s_spot_rescheduler_tpu_torch.bench.smoke import span_ms_median

REUSE_TICKS = 100  # the reference's pooled-reuse phase
FRESH_TICKS = 25  # and its fresh-connection baseline
TRACE_SPANS = ("plan.pack", "wire.request", "service.queue-wait",
               "service.solve", "wire.transfer")


def serve_spec():
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import CONFIGS

    return dataclasses.replace(CONFIGS[2], name="serve-smoke",
                               n_on_demand=8, n_spot=8, n_pods=80)


def selection(report) -> tuple:
    """(found, drained node, {pod uid: spot node}) of a plan report."""
    if report.plan is None:
        return (False, None, None)
    return (True, report.plan.node.node.name, dict(report.plan.assignments))


def selection_json(sel: tuple) -> list:
    """A selection as JSON: [found, node, [[pod uid, spot node], ...]]."""
    found, node, assign = sel
    return [found, node, sorted([k, v] for k, v in (assign or {}).items())]


def serve_smoke(n_tenants: int = 4, seed: int = 0, device=None,
                reuse_ticks: int = REUSE_TICKS,
                fresh_ticks: int = FRESH_TICKS) -> dict:
    """The multi-tenant service acceptance core (module docstring)."""
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import generate_cluster
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.service.agent import RemotePlanner
    from k8s_spot_rescheduler_tpu_torch.service.server import ServiceServer
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    spec = serve_spec()
    cfg = ReschedulerConfig(resources=spec.resources, solver="torch")
    tenants = []
    for i in range(n_tenants):
        client = generate_cluster(spec, seed + i)
        store = client.columnar_store(
            cfg.resources,
            on_demand_label=cfg.on_demand_node_label,
            spot_label=cfg.spot_node_label,
        )
        tenants.append((store, client.list_pdbs()))

    # solo truth: ONE planner instance planning each tenant in turn
    solo = TorchSolverPlanner(cfg, device=device)
    solo_sel = [selection(solo.plan(store, pdbs)) for store, pdbs in tenants]
    solo_lanes = [
        int(np.asarray(store.pack(pdbs)[0].cand_valid).sum())
        for store, pdbs in tenants
    ]

    before = metrics.service_snapshot()
    server = ServiceServer(
        cfg, "127.0.0.1:0", batch_window_s=0.5,
        # every tenant must be admitted: the smoke tests batching, not
        # the depth cap
        max_inflight=max(16, 2 * n_tenants), device=device,
    )
    server.start_background()
    svc = server.service
    agents = [
        RemotePlanner(cfg, f"http://{server.address}", tenant=f"tenant-{i}")
        for i in range(n_tenants)
    ]

    def fleet_tick():
        ticked = [None] * n_tenants
        times = [0.0] * n_tenants
        gate = threading.Barrier(n_tenants)

        def run(i):
            store, pdbs = tenants[i]
            gate.wait()
            t0 = time.perf_counter()
            ticked[i] = agents[i].plan(store, pdbs)
            times[i] = (time.perf_counter() - t0) * 1e3

        ts = [threading.Thread(target=run, args=(i,))
              for i in range(n_tenants)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return ticked, times

    def ingest_bytes():
        return metrics.service_snapshot()["wire_ingest_bytes"]

    def resyncs():
        return metrics.service_snapshot()["delta_requests"].get("resync", 0)

    def check_tick(note, reports, bad):
        for i, report in enumerate(reports):
            store, pdbs = tenants[i]
            want = selection(solo.plan(store, pdbs))
            got = selection(report)
            if got != want or report.solver != "remote":
                bad.append({"tick": note, "tenant": i,
                            "solo": selection_json(want),
                            "served": selection_json(got),
                            "solver": report.solver})

    try:
        results, times = fleet_tick()
        traces = [a.last_trace for a in agents]
        first_batches = len(svc.batch_log)

        # delta-wire steady state (wire v4): quiet, churn, forced resync
        delta_bad: list = []
        full_tick_bytes = ingest_bytes() - before.get("wire_ingest_bytes", 0)
        b0 = ingest_bytes()
        check_tick("quiet", fleet_tick()[0], delta_bad)
        quiet_tick_bytes = ingest_bytes() - b0
        quiet_cobatch = max(
            (len(set(b["tenants"])) for b in list(svc.batch_log)[first_batches:]),
            default=0,
        )
        for i in range(n_tenants):  # small churn: one pod a tenant
            store = tenants[i][0]
            store.remove_pod(next(iter(store._pod_row)))
        b1 = ingest_bytes()
        check_tick("churn", fleet_tick()[0], delta_bad)
        churn_tick_bytes = ingest_bytes() - b1
        resyncs_before = resyncs()
        svc.invalidate_tenant_cache()
        b2 = ingest_bytes()
        check_tick("forced-resync", fleet_tick()[0], delta_bad)
        resync_tick_bytes = ingest_bytes() - b2
        forced_resyncs = resyncs() - resyncs_before
        cobatch_log = list(svc.batch_log)

        # persistent-wire reuse: one agent, sequential ticks on the
        # pooled socket, against the fresh-connection-per-call baseline
        svc.batch_window_s = 0.0  # solo ticks: nothing to co-batch
        wire_agent = RemotePlanner(cfg, f"http://{server.address}",
                                   tenant="wire-reuse")
        wire_store, wire_pdbs = tenants[0]
        r0 = metrics.service_snapshot()
        pooled_traces, reuse_bad = [], []
        for _ in range(reuse_ticks):
            rep = wire_agent.plan(wire_store, wire_pdbs)
            if rep.solver != "remote":
                reuse_bad.append(rep.solver)
            pooled_traces.append(wire_agent.last_trace)
        r1 = metrics.service_snapshot()
        reuse_delta = r1["wire_connection_reuse"] - r0["wire_connection_reuse"]
        reuse_reconnects = r1["wire_reconnects"] - r0["wire_reconnects"]
        pooled_conns = wire_agent._wire_pool.connection_count()
        pooled_wire_ms = span_ms_median(pooled_traces[1:], "wire.request")
        fresh_agent = RemotePlanner(cfg, f"http://{server.address}",
                                    tenant="wire-reuse")
        fresh_agent.transport = fresh_agent._transport_urllib
        fresh_traces = []
        for _ in range(fresh_ticks):
            fresh_agent.plan(wire_store, wire_pdbs)
            fresh_traces.append(fresh_agent.last_trace)
        fresh_wire_ms = span_ms_median(fresh_traces[1:], "wire.request")
    finally:
        server.close()
    reuse_counts_ok = (
        not reuse_bad
        and reuse_delta >= reuse_ticks - 1
        and reuse_reconnects == 0
        and pooled_conns == 1
    )
    pooled_faster = pooled_wire_ms < fresh_wire_ms
    reuse_ok = reuse_counts_ok and pooled_faster

    wire_ok = (
        quiet_tick_bytes < n_tenants * 2048
        and 0 < churn_tick_bytes < 0.5 * full_tick_bytes
        and resync_tick_bytes > 0.9 * full_tick_bytes
        and forced_resyncs == n_tenants
        and quiet_cobatch >= 2  # delta ticks still co-batch
    )

    after = metrics.service_snapshot()
    mismatches = []
    for i, report in enumerate(results):
        got = selection(report)
        if got != solo_sel[i] or report.solver != "remote":
            mismatches.append({"tenant": i,
                               "solo": selection_json(solo_sel[i]),
                               "served": selection_json(got),
                               "solver": report.solver})
    fallbacks = (
        after["remote_planner_fallback"] - before["remote_planner_fallback"]
    )
    # this service's batch maxima (the process-wide gauges keep the run
    # maxima of every service the process ever ran)
    batch_tenants_max = max(
        (len(set(b["tenants"])) for b in cobatch_log), default=0
    )
    batch_lanes_max = max((int(b["lanes"]) for b in cobatch_log), default=0)
    cobatched = batch_tenants_max >= 2
    lanes_prove = batch_lanes_max > max(solo_lanes)
    trace_bad = []
    for i, trace in enumerate(traces):
        if trace is None or not trace.trace_id:
            trace_bad.append({"tenant": i, "why": "no trace recorded"})
            continue
        missing = {n for n in TRACE_SPANS if not trace.find(n)}
        if missing:
            trace_bad.append({"tenant": i, "missing": sorted(missing)})
    ok = (
        not mismatches and fallbacks == 0 and cobatched and lanes_prove
        and not trace_bad and wire_ok and not delta_bad and reuse_ok
    )
    d_before = before.get("delta_requests", {})
    applied = after["delta_requests"].get("applied", 0) - d_before.get(
        "applied", 0)
    resyncs_total = after["delta_requests"].get("resync", 0) - d_before.get(
        "resync", 0)
    return {
        "ok": ok,
        "n_tenants": n_tenants,
        "serve_ms": round(float(np.median(times)), 2),
        "full_tick_bytes": int(full_tick_bytes),
        "quiet_tick_bytes": int(quiet_tick_bytes),
        "churn_tick_bytes": int(churn_tick_bytes),
        "resync_tick_bytes": int(resync_tick_bytes),
        "wire_bytes_per_tick": int(
            np.median([quiet_tick_bytes, churn_tick_bytes])
        ),
        "delta_applied": int(applied),
        "delta_resyncs": int(resyncs_total),
        "forced_resyncs": int(forced_resyncs),
        "cache_hit_rate": round(
            applied / max(1.0, applied + resyncs_total), 3
        ),
        "delta_mismatches": delta_bad,
        "wire_ok": wire_ok,
        "reuse_ticks": reuse_ticks,
        "fresh_ticks": fresh_ticks,
        "wire_reuse": int(reuse_delta),
        "wire_reconnects": int(reuse_reconnects),
        "wire_pooled_conns": int(pooled_conns),
        "span_wire_pooled_ms": round(pooled_wire_ms, 3),
        "span_wire_fresh_ms": round(fresh_wire_ms, 3),
        "reuse_counts_ok": reuse_counts_ok,
        "reuse_ok": reuse_ok,
        "batch_tenants_max": int(batch_tenants_max),
        "batch_lanes_max": int(batch_lanes_max),
        "quiet_cobatch": int(quiet_cobatch),
        "batch_occupancy": round(batch_tenants_max / max(n_tenants, 1), 3),
        "solo_lanes": solo_lanes,
        "solo_lanes_max": max(solo_lanes),
        "selections": [selection_json(s) for s in solo_sel],
        "remote_fallbacks": int(fallbacks),
        "mismatches": mismatches,
        "span_queue_ms": round(span_ms_median(traces, "service.queue-wait"), 3),
        "span_solve_ms": round(span_ms_median(traces, "service.solve"), 3),
        "span_wire_ms": round(span_ms_median(traces, "wire.transfer"), 3),
        "trace_violations": trace_bad,
    }


SERVE_ROW_KEYS = (
    "n_tenants", "serve_ms", "batch_occupancy", "batch_tenants_max",
    "batch_lanes_max", "remote_fallbacks", "wire_bytes_per_tick",
    "full_tick_bytes", "quiet_tick_bytes", "delta_resyncs", "cache_hit_rate",
    "span_queue_ms", "span_solve_ms", "span_wire_ms", "wire_reuse",
    "wire_reconnects", "span_wire_pooled_ms", "span_wire_fresh_ms", "ok",
)


def run_serve_smoke(args, device, metric: str, unit: str) -> tuple:
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import progress

    r = serve_smoke(n_tenants=max(4, args.tenants), seed=args.seed,
                    device=device)
    progress(
        f"serve-smoke: {r['n_tenants']} tenants  serve_ms={r['serve_ms']}  "
        f"batch_tenants_max={r['batch_tenants_max']}  batch_lanes_max="
        f"{r['batch_lanes_max']} (solo max {r['solo_lanes_max']})  "
        f"fallbacks={r['remote_fallbacks']}  wire bytes full="
        f"{r['full_tick_bytes']} quiet={r['quiet_tick_bytes']} churn="
        f"{r['churn_tick_bytes']} resync={r['resync_tick_bytes']}  "
        f"cache_hit={r['cache_hit_rate']}  reuse={r['wire_reuse']}/"
        f"{r['reuse_ticks']} ticks (reconnects={r['wire_reconnects']}, wire "
        f"pooled={r['span_wire_pooled_ms']} vs fresh="
        f"{r['span_wire_fresh_ms']} ms)  spans queue={r['span_queue_ms']} "
        f"solve={r['span_solve_ms']} wire={r['span_wire_ms']} ms  -> "
        f"{'OK' if r['ok'] else 'FAIL'}"
    )
    row = {"metric": metric, "value": r["serve_ms"], "unit": unit}
    row.update({k: r[k] for k in SERVE_ROW_KEYS})
    # the port's row also carries the counts its chip check holds to the
    # JAX package's freeze
    row.update({k: r[k] for k in (
        "churn_tick_bytes", "resync_tick_bytes", "delta_applied",
        "forced_resyncs", "quiet_cobatch", "solo_lanes", "selections",
        "wire_pooled_conns", "reuse_ticks", "fresh_ticks",
        "reuse_counts_ok", "reuse_ok", "wire_ok", "mismatches",
        "delta_mismatches", "trace_violations")})
    return (0 if r["ok"] else 1), row


# --- sched-smoke -------------------------------------------------------------


def schedule_cut_json(handle) -> list:
    """A schedule handle's steps as [[index, n_feasible, *row], ...]."""
    if handle is None:
        return []
    return [[int(s.index), int(s.n_feasible), *(int(v) for v in s.row)]
            for s in handle.steps]


def sched_smoke(seed: int = 0, device=None) -> tuple:
    """The drain-schedule acceptance core (module docstring). Returns
    (stats, violations)."""
    from k8s_spot_rescheduler_tpu_torch.bench.quality import (
        _HintingPlanner,
        drain_to_exhaustion,
    )
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
        QUALITY_CONFIGS,
        generate_quality_cluster,
    )
    from k8s_spot_rescheduler_tpu_torch.loop import flight
    from k8s_spot_rescheduler_tpu_torch.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.service.agent import RemotePlanner
    from k8s_spot_rescheduler_tpu_torch.service.server import ServiceServer
    from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    violations: list = []
    name, spec = next(iter(QUALITY_CONFIGS.items()))
    horizon = 4

    # --- case 1: local parity + fetch bound -------------------------------
    base_cfg = ReschedulerConfig(
        solver="torch", resources=spec.resources, max_drains_per_tick=64
    )
    sched_cfg = dataclasses.replace(
        base_cfg, plan_schedule_enabled=True, schedule_horizon=horizon
    )
    inv0 = metrics.robustness_snapshot()["schedule_invalidated"]
    drains_base = drain_to_exhaustion(
        generate_quality_cluster(spec, seed, reschedule_evicted=True),
        base_cfg, device=device,
    )
    stats: dict = {}
    drains_sched = drain_to_exhaustion(
        generate_quality_cluster(spec, seed, reschedule_evicted=True),
        sched_cfg, planner_stats=stats, device=device,
    )
    fetches = stats.get("fetches_total", -1)
    lens = stats.get("schedule_lens", [])
    bound = math.ceil(max(drains_sched, 1) / horizon) + 2
    if drains_sched != drains_base:
        violations.append(
            f"schedule mode drained {drains_sched} != per-tick {drains_base}"
        )
    if fetches > bound:
        violations.append(
            f"fetches {fetches} > ceil({drains_sched}/{horizon})+2 = "
            f"{bound} — the O(1)-fetch claim failed"
        )
    inv_quiescent = (
        metrics.robustness_snapshot()["schedule_invalidated"] - inv0
    )
    if inv_quiescent:
        violations.append(f"{inv_quiescent} invalidation(s) on a quiescent run")

    # --- case 1b: churn invalidates, flight == metric ---------------------
    client = generate_quality_cluster(spec, seed, reschedule_evicted=True)
    churn_cfg = dataclasses.replace(
        sched_cfg, max_drains_per_tick=1, schedule_horizon=8,
        node_drain_delay=0.0,
    )
    inner = TorchSolverPlanner(churn_cfg, device=device)
    r = Rescheduler(client, _HintingPlanner(inner, client), churn_cfg,
                    clock=client.clock, recorder=client)
    m0 = metrics.robustness_snapshot()["schedule_invalidated"]
    f0 = flight.RECORDER.counts().get("schedule-invalidated", 0)
    client.clock.advance(1)
    first = r.tick()
    if not first.drained or first.report.schedule_len < 2:
        violations.append("churn case: first tick did not start a schedule")
    spot = next(
        n for n in client.nodes.values()
        if "spot" in "".join(f"{k}={v}" for k, v in n.labels.items())
    )
    client.remove_node(spot.name)
    client.clock.advance(1)
    second = r.tick()
    m_delta = metrics.robustness_snapshot()["schedule_invalidated"] - m0
    f_delta = flight.RECORDER.counts().get("schedule-invalidated", 0) - f0
    if m_delta < 1:
        violations.append("churn did not invalidate the schedule")
    if m_delta != f_delta:
        violations.append(
            f"flight delta {f_delta} != metric delta {m_delta} for "
            "schedule-invalidated"
        )
    if not second.drained:
        violations.append("post-invalidation tick failed to re-plan+drain")

    # --- case 2: service bit-identity + span tree -------------------------
    svc_cfg = ReschedulerConfig(
        solver="torch", resources=spec.resources,
        plan_schedule_enabled=True, schedule_horizon=6,
    )
    client2 = generate_quality_cluster(spec, seed, reschedule_evicted=True)
    store = client2.columnar_store(
        svc_cfg.resources,
        on_demand_label=svc_cfg.on_demand_node_label,
        spot_label=svc_cfg.spot_node_label,
    )
    pdbs = client2.list_pdbs()
    cut: list = []
    srv = ServiceServer(svc_cfg, "127.0.0.1:0", batch_window_s=0.0,
                        device=device)
    srv.start_background(scheduler=False)
    try:
        agent = RemotePlanner(svc_cfg, f"http://{srv.address}",
                              tenant="sched-smoke", clock=FakeClock())
        handle_remote = agent.plan_schedule(store, pdbs)
        handle_local = TorchSolverPlanner(
            svc_cfg, device=device).plan_schedule(store, pdbs)
        if handle_remote is None or handle_local is None:
            violations.append("service case: schedule cut failed")
        else:
            cut = schedule_cut_json(handle_local)
            if schedule_cut_json(handle_remote) != cut:
                violations.append(
                    "wire schedule differs from the local device cut"
                )
            trace = agent.last_trace
            want = {"plan.schedule", "wire.request", "service.solve"}
            have = {n for n in want if trace is not None and trace.find(n)}
            if want - have:
                violations.append(
                    f"service case: trace missing spans {sorted(want - have)}"
                )
    finally:
        srv.close()

    # --- case 3: failover with a schedule in flight -----------------------
    clock = FakeClock()
    srv_a = ServiceServer(svc_cfg, "127.0.0.1:0", batch_window_s=0.0,
                          clock=clock, device=device)
    srv_b = ServiceServer(svc_cfg, "127.0.0.1:0", batch_window_s=0.0,
                          clock=clock, device=device)
    srv_a.start_background(scheduler=False)
    srv_b.start_background(scheduler=False)
    svc_before = metrics.service_snapshot()
    fl_failover0 = flight.RECORDER.counts().get("failover", 0)
    failovers = 0
    try:
        agent = RemotePlanner(
            svc_cfg, f"http://{srv_a.address},http://{srv_b.address}",
            tenant="sched-failover", clock=clock,
        )
        handle = agent.plan_schedule(store, pdbs)
        if handle is None or agent.last_endpoint != f"http://{srv_a.address}":
            violations.append("failover case: primary did not serve the cut")

        def execute(report):
            # one step's drain on the fake cluster, as the actuator and
            # the scheduler would: evict the plan's pods onto their
            # proven placements
            client2.placement_hints.clear()
            client2.placement_hints.update(report.plan.assignments)
            for pod in report.plan.pods:
                client2.evict_pod(pod, 0)
            client2.clock.advance(1)

        step = handle.next_plan(store, pdbs) if handle else None
        if step is None:
            violations.append("failover case: step 0 did not execute")
        else:
            execute(step)
        srv_a.close()
        # the in-flight schedule keeps executing with no wire traffic
        if handle is not None and not handle.exhausted:
            nxt = handle.next_plan(store, pdbs)
            if nxt is None:
                violations.append(
                    "failover case: in-flight step failed after the "
                    "replica death (%s)" % handle.invalid_reason
                )
            else:
                execute(nxt)
        handle2 = agent.plan_schedule(store, pdbs)
        if handle2 is None:
            violations.append("failover case: secondary did not serve")
        elif agent.last_endpoint != f"http://{srv_b.address}":
            violations.append("failover case: cut not served by secondary")
        svc_after = metrics.service_snapshot()
        failovers = (svc_after["remote_planner_failover"]
                     - svc_before["remote_planner_failover"])
        fl_failover = (flight.RECORDER.counts().get("failover", 0)
                       - fl_failover0)
        if failovers < 1:
            violations.append("failover metric did not fire")
        if failovers != fl_failover:
            violations.append(
                f"flight failover delta {fl_failover} != metric "
                f"delta {failovers}"
            )
        if (svc_after["remote_planner_fallback"]
                != svc_before["remote_planner_fallback"]):
            violations.append(
                "failover case: an agent fell back to the local oracle"
            )
    finally:
        srv_a.close()
        srv_b.close()

    stats_out = {
        "drains": int(drains_sched),
        "drains_per_tick_baseline": int(drains_base),
        "fetches_total": int(fetches),
        "fetch_bound": int(bound),
        "schedule_lens": [int(n) for n in lens],
        "invalidations": int(m_delta),
        # the port's row also carries the served cut and the failovers,
        # which its chip check holds to the JAX package's freeze
        "schedule_cut": cut,
        "failovers": int(failovers),
    }
    return stats_out, violations


def run_sched_smoke(args, device, metric: str, unit: str) -> tuple:
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import progress

    t0 = time.perf_counter()
    stats, violations = sched_smoke(args.seed, device)
    wall = time.perf_counter() - t0
    ok = not violations
    progress(
        f"sched-smoke: {stats['drains']} drains in {stats['fetches_total']} "
        f"fetches (bound {stats['fetch_bound']}; per-tick baseline "
        f"{stats['drains_per_tick_baseline']} drains)  schedule lens "
        f"{stats['schedule_lens']}  invalidations {stats['invalidations']}  "
        f"wall={wall:.1f}s  -> "
        f"{'OK' if ok else 'FAIL: ' + '; '.join(violations)}"
    )
    row = {
        "metric": metric,
        "value": int(stats["fetches_total"]),
        "unit": unit,
        "vs_baseline": round(stats["drains"] / max(stats["fetches_total"], 1),
                             2),
        "wall_s": round(wall, 2),
        "ok": ok,
        **stats,
    }
    if violations:
        row["violations"] = violations
    return (0 if ok else 1), row

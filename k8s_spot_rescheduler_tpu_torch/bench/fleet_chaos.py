"""``--fleet-chaos``: the root ``bench.py``'s fleet failure-domain smoke
(``fleet_chaos_smoke``), on the port's agents and service replicas.

``n_agents`` agents (config 2 cut to 6 on-demand and 6 spot nodes, 48
pods) and two ``ServiceServer`` replicas over real HTTP share one
``FakeClock``. The replicas run without a scheduler thread (each
submission drains on its handler thread), so the run is deterministic
tick by tick. Six scripted phases:

1. **healthy**: six fleet ticks through replica A; the watchdog
   calibrates its baseline.
2. **half-close**: between ticks the server side of every pooled
   connection goes away; the pool's stale-retry absorbs each strike
   with one reconnect an agent, no failover, no fallback.
3. **corrupt delta**: replica A bit-flips every request body; the
   corrupted delta fails its digest and comes back as a resync demand,
   the full-pack retry is corrupted too, and the agent fails over to B.
4. **wire chaos**: the seeded ``ServiceFaultPlan`` (resets, slow-loris
   uploads, truncated and corrupted replies, a scripted 503 storm) on
   every agent's transport, eight ticks.
5. **sick device**: replica A's solves gain 2 s of virtual latency; the
   watchdog must flip within ``device_sick_threshold`` slow batches and
   recover only after its hysteresis probes once the phase ends.
6. **replica kill/restart**: A drains and dies, the agents fail over to
   B (``failover_ms``), A restarts on its address, pre-warms the
   buckets of its persisted state and serves the agents again.

The reference plans on its numpy oracle; here every replica and the
solo truth run ``solver="torch"`` on ``device``. Off the card the sick
phase follows the JAX service (the sick replica serves its numpy-oracle
host path, and a recovery probe goes to the device path at most every
``PROBE_INTERVAL_S``), so every count equals the JAX package's. On the
card no batch leaves the device: while sick every batch is a recovery
probe on the device path (``PlannerService._host_path_open``). The
edges, the gauge, ``sick_detect_batches`` and every other count stay
the JAX package's; what the host path paced differs: the first two
batches after the sick phase are both healthy probes, so the watchdog
recovers in the first recovery tick (``recovered_after_ticks`` 1 against
the JAX package's 2, and so ``ticks`` 27 against 28). The sick phase's
batches each pay the injected latency on the virtual clock there, which
moves no count.

Every check of the reference's ``ok`` is kept: no agent crash, every
selection equal to the solo plan, the half-close counts, a resync in the
corrupt phase, the sick edge (healthz, gauge, detect batches) and the
recovery, failovers, flight deltas equal to the metric deltas, warmed
buckets, and every agent back on the primary.
"""

from __future__ import annotations

import dataclasses
import tempfile
import time

import numpy as np

from k8s_spot_rescheduler_tpu_torch.bench.service_smoke import (
    selection,
    selection_json,
)

FLIGHT_KINDS = ("remote-planner-fallback", "failover", "device-sick",
                "device-recovered", "service-shed", "delta-resync")


def fleet_chaos_spec():
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import CONFIGS

    return dataclasses.replace(CONFIGS[2], name="fleet-chaos",
                               n_on_demand=6, n_spot=6, n_pods=48)


def fleet_chaos_smoke(n_agents: int = 4, seed: int = 0, device=None) -> dict:
    """The fleet failure-domain acceptance core (module docstring)."""
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import generate_cluster
    from k8s_spot_rescheduler_tpu_torch.loop import flight
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.service.agent import RemotePlanner
    from k8s_spot_rescheduler_tpu_torch.service.chaos import (
        ChaosAgentTransport,
        ServiceChaos,
        ServiceFaultPlan,
    )
    from k8s_spot_rescheduler_tpu_torch.service.server import ServiceServer
    from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    spec = fleet_chaos_spec()
    cfg = ReschedulerConfig(
        resources=spec.resources, solver="torch", device_sick_threshold=3,
        service_drain_grace=2.0, planner_timeout=5.0,
    )
    tenants = []
    for i in range(n_agents):
        client = generate_cluster(spec, seed + i)
        store = client.columnar_store(
            cfg.resources,
            on_demand_label=cfg.on_demand_node_label,
            spot_label=cfg.spot_node_label,
        )
        tenants.append((store, client.list_pdbs()))

    solo = TorchSolverPlanner(cfg, device=device)
    solo_sel = [selection(solo.plan(store, pdbs)) for store, pdbs in tenants]

    clock = FakeClock()
    state = tempfile.TemporaryDirectory(prefix="fleet-chaos-state-")
    cfg_srv = dataclasses.replace(cfg, service_state_dir=state.name)
    replicas = []

    def new_replica(addr="127.0.0.1:0"):
        srv = ServiceServer(
            cfg_srv, addr, batch_window_s=0.0,
            max_inflight=max(16, 4 * n_agents), clock=clock, device=device,
        )
        # scheduler-less: submissions drain on the handler thread, so no
        # background thread sleeps on the shared virtual clock
        srv.start_background(scheduler=False)
        replicas.append(srv)
        return srv

    try:
        replica_a = new_replica()
        replica_b = new_replica()
        addr_a = replica_a.address

        agent_plan = ServiceFaultPlan(
            seed=seed + 7,
            connect_reset_rate=0.15,
            slow_loris_rate=0.05,
            reply_truncate_rate=0.10,
            reply_corrupt_rate=0.10,
            http_503_script=(3, 4),
            http_503_retry_after=0.5,
            http_5xx_rate=0.05,
        )
        agents, chaos_transports = [], []
        for i in range(n_agents):
            agent = RemotePlanner(
                cfg, f"http://{addr_a},http://{replica_b.address}",
                tenant=f"fleet-tenant-{i}", clock=clock,
            )
            chaos = ChaosAgentTransport(
                agent.transport, dataclasses.replace(agent_plan, seed=seed + i),
                clock=clock, pool=agent._wire_pool,
            )
            chaos.enabled = False
            agent.transport = chaos
            agents.append(agent)
            chaos_transports.append(chaos)

        m0 = metrics.service_snapshot()
        f0 = flight.RECORDER.counts()
        crashes, mismatches = [], []
        tick_no = [0]
        failover_ms: list = []

        def fleet_tick(note=""):
            """Every agent plans once (wall time per agent), then virtual
            time advances a housekeeping interval."""
            tick_no[0] += 1
            walls = []
            for i, agent in enumerate(agents):
                store, pdbs = tenants[i]
                t0 = time.perf_counter()
                try:
                    report = agent.plan(store, pdbs)
                except Exception as err:  # noqa: BLE001 — the acceptance: an agent never raises; counted and reported
                    crashes.append({"tick": tick_no[0], "tenant": i,
                                    "note": note,
                                    "error": f"{type(err).__name__}: {err}"})
                    continue
                walls.append((time.perf_counter() - t0) * 1e3)
                got = selection(report)
                if got != solo_sel[i] or report.solver not in (
                    "remote", "remote-fallback"
                ):
                    mismatches.append({
                        "tick": tick_no[0], "tenant": i, "note": note,
                        "solo": selection_json(solo_sel[i]),
                        "got": selection_json(got), "solver": report.solver,
                    })
            clock.advance(3.0)  # the virtual housekeeping interval
            return walls

        def delta_resyncs():
            return metrics.service_snapshot()["delta_requests"].get(
                "resync", 0)

        # --- phase 1: healthy warmup (calibrates the watchdog) ---
        for _ in range(6):
            fleet_tick("healthy")

        # --- phase 1.25: half-closed keep-alive sockets ---
        hc0 = metrics.service_snapshot()
        hc_plans = []
        for chaos in chaos_transports:
            hc_plans.append(chaos.plan)
            chaos.plan = ServiceFaultPlan(
                half_close_script=(chaos._requests + 1, chaos._requests + 2)
            )
            chaos.enabled = True
        for _ in range(2):
            fleet_tick("half-close")
        for chaos, original in zip(chaos_transports, hc_plans):
            chaos.enabled = False
            chaos.plan = original
        hc1 = metrics.service_snapshot()
        half_close_strikes = sum(
            c.stats["half_close"] for c in chaos_transports)
        half_close_reconnects = hc1["wire_reconnects"] - hc0["wire_reconnects"]
        half_close_ok = (
            half_close_strikes == 2 * n_agents
            and half_close_reconnects == 2 * n_agents
            and hc1["remote_planner_fallback"] == hc0["remote_planner_fallback"]
            and hc1["remote_planner_failover"] == hc0["remote_planner_failover"]
        )

        # --- phase 1.5: corrupted delta on replica A ---
        svc_a = replica_a.service
        svc_a.chaos = ServiceChaos(
            ServiceFaultPlan(seed=seed, request_corrupt_rate=1.0), clock=clock)
        resyncs_before_corrupt = delta_resyncs()
        fleet_tick("corrupt-delta")
        svc_a.chaos = None
        corrupt_resyncs = delta_resyncs() - resyncs_before_corrupt

        # --- phase 2: wire/HTTP chaos on every agent transport ---
        for chaos in chaos_transports:
            chaos.enabled = True
        for _ in range(8):
            fleet_tick("wire-chaos")
        for chaos in chaos_transports:
            chaos.enabled = False
        # let the chaos phase's breaker windows expire before phase 3
        clock.advance(60.0)

        # --- phase 3: scripted sick-device phase on replica A ---
        svc_a.chaos = ServiceChaos(
            ServiceFaultPlan(seed=seed, sick_phase=(1, 10**9, 2.0)),
            clock=clock)
        sick_detect_ticks = None
        for n in range(1, 5):
            fleet_tick("sick-phase")
            if (sick_detect_ticks is None
                    and svc_a.healthz_snapshot()["device"] == "sick"):
                sick_detect_ticks = n
        sick_snapshot = svc_a.healthz_snapshot()
        sick_gauge_during = metrics.service_snapshot()["device_sick"]
        wd = svc_a._devhealth
        sick_detect_batches = wd.detect_streak if wd is not None else -1
        # the phase ends: hysteresis probes must recover it
        svc_a.chaos.enabled = False
        recovered_after = None
        for n in range(1, 6):
            fleet_tick("recovery")
            if svc_a.healthz_snapshot()["device"] == "ok":
                recovered_after = n
                break
        end_snapshot = svc_a.healthz_snapshot()

        # --- phase 4: graceful kill of A, failover, warm restart ---
        replica_a.graceful_shutdown()
        for _ in range(3):
            failover_ms.extend(fleet_tick("replica-kill"))
        restarted = new_replica(addr_a)
        warmed = list(restarted.service.warmed_buckets)
        # A's breaker horizons expire; the agents return to the primary
        clock.advance(180.0)
        for _ in range(2):
            fleet_tick("replica-restart")
        primary_back = all(
            agent.last_endpoint == f"http://{addr_a}" for agent in agents)
    finally:
        for srv in replicas:
            srv.close()
        state.cleanup()

    m1 = metrics.service_snapshot()
    f1 = flight.RECORDER.counts()

    def fdelta(kind):
        return f1.get(kind, 0) - f0.get(kind, 0)

    fallback_metric = (m1["remote_planner_fallback"]
                       - m0["remote_planner_fallback"])
    failover_metric = (m1["remote_planner_failover"]
                       - m0["remote_planner_failover"])
    resync_metric = (m1["delta_requests"].get("resync", 0)
                     - m0.get("delta_requests", {}).get("resync", 0))
    flight_eq_metrics = (
        fdelta("remote-planner-fallback") == fallback_metric
        and fdelta("failover") == failover_metric
        and fdelta("device-sick") == 1
        and fdelta("device-recovered") == 1
        and fdelta("delta-resync") == resync_metric
    )
    ok = (
        not crashes
        and not mismatches
        and half_close_ok
        and corrupt_resyncs >= 1
        and sick_detect_ticks is not None
        and sick_snapshot.get("device") == "sick"
        and sick_gauge_during == 1.0
        and 0 < sick_detect_batches <= cfg.device_sick_threshold
        and recovered_after is not None
        and end_snapshot.get("device") == "ok"
        and m1["device_sick"] == 0.0
        and failover_metric > 0
        and flight_eq_metrics
        and bool(warmed)
        and primary_back
    )
    return {
        "ok": ok,
        "n_agents": n_agents,
        "ticks": tick_no[0],
        "crashes": crashes,
        "mismatches": mismatches,
        "selections": [selection_json(s) for s in solo_sel],
        "sick_detect_ticks": sick_detect_ticks,
        "sick_detect_batches": sick_detect_batches,
        "recovered_after_ticks": recovered_after,
        "failover_ms": round(
            float(np.median(failover_ms)) if failover_ms else 0.0, 2),
        "failovers": int(failover_metric),
        "fallbacks": int(fallback_metric),
        "flight_eq_metrics": flight_eq_metrics,
        "flight_deltas": {k: fdelta(k) for k in FLIGHT_KINDS},
        "corrupt_resyncs": int(corrupt_resyncs),
        "half_close_strikes": int(half_close_strikes),
        "half_close_reconnects": int(half_close_reconnects),
        "half_close_ok": half_close_ok,
        "delta_resyncs": int(resync_metric),
        "warmed_buckets": warmed,
        "primary_back": primary_back,
        "device_end_state": end_snapshot.get("device"),
    }


def run_fleet_chaos(args, device, metric: str, unit: str) -> tuple:
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import progress

    r = fleet_chaos_smoke(n_agents=max(4, args.tenants), seed=args.seed,
                          device=device)
    detail = r["crashes"] or r["mismatches"] or {
        "flight_deltas": r["flight_deltas"]}
    progress(
        f"fleet-chaos-smoke: {r['n_agents']} agents x 2 replicas, "
        f"{r['ticks']} ticks  sick_detect={r['sick_detect_ticks']} tick(s)/"
        f"{r['sick_detect_batches']} batch(es)  recovered_after="
        f"{r['recovered_after_ticks']}  failovers={r['failovers']} (median "
        f"{r['failover_ms']} ms)  fallbacks={r['fallbacks']}  half_close="
        f"{r['half_close_strikes']} strikes/{r['half_close_reconnects']} "
        f"reconnects ({'OK' if r['half_close_ok'] else 'FAIL'})  resyncs="
        f"{r['delta_resyncs']} (corrupt phase {r['corrupt_resyncs']})  "
        f"warmed={r['warmed_buckets']}  flight==metrics: "
        f"{r['flight_eq_metrics']}  -> "
        f"{'OK' if r['ok'] else 'FAIL: %s' % detail}"
    )
    row = {
        "metric": metric,
        "value": r["failover_ms"],
        "unit": unit,
        "n_agents": r["n_agents"],
        "ticks": r["ticks"],
        "failover_ms": r["failover_ms"],
        "sick_detect_ticks": r["sick_detect_ticks"],
        "sick_detect_batches": r["sick_detect_batches"],
        "recovered_after_ticks": r["recovered_after_ticks"],
        "failovers": r["failovers"],
        "fallbacks": r["fallbacks"],
        "delta_resyncs": r["delta_resyncs"],
        "corrupt_resyncs": r["corrupt_resyncs"],
        "half_close_strikes": r["half_close_strikes"],
        "half_close_reconnects": r["half_close_reconnects"],
        "flight_eq_metrics": r["flight_eq_metrics"],
        "warmed_buckets": len(r["warmed_buckets"]),
        "ok": r["ok"],
        # the port's row also carries what its chip check holds to the
        # JAX package's freeze
        "flight_deltas": r["flight_deltas"],
        "warmed_bucket_keys": r["warmed_buckets"],
        "selections": r["selections"],
        "primary_back": r["primary_back"],
        "device_end_state": r["device_end_state"],
        "crashes": r["crashes"],
        "mismatches": r["mismatches"],
    }
    return (0 if r["ok"] else 1), row

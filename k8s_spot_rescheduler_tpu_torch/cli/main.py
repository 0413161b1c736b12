"""Process entry point of the port.

The port of the JAX package's ``cli/main.py``: the reference's flag
surface (reference rescheduler.go:48-142: 13 pflag flags + glog's -v +
--version), the planner knobs, and the cluster sources: a live
apiserver (``--cluster kube`` from in-cluster credentials or a
kubeconfig, ``--cluster kube:URL`` at an explicit URL), served from
watch caches and the columnar mirror by default (``--watch-cache``,
``--use-columnar``), with Lease leader election (``--leader-elect*``);
or a synthetic cluster (``--cluster synthetic:N[:seed]``) behind the
same ClusterClient interface. ``--device`` (default ``cuda``) names
where the planner runs.

The multi-tenant planner service: ``--serve ADDR`` runs the service
(``service/server.ServiceServer``) on ``--device`` instead of a control
loop, its kernels built before it listens; it exits 1 when a fault of
the card's kernels ended it. An agent with ``--planner-url`` (or an
ordered ``--planner-urls`` list) plans through such a service with the
port's ``RemotePlanner`` and reports ``remote_planner_fallback_total``
when it ends. Their knobs: ``--planner-timeout``,
``--delta-wire-enabled``, ``--device-sick-threshold`` and
``--service-{drain-grace,state-dir,batch-window,queue-timeout,
resync-ingest-cap,resync-ingest-budget}``.

On a live apiserver, node and pod LISTs decode in one native pass
(``io/native_ingest``) unless ``--resources`` names a resource its
schema does not carry. The seeded fault layers: ``--chaos-profile``/
``--chaos-seed``/``--chaos-watch-stall-rate`` wrap the cluster client in
``io/chaos.ChaosClusterClient`` (on kube under the watch cache, so its
streams pass the fault layer), and ``--service-chaos-profile``/
``--service-chaos-seed`` arm ``service/chaos.py`` on the agent's
transport and in the service's batch window — testing only.

``--trace-dir DIR`` annotates the tick phases for torch.profiler
(``utils/tracing.enable_profiler``) and writes one Chrome trace of
each housekeeping tick under DIR (``utils/tracing.device_trace``: CPU
activities, and the card's where there is one).

The mesh and memory ladder: ``--solver sharded`` runs first-fit and
best-fit over the 2-D device mesh of ``--mesh-shape AxB`` (default:
inferred from the device count); ``--auto-shard`` (on by default)
reroutes a problem past one device's ``--solver-hbm-budget`` down the
ladder, whose carry-streamed rung streams ``--carry-chunks`` spot
chunks (0 = sized to the budget). The mesh is laid over every visible
card (``[cpu]`` with ``--device cpu``). The JAX-only
``--jax-cache-dir`` goes: argparse refuses it.

``--debug-endpoints true`` serves ``/debug/trace`` and ``/debug/flight``
(redacted) on the ``--serve`` process; off (the default) both answer
404.

Run e.g.::

    python -m k8s_spot_rescheduler_tpu_torch --cluster synthetic:1 --ticks 3 -v 2
    python -m k8s_spot_rescheduler_tpu_torch --cluster synthetic:1 --ticks 3 \
        --device cpu --no-metrics-server --node-drain-delay 1s
    python -m k8s_spot_rescheduler_tpu_torch --cluster kube:http://127.0.0.1:8080 \
        --ticks 2 --housekeeping-interval 2s --node-drain-delay 1s
    python -m k8s_spot_rescheduler_tpu_torch --cluster synthetic:1 --ticks 3 \
        --device cpu --no-metrics-server --chaos-profile light
    python -m k8s_spot_rescheduler_tpu_torch --serve 127.0.0.1:8642 \
        --device cpu --no-metrics-server
    python -m k8s_spot_rescheduler_tpu_torch --cluster synthetic:1 --ticks 3 \
        --planner-url http://127.0.0.1:8642 --no-metrics-server \
        --node-drain-delay 1s
"""

from __future__ import annotations

import argparse
import sys

from k8s_spot_rescheduler_tpu_torch import VERSION
from k8s_spot_rescheduler_tpu_torch.utils.config import SOLVERS, ReschedulerConfig
from k8s_spot_rescheduler_tpu_torch.utils.durations import parse_duration
from k8s_spot_rescheduler_tpu_torch.utils.labels import LabelFormatError
from k8s_spot_rescheduler_tpu_torch.utils import logging as log


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="k8s-spot-rescheduler-tpu-torch",
        description="spot rescheduler, PyTorch/CUDA port",
    )
    d = ReschedulerConfig()
    # --- reference flag surface (rescheduler.go:48-108) ---
    p.add_argument("--running-in-cluster", type=_bool, default=d.running_in_cluster,
                   help="use in-cluster credentials (reference rescheduler.go:53)")
    p.add_argument("--namespace", default=d.namespace)
    p.add_argument("--housekeeping-interval", default="10s",
                   help="how often rescheduler takes actions (Go duration)")
    p.add_argument("--node-drain-delay", default="10m",
                   help="wait between draining nodes")
    p.add_argument("--pod-eviction-timeout", default="2m")
    p.add_argument("--max-graceful-termination", default="2m")
    p.add_argument("--listen-address", default=d.listen_address,
                   help="prometheus metrics address")
    p.add_argument("--kubeconfig", default=d.kubeconfig)
    p.add_argument("--delete-non-replicated-pods", type=_bool,
                   default=d.delete_non_replicated_pods)
    p.add_argument("--on-demand-node-label", default=d.on_demand_node_label)
    p.add_argument("--spot-node-label", default=d.spot_node_label)
    p.add_argument("--priority-threshold", type=int, default=d.priority_threshold)
    p.add_argument("--eviction-retry-time", default=f"{d.eviction_retry_time:g}s",
                   help="pause between eviction retry rounds while a "
                        "drain waits pods out (a const in the reference, "
                        "scaler/scaler.go:37-38; Go duration)")
    p.add_argument("--version", action="store_true", help="show version and exit")
    p.add_argument("-v", "--verbosity", type=int, default=0, help="glog-style -v")
    # --- planner knobs ---
    p.add_argument("--solver", default=d.solver, choices=list(SOLVERS),
                   help="torch = the union with kernels B1/B2 on --device; "
                        "numpy = the serial host oracle; sharded = "
                        "first-fit and best-fit over the 2-D device mesh")
    p.add_argument("--mesh-shape", default="", type=_mesh_shape,
                   help="cand x spot device mesh for --solver sharded, "
                        "e.g. 4x2 (default: infer from the device count)")
    p.add_argument("--device", default="cuda",
                   help="where the torch planner runs: cuda (default; "
                        "fails without a card) or cpu")
    p.add_argument("--resources", default=",".join(d.resources),
                   help="comma-separated resource axes to pack")
    p.add_argument("--repair-rounds", type=int, default=d.repair_rounds,
                   help="eject-and-reinsert local-search rounds for "
                        "candidates greedy packing can't prove (0=off)")
    p.add_argument("--fallback-best-fit", type=_bool,
                   default=d.fallback_best_fit,
                   help="second feasibility pass under best-fit-"
                        "decreasing packing for candidates first-fit "
                        "can't prove (only ever adds drainable nodes; "
                        "false = bit-faithful reference selection)")
    p.add_argument("--max-drains-per-tick", type=int,
                   default=d.max_drains_per_tick,
                   help="drains per housekeeping tick (the reference "
                        "hard-codes 1, rescheduler.go:286; >1 re-plans "
                        "between drains)")
    p.add_argument("--max-pods-per-node-hint", type=int,
                   default=d.max_pods_per_node_hint,
                   help="static padding bound for the solver's pod-slot "
                        "axis (grown automatically when a node exceeds it)")
    p.add_argument("--use-columnar", type=_bool, default=d.use_columnar,
                   help="observe via the incrementally-maintained "
                        "columnar mirror when the cluster source "
                        "provides one; false = the reference-faithful "
                        "per-tick object rebuild")
    p.add_argument("--auto-shard", type=_bool, default=d.auto_shard,
                   help="reroute the solve down the mesh ladder when the "
                        "problem exceeds one device's budget and the "
                        "planner has more than one device")
    p.add_argument("--solver-hbm-budget", type=int,
                   default=d.solver_hbm_budget,
                   help="per-device byte budget for the auto-shard "
                        "decision (0 = the device's own)")
    p.add_argument("--carry-chunks", type=int, default=d.carry_chunks,
                   help="spot-chunk count of the carry-streamed narrow "
                        "union tier (the auto-shard rung past the wide "
                        "chunked-repair ceiling; repair stays live, "
                        "results bit-identical); 0 = auto via "
                        "solver/memory.pick_carry_chunks")
    p.add_argument("--incremental-device-cache", type=_bool,
                   default=d.incremental_device_cache,
                   help="keep the packed problem resident on the device "
                        "and write only the per-tick churn delta; off = "
                        "full upload every tick")
    p.add_argument("--staged-chunk-lanes", type=int,
                   default=d.staged_chunk_lanes,
                   help="solve candidate lanes in selection-order chunks "
                        "of this size, skipping prefilter-eliminated "
                        "chunks (0 = unstaged full solve)")
    p.add_argument("--staged-early-exit", type=_bool,
                   default=d.staged_early_exit,
                   help="stop solving at the first chunk containing a "
                        "feasible lane (selection is identical; the "
                        "feasible count then covers the solved prefix)")
    p.add_argument("--plan-schedule-enabled", type=_bool,
                   default=d.plan_schedule_enabled,
                   help="cut whole drain-to-exhaustion SCHEDULES in one "
                        "planner fetch and execute them across ticks, "
                        "each step re-packed and re-proven from scratch "
                        "against the live cluster before any eviction "
                        "(false, or --schedule-horizon 0, = per-tick "
                        "single plans)")
    p.add_argument("--schedule-horizon", type=int,
                   default=d.schedule_horizon,
                   help="max drain steps per cut schedule; "
                        "0 = schedules off (the documented opt-out)")
    p.add_argument("--kube-retry-max", type=int, default=d.kube_retry_max,
                   help="max transient-retry attempts per kube API read "
                        "(429/5xx/connection errors, jittered exponential "
                        "backoff honoring Retry-After; writes are "
                        "single-attempt — the actuator owns their cadence)")
    p.add_argument("--kube-retry-base", type=float, default=d.kube_retry_base,
                   help="base seconds of the kube read retry backoff")
    p.add_argument("--breaker-threshold", type=int, default=d.breaker_threshold,
                   help="consecutive error-skipped ticks before the "
                        "circuit breaker widens the housekeeping interval "
                        "(0 = off)")
    p.add_argument("--breaker-max-interval",
                   default=f"{d.breaker_max_interval:g}s",
                   help="cap of the breaker-widened interval (Go duration)")
    p.add_argument("--reconcile-orphaned-taints", type=_bool,
                   default=d.reconcile_orphaned_taints,
                   help="on startup and each tick, remove ToBeDeleted "
                        "taints no active drain owns (crash-safe drain "
                        "recovery; the reference leaves them for CA)")
    from k8s_spot_rescheduler_tpu_torch.io.chaos import FaultPlan as _FaultPlan

    p.add_argument("--chaos-profile", default=d.chaos_profile,
                   choices=list(_FaultPlan.PROFILES),
                   help="wrap the cluster client in the seeded "
                        "fault-injection layer (io/chaos.py) — "
                        "testing/demo only, never production")
    p.add_argument("--chaos-seed", type=int, default=d.chaos_seed,
                   help="seed of the chaos fault stream (deterministic)")
    p.add_argument("--chaos-watch-stall-rate", type=float,
                   default=d.chaos_watch_stall_rate,
                   help="per-stream-open probability an injected chaos "
                        "watch stream is open but silent until the read "
                        "timeout; mixed into the selected --chaos-profile")
    p.add_argument("--watch-progress-deadline", default="2m",
                   help="kill and reconnect a watch stream that delivers "
                        "no event, bookmark, or clean close for this "
                        "long (Go duration; 0 = server timeouts only)")
    p.add_argument("--mirror-staleness-budget", default="1m",
                   help="refuse to plan a tick from a watch mirror older "
                        "than this: the tick degrades to a direct LIST, "
                        "or skips into the circuit breaker (Go duration; "
                        "0 disables the freshness gate)")
    p.add_argument("--resync-interval", default="5m",
                   help="anti-entropy audit period: a LIST is diffed "
                        "field-by-field against the watch mirror; drift "
                        "is counted and healed by a store replace (Go "
                        "duration; 0 disables)")
    p.add_argument("--planner-url", default=d.planner_url,
                   help="plan through a remote multi-tenant planner "
                        "service at this base URL instead of the "
                        "in-process solver: observe/pack/actuate stay "
                        "local, packed tensors ship over the binary wire "
                        "protocol (service/wire.py); when every endpoint "
                        "fails the tick plans on the local numpy oracle "
                        "(empty = plan in-process)")
    p.add_argument("--planner-urls", default=d.planner_urls,
                   help="ORDERED comma-separated planner-service "
                        "endpoints: per-endpoint circuit breakers, "
                        "failover down the list, local numpy-oracle "
                        "fallback only when every endpoint is dead "
                        "(takes precedence over --planner-url)")
    p.add_argument("--planner-timeout", default=f"{d.planner_timeout:g}s",
                   help="per-plan HTTP deadline of the agent's planner-"
                        "service call (Go duration)")
    p.add_argument("--delta-wire-enabled", type=_bool,
                   default=d.delta_wire_enabled,
                   help="ship each tick's churn delta to the planner "
                        "service instead of the full pack (wire v4); any "
                        "disagreement costs one full-pack resync (false "
                        "= full packs every tick)")
    p.add_argument("--device-sick-threshold", type=int,
                   default=d.device_sick_threshold,
                   help="--serve mode: consecutive slower-than-baseline "
                        "batched solves before the device-health "
                        "watchdog serves from the numpy-oracle host path "
                        "(0 = watchdog off); a fault of the card's "
                        "kernels ends the service instead")
    p.add_argument("--service-drain-grace",
                   default=f"{d.service_drain_grace:g}s",
                   help="--serve mode: seconds SIGTERM lets queued "
                        "batches finish before the rest are evicted "
                        "with 503 (Go duration)")
    p.add_argument("--service-state-dir", default=d.service_state_dir,
                   help="--serve mode: persist per-tenant pack "
                        "fingerprints + the bucket warmup list here "
                        "(warm restart; empty = cold restarts)")
    from k8s_spot_rescheduler_tpu_torch.service.chaos import (
        ServiceFaultPlan as _ServiceFaultPlan,
    )

    p.add_argument("--service-chaos-profile",
                   default=d.service_chaos_profile,
                   choices=list(_ServiceFaultPlan.PROFILES),
                   help="seeded fault injection on the planner-service "
                        "path (service/chaos.py): wire faults on the "
                        "agent transport, solve/decode faults in the "
                        "service — testing/demo only, never production")
    p.add_argument("--service-chaos-seed", type=int,
                   default=d.service_chaos_seed,
                   help="seed of the service chaos fault stream "
                        "(deterministic)")
    p.add_argument("--service-batch-window",
                   default=f"{d.service_batch_window:g}s",
                   help="--serve mode: how long the batching scheduler "
                        "waits to coalesce concurrent tenants into one "
                        "batched solve (Go duration; 0 = at once)")
    p.add_argument("--service-queue-timeout",
                   default=f"{d.service_queue_timeout:g}s",
                   help="--serve mode: a plan request unbatched past "
                        "this is evicted with 503 + Retry-After from the "
                        "measured batch cadence (Go duration)")
    p.add_argument("--service-resync-ingest-cap", type=int,
                   default=d.service_resync_ingest_cap,
                   help="--serve mode: max concurrent full-pack resync "
                        "ingests; excess refused with a typed 503")
    p.add_argument("--service-resync-ingest-budget", type=int,
                   default=d.service_resync_ingest_budget,
                   help="--serve mode: byte budget of the resync ingest "
                        "ledger (0 = the device memory budget)")
    p.add_argument("--serve", default="",
                   help="run as the multi-tenant planner SERVICE on this "
                        "address (e.g. 0.0.0.0:8642) on --device instead "
                        "of a control loop: /v2/plan (binary wire), "
                        "/v1/plan (JSON), /healthz")
    p.add_argument("--trace-enabled", type=_bool, default=d.trace_enabled,
                   help="per-tick span-tree tracing (utils/tracing.py); "
                        "false = phase histograms only")
    p.add_argument("--flight-ring-size", type=int,
                   default=d.flight_ring_size,
                   help="completed tick traces the flight recorder's "
                        "in-memory postmortem ring retains")
    p.add_argument("--flight-dump-dir", default=d.flight_dump_dir,
                   help="directory the flight recorder auto-dumps a "
                        "redacted JSON postmortem into when a "
                        "degradation edge fires; empty = in-memory only")
    p.add_argument("--debug-endpoints", type=_bool,
                   default=d.debug_endpoints,
                   help="serve GET /debug/trace and /debug/flight on "
                        "the --serve HTTP server (off by default; debug "
                        "surfaces are opt-in)")
    p.add_argument("--leader-elect", type=_bool, default=False,
                   help="Lease-based leader election so only one replica "
                        "acts (restores what reference rescheduler.go:139 "
                        "removed); kube cluster mode only")
    p.add_argument("--leader-elect-namespace", default="kube-system")
    p.add_argument("--leader-elect-identity", default="",
                   help="holder identity (default: hostname_pid_rand)")
    p.add_argument("--leader-elect-lease-duration", default="15s",
                   help="takeover after the holder is quiet this long")
    p.add_argument("--watch-cache", type=_bool, default=True,
                   help="serve per-tick reads from watch-backed caches "
                        "(the reference's lister behavior) instead of "
                        "polling LISTs; kube cluster mode only")
    p.add_argument("--cluster", default="synthetic:1",
                   help="cluster source: synthetic:<config#>[:seed], "
                        "kube (apiserver from kubeconfig/in-cluster "
                        "creds), or kube:<url> (explicit apiserver URL)")
    p.add_argument("--ticks", type=int, default=0,
                   help="run N housekeeping ticks then exit (0 = forever)")
    p.add_argument("--no-metrics-server", action="store_true")
    p.add_argument("--trace-dir", default="",
                   help="write torch.profiler traces of the solver "
                        "phases here: one Chrome trace a tick")
    return p


def _bool(s: str) -> bool:
    return str(s).lower() in ("1", "true", "yes")


def _mesh_shape(s: str) -> tuple:
    """``AxB`` (e.g. ``4x2``) as a (cand, spot) tuple; empty = inferred."""
    if not s:
        return ()
    try:
        shape = tuple(int(x) for x in s.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise argparse.ArgumentTypeError(
            f"mesh shape {s!r} is not AxB, e.g. 4x2")
    return shape


def start_watch_client(client, config: ReschedulerConfig, clock):
    """Wrap ``client`` in the watch-backed cache layer and sync it.

    Graceful startup degradation: if the caches fail to sync (apiserver
    flaky at boot, watch endpoints unreachable), the process does NOT
    die — it logs a warning, marks the loop degraded (sticky on
    /healthz and the ``rescheduler_degraded`` gauge), and falls back to
    the polling client, whose per-tick LISTs need no warm-up."""
    from k8s_spot_rescheduler_tpu_torch.io.watch import WatchingKubeClusterClient
    from k8s_spot_rescheduler_tpu_torch.loop import health

    wc = WatchingKubeClusterClient(
        client,
        clock=clock,
        progress_deadline=config.watch_progress_deadline,
    )
    try:
        wc.start()
        return wc
    except Exception as err:  # noqa: BLE001 — degrade, don't die
        log.error(
            "Watch caches failed to sync (%s); falling back to the "
            "polling client — degraded (per-tick LISTs) until restart",
            err,
        )
        wc.stop()
        health.STATE.note_startup_degraded()
        return client


def config_from_args(args) -> ReschedulerConfig:
    return ReschedulerConfig(
        running_in_cluster=args.running_in_cluster,
        namespace=args.namespace,
        housekeeping_interval=parse_duration(args.housekeeping_interval),
        node_drain_delay=parse_duration(args.node_drain_delay),
        pod_eviction_timeout=parse_duration(args.pod_eviction_timeout),
        max_graceful_termination=parse_duration(args.max_graceful_termination),
        listen_address=args.listen_address,
        kubeconfig=args.kubeconfig,
        delete_non_replicated_pods=args.delete_non_replicated_pods,
        on_demand_node_label=args.on_demand_node_label,
        spot_node_label=args.spot_node_label,
        priority_threshold=args.priority_threshold,
        eviction_retry_time=parse_duration(args.eviction_retry_time),
        max_pods_per_node_hint=args.max_pods_per_node_hint,
        max_drains_per_tick=args.max_drains_per_tick,
        fallback_best_fit=args.fallback_best_fit,
        use_columnar=args.use_columnar,
        solver=args.solver,
        repair_rounds=args.repair_rounds,
        auto_shard=args.auto_shard,
        solver_hbm_budget=args.solver_hbm_budget,
        carry_chunks=args.carry_chunks,
        incremental_device_cache=args.incremental_device_cache,
        staged_chunk_lanes=args.staged_chunk_lanes,
        staged_early_exit=args.staged_early_exit,
        plan_schedule_enabled=args.plan_schedule_enabled,
        schedule_horizon=args.schedule_horizon,
        kube_retry_max=args.kube_retry_max,
        kube_retry_base=args.kube_retry_base,
        breaker_threshold=args.breaker_threshold,
        breaker_max_interval=parse_duration(args.breaker_max_interval),
        reconcile_orphaned_taints=args.reconcile_orphaned_taints,
        chaos_profile=args.chaos_profile,
        chaos_seed=args.chaos_seed,
        chaos_watch_stall_rate=args.chaos_watch_stall_rate,
        watch_progress_deadline=parse_duration(args.watch_progress_deadline),
        mirror_staleness_budget=parse_duration(args.mirror_staleness_budget),
        resync_interval=parse_duration(args.resync_interval),
        planner_url=args.planner_url,
        planner_urls=args.planner_urls,
        planner_timeout=parse_duration(args.planner_timeout),
        delta_wire_enabled=args.delta_wire_enabled,
        device_sick_threshold=args.device_sick_threshold,
        service_drain_grace=parse_duration(args.service_drain_grace),
        service_state_dir=args.service_state_dir,
        service_chaos_profile=args.service_chaos_profile,
        service_chaos_seed=args.service_chaos_seed,
        service_batch_window=parse_duration(args.service_batch_window),
        service_queue_timeout=parse_duration(args.service_queue_timeout),
        service_resync_ingest_cap=args.service_resync_ingest_cap,
        service_resync_ingest_budget=args.service_resync_ingest_budget,
        trace_enabled=args.trace_enabled,
        flight_ring_size=args.flight_ring_size,
        flight_dump_dir=args.flight_dump_dir,
        debug_endpoints=args.debug_endpoints,
        resources=tuple(r for r in args.resources.split(",") if r),
        mesh_shape=args.mesh_shape or (1, 1),
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        print(f"k8s-spot-rescheduler-tpu-torch {VERSION}")
        return 0

    log.setup(args.verbosity)
    try:
        config = config_from_args(args)
    except (LabelFormatError, ValueError) as err:
        print(f"Error: {err}", file=sys.stderr)
        return 1

    if args.serve:
        return serve(config, args)

    log.info("Running Rescheduler")
    if args.trace_dir:
        from k8s_spot_rescheduler_tpu_torch.utils import tracing

        tracing.enable_profiler(args.trace_dir)
    if not args.no_metrics_server:
        from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics

        metrics.serve(config.listen_address)

    from k8s_spot_rescheduler_tpu_torch.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )

    def chaos_wrap(c, clk):
        import dataclasses

        from k8s_spot_rescheduler_tpu_torch.io.chaos import (
            ChaosClusterClient,
            FaultPlan,
        )

        log.info(
            "CHAOS: fault injection enabled (profile=%s seed=%d) — "
            "testing mode, not production",
            config.chaos_profile, config.chaos_seed,
        )
        plan = FaultPlan.profile(config.chaos_profile, config.chaos_seed)
        if config.chaos_watch_stall_rate > 0:
            plan = dataclasses.replace(
                plan, watch_stall_rate=config.chaos_watch_stall_rate
            )
        return ChaosClusterClient(c, plan, clock=clk)

    elector = None
    if args.cluster.startswith("synthetic:"):
        from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
            CONFIGS,
            generate_cluster,
        )

        parts = args.cluster.split(":")
        try:
            spec = CONFIGS[int(parts[1])]
            seed = int(parts[2]) if len(parts) > 2 else 0
        except (KeyError, ValueError, IndexError):
            print(
                f"Error: unknown synthetic config {args.cluster!r} "
                f"(available: {sorted(CONFIGS)})",
                file=sys.stderr,
            )
            return 1
        log.info("Generating synthetic cluster %s (seed %d)", spec.name, seed)
        client = generate_cluster(spec, seed, reschedule_evicted=True)
        # the demo always runs on the fake cluster's virtual clock — pod
        # termination timers live on it
        clock = client.clock
        if config.chaos_profile:
            client = chaos_wrap(client, clock)
    elif args.cluster == "kube" or args.cluster.startswith("kube:"):
        from k8s_spot_rescheduler_tpu_torch.io.kube import (
            KubeClusterClient,
            from_environment,
        )
        from k8s_spot_rescheduler_tpu_torch.utils.clock import RealClock

        try:
            if args.cluster.startswith("kube:"):
                # explicit apiserver URL (e.g. kube:http://127.0.0.1:8080)
                client = KubeClusterClient(args.cluster.split(":", 1)[1])
            else:
                client = from_environment(
                    config.running_in_cluster, config.kubeconfig
                )
        except Exception as err:  # noqa: BLE001
            print(f"Error: failed to create kube client: {err}", file=sys.stderr)
            return 1
        # transient-read retry policy (io/kube.py backoff loop)
        client.retry_max = config.kube_retry_max
        client.retry_base = config.kube_retry_base
        from k8s_spot_rescheduler_tpu_torch.io import native_ingest

        # the native LIST decoder only carries the standard resources;
        # exotic --resources must flow through the Python decoders
        client.use_native_ingest = native_ingest.supports(config.resources)
        clock = RealClock()
        if config.chaos_profile:
            # wrapped UNDER the watch cache (below), so the watch
            # threads' streams traverse the chaos _stream hook (drop
            # injection) and writes/get_pod are faulted; the lease
            # elector's _request plumbing passes through untouched
            client = chaos_wrap(client, clock)
        if args.leader_elect:
            from k8s_spot_rescheduler_tpu_torch.io.lease import LeaseElector

            elector = LeaseElector(
                client,
                identity=args.leader_elect_identity,
                namespace=args.leader_elect_namespace,
                lease_duration=parse_duration(
                    args.leader_elect_lease_duration
                ),
            )
            # renew off-loop so a long drain never lets the lease lapse
            elector.start_background()
        if args.watch_cache:
            client = start_watch_client(client, config, clock)
    else:
        print(f"Error: unknown --cluster {args.cluster!r}", file=sys.stderr)
        return 1

    try:
        if config.planner_url or config.planner_urls:
            # agent mode: the solve crosses the wire to a planner
            # service (failover list supported); the rest stays local
            from k8s_spot_rescheduler_tpu_torch.service.agent import (
                RemotePlanner,
            )

            planner = RemotePlanner(config)
        else:
            planner = TorchSolverPlanner(config, device=args.device)
    except (RuntimeError, ValueError) as err:
        print(f"Error: {err}", file=sys.stderr)
        return 1
    r = Rescheduler(
        client, planner, config, clock=clock, recorder=client,
        # HA: a follower must not perform the startup taint sweep — it
        # could untaint the LEADER's in-flight drain; the per-tick sweep
        # runs once this replica is leader-gated into ticking
        startup_sweep=(elector is None or elector.is_leader),
        # taint-ownership holder id (defaults to the hostname); an
        # explicit lease identity overrides it
        identity=args.leader_elect_identity or None,
    )
    ticks = 0
    while args.ticks == 0 or ticks < args.ticks:
        # breaker-widened while consecutive observe errors persist
        clock.sleep(r.effective_interval())
        # a follower's skipped interval still counts toward --ticks so
        # bounded runs terminate whoever holds the lease
        ticks += 1
        if elector is not None and not elector.is_leader and not elector.ensure():
            log.vlog(2, "not the leader; standing by")
            continue
        result = _traced_tick(r, args.trace_dir)
        if result.drained or result.drain_failed:
            log.info(
                "tick %d: drained=%s failed=%s", ticks,
                result.drained, result.drain_failed,
            )
        elif result.report is not None:
            log.info(
                "tick %d: %d candidates, %d feasible, solve %.1f ms",
                ticks, result.report.n_candidates, result.report.n_feasible,
                result.report.solve_seconds * 1e3,
            )
        else:
            log.info("tick %d: skipped (%s)", ticks, result.skipped)
    # a bounded run ends its background threads before it reports
    if elector is not None:
        elector.stop_background()
    stop = getattr(client, "stop", None)
    if stop is not None:
        stop()
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics

    # ticks the host planner took over from a contained planner crash
    log.info(
        "planner_fallback_total=%d",
        int(metrics.robustness_snapshot()["planner_fallback"]),
    )
    if config.planner_url or config.planner_urls:
        # agent ticks that planned locally because no endpoint answered
        log.info(
            "remote_planner_fallback_total=%d",
            int(metrics.service_snapshot()["remote_planner_fallback"]),
        )
    return 0


def _traced_tick(r, trace_dir: str):
    """One tick, inside a ``tracing.device_trace`` when ``trace_dir``
    is set (one Chrome trace a tick)."""
    if not trace_dir:
        return r.tick()
    from k8s_spot_rescheduler_tpu_torch.utils import tracing

    with tracing.device_trace():
        return r.tick()


def serve(config: ReschedulerConfig, args) -> int:
    """``--serve``: the multi-tenant planner service on ``--device``, no
    control loop and no cluster client. SIGTERM drains gracefully
    (exit 0); a fault of the card's kernels ends it with exit 1."""
    from k8s_spot_rescheduler_tpu_torch.service.server import (
        ServiceFault,
        ServiceServer,
        install_sigterm_drain,
    )

    if not args.no_metrics_server:
        from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics

        metrics.serve(config.listen_address)
    log.info("Running planner service")
    try:
        server = ServiceServer(config, args.serve, device=args.device)
    except (RuntimeError, ValueError, OSError) as err:
        print(f"Error: {err}", file=sys.stderr)
        return 1
    # SIGTERM = graceful drain: stop admitting, finish queued batches
    # within service_drain_grace, persist warm state, exit
    install_sigterm_drain(server)
    try:
        server.serve_forever()
    except ServiceFault as err:
        print(f"Error: the planner service ended: {err}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Process entry point of the port.

The port of the JAX package's ``cli/main.py``: the reference's flag
surface (reference rescheduler.go:48-142: 13 pflag flags + glog's -v +
--version), the planner knobs, and the synthetic cluster source
(``--cluster synthetic:N[:seed]``), with ``--device`` (default
``cuda``) naming where the planner runs. The reference always talks to
a live apiserver; this entry point runs against synthetic clusters
behind the same ClusterClient interface.

Not in the parser yet, so argparse refuses them, each with the later
slice that brings it: ``--serve`` and the planner-service flags
(``--planner-url(s)``, ``--planner-timeout``, ``--delta-wire-enabled``,
``--service-*``, ``--device-sick-threshold``), the ``kube`` cluster
source with ``--running-in-cluster``, ``--kubeconfig``,
``--kube-retry-*``, ``--watch-cache``, ``--watch-progress-deadline``,
``--mirror-staleness-budget``, ``--resync-interval`` and
``--leader-elect*``, ``--use-columnar`` (no source of the port offers a
columnar mirror yet), the chaos
profile (``--chaos-*``), the mesh and memory ladder (``--mesh-shape``,
``--auto-shard``, ``--solver-hbm-budget``, ``--carry-chunks``),
``--debug-endpoints``, ``--trace-dir`` and the JAX-only
``--jax-cache-dir``.

Run e.g.::

    python -m k8s_spot_rescheduler_tpu_torch --cluster synthetic:1 --ticks 3 -v 2
    python -m k8s_spot_rescheduler_tpu_torch --cluster synthetic:1 --ticks 3 \
        --device cpu --no-metrics-server --node-drain-delay 1s
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
    p.add_argument("--namespace", default=d.namespace)
    p.add_argument("--housekeeping-interval", default="10s",
                   help="how often rescheduler takes actions (Go duration)")
    p.add_argument("--node-drain-delay", default="10m",
                   help="wait between draining nodes")
    p.add_argument("--pod-eviction-timeout", default="2m")
    p.add_argument("--max-graceful-termination", default="2m")
    p.add_argument("--listen-address", default=d.listen_address,
                   help="prometheus metrics address")
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
                        "numpy = the serial host oracle")
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
    p.add_argument("--cluster", default="synthetic:1",
                   help="cluster source: synthetic:<config#>[:seed]")
    p.add_argument("--ticks", type=int, default=0,
                   help="run N housekeeping ticks then exit (0 = forever)")
    p.add_argument("--no-metrics-server", action="store_true")
    return p


def _bool(s: str) -> bool:
    return str(s).lower() in ("1", "true", "yes")


def config_from_args(args) -> ReschedulerConfig:
    return ReschedulerConfig(
        namespace=args.namespace,
        housekeeping_interval=parse_duration(args.housekeeping_interval),
        node_drain_delay=parse_duration(args.node_drain_delay),
        pod_eviction_timeout=parse_duration(args.pod_eviction_timeout),
        max_graceful_termination=parse_duration(args.max_graceful_termination),
        listen_address=args.listen_address,
        delete_non_replicated_pods=args.delete_non_replicated_pods,
        on_demand_node_label=args.on_demand_node_label,
        spot_node_label=args.spot_node_label,
        priority_threshold=args.priority_threshold,
        eviction_retry_time=parse_duration(args.eviction_retry_time),
        max_pods_per_node_hint=args.max_pods_per_node_hint,
        max_drains_per_tick=args.max_drains_per_tick,
        fallback_best_fit=args.fallback_best_fit,
        solver=args.solver,
        repair_rounds=args.repair_rounds,
        incremental_device_cache=args.incremental_device_cache,
        staged_chunk_lanes=args.staged_chunk_lanes,
        staged_early_exit=args.staged_early_exit,
        plan_schedule_enabled=args.plan_schedule_enabled,
        schedule_horizon=args.schedule_horizon,
        breaker_threshold=args.breaker_threshold,
        breaker_max_interval=parse_duration(args.breaker_max_interval),
        reconcile_orphaned_taints=args.reconcile_orphaned_taints,
        trace_enabled=args.trace_enabled,
        flight_ring_size=args.flight_ring_size,
        flight_dump_dir=args.flight_dump_dir,
        resources=tuple(r for r in args.resources.split(",") if r),
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

    log.info("Running Rescheduler")
    if not args.no_metrics_server:
        from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics

        metrics.serve(config.listen_address)

    from k8s_spot_rescheduler_tpu_torch.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )

    if not args.cluster.startswith("synthetic:"):
        print(f"Error: unknown --cluster {args.cluster!r}", file=sys.stderr)
        return 1
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

    try:
        planner = TorchSolverPlanner(config, device=args.device)
    except (RuntimeError, ValueError) as err:
        print(f"Error: {err}", file=sys.stderr)
        return 1
    r = Rescheduler(client, planner, config, clock=clock, recorder=client)
    ticks = 0
    while args.ticks == 0 or ticks < args.ticks:
        # breaker-widened while consecutive observe errors persist
        clock.sleep(r.effective_interval())
        ticks += 1
        result = r.tick()
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
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics

    # ticks the host planner took over from a contained planner crash
    log.info(
        "planner_fallback_total=%d",
        int(metrics.robustness_snapshot()["planner_fallback"]),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

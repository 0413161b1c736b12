"""Framework configuration.

The port of the JAX package's ``utils/config.py``: the reference's flag
surface (reference rescheduler.go:48-108) and the cross-package mutable
globals it writes into (reference nodes/nodes.go:31-42:
``OnDemandNodeLabel``/``SpotNodeLabel``/``PriorityThreshold``) as one
explicit, immutable dataclass that is passed down the stack. It is the
one source of the planner's defaults too
(``planner/solver_planner.TorchSolverPlanner`` takes it). The JAX-only
``jax_cache_dir`` goes. The mesh knobs are the JAX package's; the
devices a mesh is laid over are not a knob but the planner's and the
service's ``devices`` argument.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

SOLVERS = ("torch", "numpy", "sharded")


@dataclasses.dataclass(frozen=True)
class ReschedulerConfig:
    """All knobs of the rescheduler, with the reference's defaults.

    Field-by-field parity with the reference flags:

    - ``running_in_cluster``      — rescheduler.go:53-55
    - ``namespace``               — rescheduler.go:57-58
    - ``housekeeping_interval``   — rescheduler.go:63-64 (10 s)
    - ``node_drain_delay``        — rescheduler.go:66-67 (10 min)
    - ``pod_eviction_timeout``    — rescheduler.go:69-71 (2 min)
    - ``max_graceful_termination``— rescheduler.go:73-75 (2 min)
    - ``listen_address``          — rescheduler.go:77-78
    - ``kubeconfig``              — rescheduler.go:82
    - ``delete_non_replicated_pods`` — rescheduler.go:84
    - ``on_demand_node_label``    — rescheduler.go:98-101
    - ``spot_node_label``         — rescheduler.go:102-105
    - ``priority_threshold``      — rescheduler.go:107-108
    - ``eviction_retry_time``     — scaler/scaler.go:37-38 (10 s; a const
      in the reference, a knob here)

    Additions (no reference equivalent):

    - ``resources``     — which resource dimensions the solver packs into the
      request/allocatable tensors.
    - ``max_pods_per_node_hint`` — static padding bound for the solver's pod
      axis; the packer grows it if a node exceeds the hint.
    - ``solver``        — "torch" (the union with kernels B1/B2 on the
      planner's device, the default), "numpy" (the serial host oracle)
      or "sharded" (first-fit and best-fit over the 2-D device mesh,
      ``parallel/sharded_ffd.plan_ffd_sharded``, under the union).
    - ``mesh_shape``    — (candidate-axis, spot-axis) device mesh for the
      sharded solver; (1, 1) = inferred from the device count.
    - ``max_drains_per_tick`` — the reference hard-codes one drain per tick
      (rescheduler.go:286 ``break``); keep 1 for faithful behavior.
    - ``fallback_best_fit`` — candidates unprovable under the reference's
      first-fit probe get a second feasibility pass under best-fit-
      decreasing packing (only ever adds drainable nodes).
    - ``repair_rounds`` — bounded eject-and-reinsert local-search rounds
      (solver/repair.py) for lanes both greedy passes fail; repaired
      placements are re-proven from scratch before use. 0 disables.
    - ``auto_shard`` — when the packed problem's estimated footprint
      exceeds one device's budget (solver/memory.py) and the planner
      has more than one device, the solve is rerouted down the ladder:
      the cand-sharded union per lane block (repair intact), the same
      with spot-chunked repair, the carry-streamed narrow union, and
      last the 2-D cand x spot layout (first-fit and best-fit; repair
      unavailable, alarmed by ``repair_unavailable``). Off → the
      configured solver runs unconditionally.
    - ``solver_hbm_budget`` — per-device byte budget for that decision;
      0 = the device's own (the card's memory x 0.85, or 16 GB x 0.85).
    - ``carry_chunks`` — spot chunks of the carry-streamed tier; 0 =
      sized to the budget (solver/memory.pick_carry_chunks).
    """

    running_in_cluster: bool = True
    namespace: str = "kube-system"
    housekeeping_interval: float = 10.0
    node_drain_delay: float = 600.0
    pod_eviction_timeout: float = 120.0
    max_graceful_termination: float = 120.0
    listen_address: str = "localhost:9235"
    kubeconfig: str = ""
    delete_non_replicated_pods: bool = False
    on_demand_node_label: str = "kubernetes.io/role=worker"
    spot_node_label: str = "kubernetes.io/role=spot-worker"
    priority_threshold: int = 0
    eviction_retry_time: float = 10.0

    # planner knobs
    resources: Sequence[str] = ("cpu", "memory")
    max_pods_per_node_hint: int = 64
    solver: str = "torch"
    mesh_shape: tuple = (1, 1)
    max_drains_per_tick: int = 1
    fallback_best_fit: bool = True
    repair_rounds: int = 8
    auto_shard: bool = True
    solver_hbm_budget: int = 0
    carry_chunks: int = 0
    # Observe via the incrementally-maintained columnar mirror
    # (models/columnar.py) when the cluster client provides one — the
    # vectorized replacement for the per-tick object-model rebuild. Off →
    # always the reference-faithful object path.
    use_columnar: bool = True
    # Incremental device-resident tick pipeline:
    # - ``incremental_device_cache`` keeps the previous tick's packed
    #   problem resident on the device and writes only the churn delta
    #   (models/delta.emit_packed_delta) each tick. Off → full upload
    #   every tick.
    # - ``staged_chunk_lanes`` solves candidate lanes in selection-order
    #   chunks of this size, skipping chunks the device prefilter
    #   (solver/prefilter.py) proves infeasible; 0 → unstaged full solve.
    # - ``staged_early_exit`` stops at the first chunk containing a
    #   feasible lane (the loop drains only the first feasible candidate,
    #   so the selection is identical); the reported feasible COUNT then
    #   covers the solved prefix only on ticks that found a drain.
    incremental_device_cache: bool = True
    staged_chunk_lanes: int = 256
    staged_early_exit: bool = True
    # Drain-to-exhaustion schedules (solver/schedule.py,
    # planner/schedule.py): one device fetch returns a whole drain
    # SCHEDULE (up to ``schedule_horizon`` steps) that the controller
    # executes across ticks, each step re-packed, precondition-checked,
    # and re-proven from scratch against the live cluster before any
    # eviction. ``schedule_horizon`` 0 is the documented opt-out
    # (per-tick single plans).
    plan_schedule_enabled: bool = True
    schedule_horizon: int = 32
    # --- chaos hardening ---
    # Transient-failure retry policy for kube API READS (io/kube.py):
    # up to kube_retry_max additional attempts with jittered exponential
    # backoff from kube_retry_base seconds (Retry-After honored). Writes
    # stay single-attempt — the actuator owns eviction/taint cadence.
    kube_retry_max: int = 4
    kube_retry_base: float = 0.25
    # Observe-error circuit breaker (loop/controller.py): after this many
    # consecutive error-skipped ticks the effective housekeeping interval
    # doubles per further failure, capped at breaker_max_interval;
    # 0 disables the breaker.
    breaker_threshold: int = 3
    breaker_max_interval: float = 300.0
    # Crash-safe drain recovery: on startup and once per tick, remove
    # ToBeDeleted taints no active drain owns.
    reconcile_orphaned_taints: bool = True
    # Fault injection (io/chaos.py): wrap the cluster client in the
    # seeded chaos layer. Empty profile = off (production default).
    chaos_profile: str = ""
    chaos_seed: int = 0
    # Per-stream-open probability that an injected chaos watch stream is
    # open but SILENT until the client's read timeout (the wedged-stream
    # failure mode the progress deadline exists to catch). Mixed into
    # whatever --chaos-profile selects; 0 with chaos off is inert.
    chaos_watch_stall_rate: float = 0.0
    # --- freshness-gated observe path ---
    # Client-side watch progress deadline (io/watch.py): a stream that
    # delivers no event, bookmark, or clean server close for this long
    # is killed and reconnected from its last resourceVersion. 0
    # disables (server timeouts only).
    watch_progress_deadline: float = 120.0
    # Freshness gate (loop/controller.py): a tick whose watch mirror is
    # older than this budget refuses to plan from it — it degrades to a
    # direct apiserver LIST, or skips the tick (feeding the circuit
    # breaker) when no direct path exists. 0 disables the gate.
    mirror_staleness_budget: float = 60.0
    # Anti-entropy resync audit (io/watch.py): every interval, one LIST
    # per watched resource is diffed field-by-field against the
    # incremental mirror; drift forces a store replace + full repack.
    # Runs inline on the tick thread. 0 disables.
    resync_interval: float = 300.0
    # --- the multi-tenant planner service and its agents (service/) ---
    # Agent mode: plan through a remote planner service instead of the
    # in-process solver (observe, pack and actuate stay local; packed
    # tensors cross the binary wire of service/wire.py; when every
    # endpoint is unusable the tick plans on the local numpy oracle).
    # Empty = plan in-process.
    planner_url: str = ""
    # An ORDERED comma-separated list of planner endpoints, each with its
    # own consecutive-failure breaker; takes precedence over planner_url.
    planner_urls: str = ""
    # Per-plan HTTP deadline of the agent's service call.
    planner_timeout: float = 10.0
    # Ship each tick's churn delta (wire v4) to an endpoint that holds
    # the previous pack; any disagreement costs one full-pack resync.
    delta_wire_enabled: bool = True
    # Device-health watchdog (service/devhealth.py): consecutive
    # slower-than-baseline batched solves before the service serves
    # from the numpy-oracle host path; 0 disables the watchdog. A fault
    # of the card's kernels is not a verdict: it ends the service.
    device_sick_threshold: int = 3
    # Graceful drain (SIGTERM): seconds queued batches may finish before
    # the rest are evicted with 503.
    service_drain_grace: float = 5.0
    # Warm restart: directory of the per-tenant pack fingerprints and
    # the recently-used bucket list; empty = cold restarts.
    service_state_dir: str = ""
    # Service-path fault injection (service/chaos.py): seeded wire/HTTP/
    # solve faults on the agent transport and the service solve hook.
    # Empty profile = off (production default) — testing/demo only.
    service_chaos_profile: str = ""
    service_chaos_seed: int = 0
    # How long the batching scheduler waits to coalesce concurrent
    # tenants into one batch; 0 = dispatch immediately.
    service_batch_window: float = 0.02
    # Bounded queue wait before 503 + Retry-After (measured cadence).
    service_queue_timeout: float = 30.0
    # Resync-storm admission class: concurrent full-pack resync ingests
    # allowed, and their byte ledger (0 = the device memory budget).
    service_resync_ingest_cap: int = 4
    service_resync_ingest_budget: int = 0
    # --- tick tracing + flight recorder ---
    # Per-tick span-tree tracing (utils/tracing.py); off = the phase
    # histograms alone.
    trace_enabled: bool = True
    # Flight recorder (loop/flight.py): how many completed tick traces
    # the in-memory postmortem ring retains.
    flight_ring_size: int = 64
    # Directory the flight recorder auto-dumps a redacted JSON
    # postmortem into whenever a degradation edge fires; empty = never
    # write to disk.
    flight_dump_dir: str = ""
    # Serve GET /debug/trace (last tick tree + recent server span
    # blocks) and /debug/flight (ring summary + dump trigger) on the
    # planner service's HTTP server. Off by default: debug surfaces are
    # opt-in, never ambient (off, both paths answer 404).
    debug_endpoints: bool = False

    def __post_init__(self):
        from k8s_spot_rescheduler_tpu_torch.utils.labels import validate_label

        validate_label(self.on_demand_node_label, "on demand node label")
        validate_label(self.spot_node_label, "spot node label")
        if self.solver not in SOLVERS:
            raise ValueError(
                f"unknown solver {self.solver!r} (known: {', '.join(SOLVERS)})"
            )
        if self.max_drains_per_tick < 1:
            raise ValueError("max_drains_per_tick must be >= 1")
        if self.staged_chunk_lanes < 0:
            raise ValueError("staged_chunk_lanes must be >= 0 (0 = unstaged)")
        if self.carry_chunks < 0:
            raise ValueError("carry_chunks must be >= 0 (0 = auto)")
        if self.schedule_horizon < 0:
            raise ValueError(
                "schedule_horizon must be >= 0 (0 = schedules off)"
            )
        if not self.resources:
            raise ValueError("resources must be non-empty")
        if self.kube_retry_max < 0:
            raise ValueError("kube_retry_max must be >= 0 (0 = no retries)")
        if self.kube_retry_base <= 0:
            raise ValueError("kube_retry_base must be > 0")
        if self.breaker_threshold < 0:
            raise ValueError("breaker_threshold must be >= 0 (0 = off)")
        if self.watch_progress_deadline < 0:
            raise ValueError(
                "watch_progress_deadline must be >= 0 (0 = off)"
            )
        if self.mirror_staleness_budget < 0:
            raise ValueError(
                "mirror_staleness_budget must be >= 0 (0 = off)"
            )
        if self.resync_interval < 0:
            raise ValueError("resync_interval must be >= 0 (0 = off)")
        if self.flight_ring_size < 1:
            raise ValueError("flight_ring_size must be >= 1")
        if self.planner_timeout <= 0:
            raise ValueError("planner_timeout must be > 0")
        if self.service_batch_window < 0:
            raise ValueError(
                "service_batch_window must be >= 0 (0 = no coalescing)"
            )
        if self.service_queue_timeout <= 0:
            raise ValueError("service_queue_timeout must be > 0")
        if self.service_resync_ingest_cap < 1:
            raise ValueError(
                "service_resync_ingest_cap must be >= 1 (the class "
                "must admit at least one ingest or no tenant can ever "
                "seed its cache)"
            )
        if self.service_resync_ingest_budget < 0:
            raise ValueError(
                "service_resync_ingest_budget must be >= 0 (0 = derive "
                "from the device memory budget)"
            )
        if self.device_sick_threshold < 0:
            raise ValueError(
                "device_sick_threshold must be >= 0 (0 = watchdog off)"
            )
        if self.service_drain_grace < 0:
            raise ValueError(
                "service_drain_grace must be >= 0 (0 = evict queued "
                "work immediately on drain)"
            )
        from k8s_spot_rescheduler_tpu_torch.io.chaos import FaultPlan
        from k8s_spot_rescheduler_tpu_torch.service.chaos import (
            ServiceFaultPlan,
        )

        if self.chaos_profile not in FaultPlan.PROFILES:
            raise ValueError(
                f"unknown chaos_profile {self.chaos_profile!r} "
                f"(known: {', '.join(p for p in FaultPlan.PROFILES if p)})"
            )
        if self.service_chaos_profile not in ServiceFaultPlan.PROFILES:
            raise ValueError(
                f"unknown service_chaos_profile "
                f"{self.service_chaos_profile!r} "
                f"(known: {', '.join(p for p in ServiceFaultPlan.PROFILES if p)})"
            )
        if not 0.0 <= self.chaos_watch_stall_rate <= 1.0:
            raise ValueError(
                "chaos_watch_stall_rate must be a probability in [0, 1]"
            )

"""The housekeeping control loop.

The port of the JAX package's ``loop/controller.py``. It plans through
``planner/solver_planner.TorchSolverPlanner`` (or any object with the
``Planner`` surface), and its crash containment degrades to the same
planner with ``solver="numpy"`` -- except for a fault of the card's
kernels (``ops/ffd_kernels.is_device_fault``) while the planner runs on
a CUDA device: that one is never contained, and ``tick()`` raises it,
so no tick's work moves to the host because a kernel failed to build,
load or launch. A tick observes through the columnar mirror
(``_columnar_store``, ``_wrap_columnar``) whenever the client offers one
(``io/fake.FakeCluster``, ``io/watch.WatchingKubeClusterClient``), the
planner accepts one and ``config.use_columnar`` is on, as the
reference's does; otherwise through the object path. The watch
mirror's freshness gate and anti-entropy audit read
``config.mirror_staleness_budget`` and ``config.resync_interval``.

Reimplements the reference's ``run`` (reference rescheduler.go:144-293) —
the level-triggered observe → plan → actuate tick — against the
ClusterClient/Planner interfaces:

per tick:
1. gate: drain-delay cooldown still running → skip (rescheduler.go:167-170);
2. gate: any unschedulable pods → skip, don't make things worse
   (rescheduler.go:172-181);
3. observe: list ready nodes, build the classified node map
   (rescheduler.go:186-199), update metrics (202), list PDBs (205);
4. plan: prove per-candidate drain feasibility (the Planner replaces the
   canDrainNode/findSpotNodeForPod nest, rescheduler.go:228-275);
5. actuate: drain the first feasible node, arm the cooldown, stop — at
   most ``max_drains_per_tick`` (=1, faithful) drains per tick
   (rescheduler.go:280-286);
6. any observation error skips the tick (`continue`), never crashes the
   loop — the recovery story is "recompute everything next tick"
   (SURVEY.md §5.3).

Chaos hardening beyond the reference (docs/ROBUSTNESS.md):

- a planner exception (other than a fault of the card's kernels)
  degrades the tick to the CPU numpy-oracle fallback
  planner instead of killing ``run_forever`` (``planner_fallback_total``;
  /healthz reports ``degraded: true`` until a clean primary tick);
- consecutive error-skipped ticks past ``breaker_threshold`` engage a
  circuit breaker that doubles the effective housekeeping interval per
  further failure, capped at ``breaker_max_interval``, resetting on the
  next completed tick;
- on startup and once per tick, orphaned ``ToBeDeleted`` taints are
  removed (``ReschedulerRecovered`` event) — a drain interrupted between
  taint and cleanup must not permanently unschedule an on-demand node
  (the reference leaves that residue for the cluster autoscaler to
  collect). Ownership is explicit: the drain stamps the taint value
  with a rescheduler marker + holder identity + wall timestamp, and the
  sweep only ever removes taints carrying that marker — the cluster
  autoscaler applies the SAME taint key during its own scale-downs
  (on-demand nodes included: a drained-empty node is exactly what CA is
  expected to delete), and stripping CA's taint would abort the
  scale-down that is the product's end goal. Another replica's marked
  taint (HA: a demoted leader may still be mid-drain) is only swept once
  older than any drain could run.
"""

from __future__ import annotations

import dataclasses
import socket
import time
from typing import List, Optional

from k8s_spot_rescheduler_tpu_torch.actuator.drain import DrainError, drain_node
from k8s_spot_rescheduler_tpu_torch.io.cluster import ClusterClient, EventSink
from k8s_spot_rescheduler_tpu_torch.loop import flight, health
from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.models.cluster import (
    NodeMap,
    TO_BE_DELETED_TAINT,
    build_node_map,
    parse_rescheduler_taint_value,
    rescheduler_taint_identity,
)
from k8s_spot_rescheduler_tpu_torch.models.evictability import get_pods_for_deletion
from k8s_spot_rescheduler_tpu_torch.ops.ffd_kernels import is_device_fault
from k8s_spot_rescheduler_tpu_torch.planner.base import Planner, PlanReport
from k8s_spot_rescheduler_tpu_torch.utils.clock import Clock, RealClock
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig
from k8s_spot_rescheduler_tpu_torch.utils import logging as log
from k8s_spot_rescheduler_tpu_torch.utils import tracing


@dataclasses.dataclass
class TickResult:
    """What one housekeeping pass did (the loop's unit-test surface)."""

    skipped: str = ""  # "", "cooldown", "unschedulable", "error"
    drained: List[str] = dataclasses.field(default_factory=list)
    drain_failed: List[str] = dataclasses.field(default_factory=list)
    report: Optional[PlanReport] = None
    # this tick's plan came from the CPU fallback planner (the configured
    # planner raised and was contained)
    planner_fallback: bool = False
    # orphaned ToBeDeleted taints the pre-tick sweep removed
    recovered_taints: List[str] = dataclasses.field(default_factory=list)


class _NullRecorder:
    def event(self, kind, name, event_type, reason, message):
        pass


class Rescheduler:
    def __init__(
        self,
        client: ClusterClient,
        planner: Planner,
        config: ReschedulerConfig,
        *,
        clock: Optional[Clock] = None,
        recorder: Optional[EventSink] = None,
        startup_sweep: bool = True,
        identity: Optional[str] = None,
    ):
        self.client = client
        self.planner = planner
        self.config = config
        self.clock = clock or RealClock()
        self.recorder = recorder or _NullRecorder()
        # stable holder id stamped into drain taints (ownership for the
        # orphan sweep). Must survive a restart of the same replica —
        # the startup sweep heals OUR orphans immediately — and differ
        # between HA replicas, so the hostname (pod name), overridable
        # via --leader-elect-identity.
        self.identity = identity or socket.gethostname()
        # start processing straight away (rescheduler.go:158-159)
        self.next_drain_time = self.clock.now()
        # --- chaos hardening state ---
        # error-skipped ticks in a row (feeds the circuit breaker)
        self._consecutive_errors = 0
        # lazily-built CPU fallback planner (planner crash containment)
        self._fallback_planner = None
        # nodes a drain is actively running on: the orphaned-taint sweep
        # must never untaint a drain in progress (single-threaded today,
        # so empty at every sweep — load-bearing if actuation ever forks)
        self._active_drains: set = set()
        # pending drain schedule (planner/schedule.py): cut by
        # plan_schedule in one device fetch, executed across ticks with
        # per-step live validation; dropped on invalidation/exhaustion
        self._schedule = None
        # churn hysteresis for the default-on schedule path: a schedule
        # churn kills before it served 2 steps wasted a horizon-deep
        # sweep for at most one drain, and under CONSTANT churn (replay-
        # grade event streams) that waste would recur every tick. Each
        # such early invalidation doubles a per-tick-planning backoff
        # window (capped); a schedule that serves >= 2 steps — or runs
        # to exhaustion — resets it. Amortized schedule overhead under
        # constant churn is therefore bounded at ~horizon/cap extra
        # solves per tick instead of horizon per tick.
        self._sched_backoff = 0  # ticks left planning per-tick
        self._sched_backoff_next = 1  # next window on early invalidation
        # --- freshness gate state (docs/ROBUSTNESS.md) ---
        # the client this tick's READS go to: the configured client, or
        # its direct (cache-bypassing) twin while the watch mirror is
        # staler than mirror_staleness_budget; writes always go to
        # self.client
        self._observe_client = client
        # next anti-entropy audit, wall clock; armed on the first tick
        # (the startup LIST is itself fresh)
        self._next_resync_wall: Optional[float] = None
        health.STATE.set_clock(self.clock.now)
        # flight recorder (loop/flight.py): ring size + dump dir come
        # from config; recorded history survives reconstruction (the
        # chaos soak restarts the controller mid-run)
        flight.configure(
            ring_size=config.flight_ring_size,
            dump_dir=config.flight_dump_dir,
        )
        if config.reconcile_orphaned_taints and startup_sweep:
            # startup sweep: a previous process may have died mid-drain,
            # leaving a ToBeDeleted taint nobody owns. ``startup_sweep``
            # is passed False by HA deployments for non-leader replicas
            # (a follower must not write — the per-tick sweep runs once
            # it is leader-gated into ticking); single-replica callers
            # keep the default and heal immediately on restart.
            self.reconcile_orphaned_taints()

    # --- observation ---

    def _columnar_store(self):
        """The vectorized observe path (models/columnar.py): used when the
        client maintains a columnar mirror, the planner can consume it,
        and the config hasn't forced the object path."""
        if not self.config.use_columnar:
            return None
        if self._observe_client is not self.client:
            # freshness bypass in effect: the mirror is the thing being
            # bypassed — this tick observes via direct LISTs only
            return None
        if not getattr(self.planner, "accepts_columnar", False):
            return None
        factory = getattr(self.client, "columnar_store", None)
        if factory is None:
            return None
        try:
            return factory(
                self.config.resources,
                on_demand_label=self.config.on_demand_node_label,
                spot_label=self.config.spot_node_label,
            )
        except Exception as err:  # noqa: BLE001, exception-discipline — fall back to objects: the reference-faithful observe path runs instead; nothing is lost, only vectorization
            log.error("Columnar observe unavailable: %s", err)
            return None

    def observe(self) -> Optional[NodeMap]:
        client = self._observe_client
        try:
            nodes = client.list_ready_nodes()
            # not-ready nodes are presence-only (zone/spread counts —
            # their pods still exist to the real scheduler). All in-tree
            # clients implement the lister; the fallback exists for
            # third-party clients, whose spread/zone verdicts then rest
            # on ready-node visibility alone.
            lister = getattr(client, "list_unready_nodes", None)
            unready = lister() if lister is not None else []
            pods_by_node = {
                n.name: client.list_pods_on_node(n.name)
                for n in list(nodes) + list(unready)
            }
        except Exception as err:  # noqa: BLE001, exception-discipline — skip tick on any API error: the None return flows into the skipped="error" path whose breaker/health accounting (note_error) records it
            log.error("Failed to list cluster state: %s", err)
            return None
        return build_node_map(
            nodes,
            pods_by_node,
            on_demand_label=self.config.on_demand_node_label,
            spot_label=self.config.spot_node_label,
            priority_threshold=self.config.priority_threshold,
            unready_nodes=unready,
        )

    def _update_metrics(self, node_map: NodeMap, pdbs) -> None:
        cfg = self.config
        metrics.update_nodes_map(
            cfg.on_demand_node_label,
            cfg.spot_node_label,
            len(node_map.on_demand),
            len(node_map.spot),
        )
        # pods-the-rescheduler-understands per node, both classes
        # (rescheduler.go:259 for on-demand, 385-399 for spot)
        for info in node_map.on_demand:
            pods, _ = get_pods_for_deletion(
                info.pods, pdbs,
                delete_non_replicated=cfg.delete_non_replicated_pods,
            )
            metrics.update_node_pods_count(
                cfg.on_demand_node_label, info.node.name, len(pods)
            )
        for info in node_map.spot:
            pods, _ = get_pods_for_deletion(
                info.pods, pdbs,
                delete_non_replicated=cfg.delete_non_replicated_pods,
            )
            metrics.update_node_pods_count(
                cfg.spot_node_label, info.node.name, len(pods)
            )

    def _wrap_columnar(self, store, pdbs):
        from k8s_spot_rescheduler_tpu_torch.models.columnar import ColumnarObservation

        cfg = self.config
        return ColumnarObservation(
            store=store,
            verdicts=store.verdicts(
                pdbs,
                priority_threshold=cfg.priority_threshold,
                delete_non_replicated=cfg.delete_non_replicated_pods,
            ),
        )

    def _tick_metrics(self, observation, pdbs) -> None:
        """The per-tick metrics pass (pure host work). In the pipelined
        tick it runs while the device solve is in flight."""
        if isinstance(observation, NodeMap):
            self._update_metrics(observation, pdbs)
            if not observation.on_demand:
                log.vlog(2, "No nodes to process.")
        else:
            self._update_metrics_columnar(observation, pdbs)

    def _update_metrics_columnar(self, obs, pdbs) -> None:
        cfg = self.config
        od, spot = obs.store.node_pod_counts(
            pdbs,
            priority_threshold=cfg.priority_threshold,
            delete_non_replicated=cfg.delete_non_replicated_pods,
            verdicts=obs.verdicts,
        )
        metrics.update_nodes_map(
            cfg.on_demand_node_label, cfg.spot_node_label, len(od), len(spot)
        )
        if not od:
            log.vlog(2, "No nodes to process.")
        for name, count in od:
            metrics.update_node_pods_count(cfg.on_demand_node_label, name, count)
        for name, count in spot:
            metrics.update_node_pods_count(cfg.spot_node_label, name, count)

    # --- planner crash containment ---

    def _dispatch_plan(self, observation, pdbs, run_metrics: bool):
        """Run the (possibly pipelined) plan on the configured planner;
        raises whatever the planner raises — ``_plan_guarded`` owns the
        degradation policy."""
        plan_async = getattr(self.planner, "plan_async", None)
        if plan_async is not None:
            # Pipelined tick: pack + delta-upload + async solve dispatch
            # first, then the host-side metrics pass runs while the
            # device solve is in flight (asynchronous dispatch); only the
            # tiny selection fetch blocks. The phase split makes the
            # overlap measurable: observe-metrics wall time is hidden
            # behind the solve, so plan-dispatch + plan-fetch < the old
            # monolithic plan phase whenever the solve outlasts it.
            t0 = time.perf_counter()
            with tracing.phase("plan-dispatch"):
                finish = plan_async(observation, pdbs)
            t1 = time.perf_counter()
            if run_metrics:
                with tracing.phase("observe-metrics"):
                    self._tick_metrics(observation, pdbs)
            t2 = time.perf_counter()
            with tracing.phase("plan-fetch"):
                report = finish()
            # aggregate plan phase (dashboard continuity): the host time
            # actually spent planning, excluding the overlapped window
            metrics.observe_tick_phase(
                "plan", (t1 - t0) + (time.perf_counter() - t2)
            )
        else:
            if run_metrics:
                with tracing.phase("observe-metrics"):
                    self._tick_metrics(observation, pdbs)
            with tracing.phase("plan"):
                report = self.planner.plan(observation, pdbs)
        return report

    def _fallback(self):
        """The CPU numpy-oracle planner a crashing configured planner
        degrades to — same Planner surface, no device dependency, built
        once on first use."""
        if self._fallback_planner is None:
            from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
                TorchSolverPlanner,
            )

            self._fallback_planner = TorchSolverPlanner(
                dataclasses.replace(self.config, solver="numpy")
            )
        return self._fallback_planner

    def _device_fault(self, err: BaseException) -> bool:
        """True when ``err`` is a fault of the card's kernels and the
        planner runs on a CUDA device: not contained, so the tick's
        work never moves to the host planner because a kernel failed."""
        device = getattr(self.planner, "device", None)
        return getattr(device, "type", None) == "cuda" and is_device_fault(err)

    def _plan_guarded(self, observation, pdbs, *, run_metrics: bool = True):
        """(report | None, used_fallback): any planner exception degrades
        the tick to the CPU fallback planner instead of crashing the
        loop, except a fault of the card's kernels (``_device_fault``),
        which propagates. None only when the fallback failed too (the
        tick then skips under the observe-error policy)."""
        try:
            return self._dispatch_plan(observation, pdbs, run_metrics), False
        except Exception as err:  # noqa: BLE001 — contain ANY solver crash
            if self._device_fault(err):
                raise
            log.error(
                "Planner %r failed: %s; degrading tick to the numpy-oracle "
                "fallback", self.config.solver, err,
            )
            # one event, three surfaces: the Prometheus counter, the
            # /healthz field and the flight-recorder event fire together,
            # per contained planner exception (re-plans inside a
            # multi-drain tick included), so the three never diverge
            metrics.update_planner_fallback()
            health.STATE.note_planner_fallback()
            flight.note_event(
                "planner-fallback",
                cause=f"{type(err).__name__}: {err}",
                trace_id=tracing.current_trace_id(),
                solver=self.config.solver,
            )
        try:
            if run_metrics:
                # the primary may have died before its metrics pass ran;
                # gauge updates are idempotent, so re-running is safe
                with tracing.phase("observe-metrics"):
                    self._tick_metrics(observation, pdbs)
            with tracing.phase("plan"):
                return self._fallback().plan(observation, pdbs), True
        except Exception as err:  # noqa: BLE001, exception-discipline — both planners dead: the None return becomes skipped="error", counted by the breaker/health path (the primary's crash already fired planner_fallback + the flight event)
            log.error("Fallback planner failed too: %s", err)
            return None, True

    # --- drain-schedule execution (planner/schedule.py) ---

    def _next_plan(self, observation, pdbs, *, run_metrics: bool = True):
        """(report | None, used_fallback): the tick's drain decision —
        from the pending drain schedule when ``plan_schedule_enabled``
        and the planner supports it (one device fetch per
        ``schedule_horizon`` drains), else the per-tick plan path.
        Every schedule-served step was re-packed, precondition-checked
        and from-scratch validated against the live mirror inside
        ``DrainSchedule.next_plan``; any schedule-machinery failure
        degrades to the ordinary guarded per-tick plan."""
        plan_schedule = (
            getattr(self.planner, "plan_schedule", None)
            if self.config.plan_schedule_enabled
            and self.config.schedule_horizon >= 1  # 0 = documented opt-out
            else None
        )
        if plan_schedule is None:
            return self._plan_guarded(
                observation, pdbs, run_metrics=run_metrics
            )
        if self._schedule is None and self._sched_backoff > 0:
            # churn hysteresis window: recent schedules died before
            # paying for themselves — plan per-tick until it expires
            self._sched_backoff -= 1
            return self._plan_guarded(
                observation, pdbs, run_metrics=run_metrics
            )
        try:
            report = self._schedule_step(observation, pdbs, plan_schedule)
        except Exception as err:  # noqa: BLE001, exception-discipline — schedule machinery crash: the tick falls through to _plan_guarded below, whose own containment counts planner failures; nothing is lost but the fetch amortization
            if self._device_fault(err):
                raise
            log.error(
                "Drain-schedule path failed (%s); planning per tick", err
            )
            self._schedule = None
            report = None
        if report is None:
            return self._plan_guarded(
                observation, pdbs, run_metrics=run_metrics
            )
        if run_metrics:
            with tracing.phase("observe-metrics"):
                self._tick_metrics(observation, pdbs)
        # dashboard continuity: schedule-served ticks still record a
        # plan phase (the validation + any schedule-cut fetch)
        metrics.observe_tick_phase("plan", report.solve_seconds)
        return report, False

    def _note_schedule_outcome(self, sched) -> None:
        """Feed the churn hysteresis from an invalidated schedule's
        accounting. A schedule that served >= 2 steps amortized its cut
        (one fetch bought several drains): clear any backoff. One that
        churn killed with >= 2 UNSERVED steps wasted a horizon-deep
        sweep: open (and double, capped) the per-tick window. Schedules
        that exhaust never enter here — ``_schedule_step`` resets the
        ladder at their drop site (the device while-loop stops at
        exhaustion, so a short schedule only ever cost its own length
        in solves). Zero-step cuts cost one solve (== a per-tick plan)
        and never back off either."""
        if sched.cursor >= 2:
            self._sched_backoff = 0
            self._sched_backoff_next = 1
        elif len(sched.steps) - sched.cursor >= 2:
            self._sched_backoff = self._sched_backoff_next
            self._sched_backoff_next = min(64, self._sched_backoff_next * 2)

    def _note_schedule_invalidated(self, sched) -> None:
        """One edge, three surfaces: the counter, the flight event and
        the log line fire together so they can never diverge."""
        metrics.update_schedule_invalidated()
        flight.note_event(
            "schedule-invalidated",
            cause=sched.invalid_reason or "live mirror diverged from the "
                  "schedule's predicted state",
            trace_id=tracing.current_trace_id(),
            step=sched.cursor,
            schedule_len=len(sched.steps),
        )
        log.error(
            "Drain schedule invalidated at step %d/%d (%s); re-planning",
            sched.cursor, len(sched.steps), sched.invalid_reason,
        )

    def _schedule_step(self, observation, pdbs, plan_schedule):
        """Serve the next validated schedule step, cutting a fresh
        schedule when none is pending; None degrades to per-tick
        planning."""
        sched = self._schedule
        if sched is not None and sched.exhausted and not sched.invalidated:
            # ran to exhaustion: the cut paid for itself in full —
            # clear the churn-hysteresis ladder before replacing it
            self._sched_backoff = 0
            self._sched_backoff_next = 1
        elif sched is not None and not sched.invalidated:
            report = sched.next_plan(observation, pdbs)
            if report is not None:
                return report
            if sched.invalidated:
                self._note_schedule_invalidated(sched)
                self._note_schedule_outcome(sched)
        self._schedule = None
        if self._sched_backoff > 0:
            # the early invalidation above just opened (or re-opened) a
            # hysteresis window: degrade this tick to per-tick planning
            # instead of paying another doomed horizon-deep cut
            self._sched_backoff -= 1
            return None
        sched = plan_schedule(observation, pdbs)
        if sched is None:
            return None  # planner cannot schedule this problem
        report = sched.next_plan(observation, pdbs)
        if report is None:
            if sched.invalidated:
                # structurally impossible (the schedule was cut from
                # this very observation) but counted, not assumed
                self._note_schedule_invalidated(sched)
                self._note_schedule_outcome(sched)
                return None
            # zero-step schedule: nothing drainable this tick
            return sched.empty_report()
        self._schedule = sched
        return report

    # --- crash-safe drain recovery ---

    def taint_sweep_grace(self) -> float:
        """How long a rescheduler-marked taint written by ANOTHER holder
        can still belong to a live drain. A drain's SCHEDULED lifetime
        is bounded by ``pod_eviction_timeout``, but its final
        eviction/verify rounds start before that deadline and then run
        in real time (sequential apiserver calls, each with its own
        socket timeout, against a possibly slow apiserver) — so the
        horizon doubles the timeout and adds flat slack rather than
        cutting it close; undercutting a live drain uncordons a node
        mid-eviction, while an over-long grace merely delays healing a
        FOREIGN orphan (own-identity orphans heal immediately). Assumes
        HA replicas run the same ``pod_eviction_timeout`` — a rolling
        config change that shrinks it should finish rolling out before
        the old leader's drains are considered sweepable."""
        return 2.0 * self.config.pod_eviction_timeout + 600.0

    def reconcile_orphaned_taints(self) -> List[str]:
        """Remove rescheduler-owned ``ToBeDeleted`` taints no active
        drain owns.

        A drain interrupted between ``add_taint`` and its deferred
        cleanup (process crash, failed un-taint) leaves the node
        permanently unschedulable; the reference relies on the cluster
        autoscaler to collect such nodes, but a spot RESCHEDULER's
        on-demand nodes are exactly the ones CA should keep. Runs on
        startup and once per tick; list/un-taint failures are logged and
        retried next tick (the sweep is idempotent). Returns the
        recovered node names.

        Ownership: only taints whose VALUE carries the rescheduler
        marker (written by ``drain_node``) are candidates. The cluster
        autoscaler applies the same taint key during its own
        scale-downs — on spot nodes AND on the drained-empty on-demand
        nodes this rescheduler produces for it — with a bare-timestamp
        value; those are never touched. A marked taint held by a
        DIFFERENT identity (HA: a demoted leader may still be mid-drain
        after losing the lease) is only swept once older than
        ``taint_sweep_grace()`` — no drain can outlive that horizon, so
        a live drain's taint is never removed from under it. Our own
        identity's taints sweep immediately: within this process
        ``_active_drains`` covers live drains, and across a restart the
        previous same-named incarnation is dead by definition.

        Cost: the in-tree clients serve these listers from their
        per-tick cache (polling) or watch cache, so the pre-gate sweep
        reads the PREVIOUS tick's node view and issues no extra LIST —
        one tick of staleness just means an orphan heals a tick later."""
        try:
            nodes = list(self.client.list_ready_nodes())
            lister = getattr(self.client, "list_unready_nodes", None)
            if lister is not None:
                nodes += list(lister())
        except Exception as err:  # noqa: BLE001, exception-discipline — sweep retries next tick; an orphan heals one tick later and the read failure was already counted by the kube retry layer
            log.error("Orphaned-taint sweep skipped (list failed): %s", err)
            return []
        from k8s_spot_rescheduler_tpu_torch.utils.labels import matches_label

        own = rescheduler_taint_identity(self.identity)
        # wall(), not now(): taint stamps are epoch seconds shared
        # across processes; a clock without wall() must fail loudly
        # rather than compare monotonic seconds against them
        now_wall = self.clock.wall()
        recovered: List[str] = []
        for node in nodes:
            if not matches_label(node.labels, self.config.on_demand_node_label):
                continue  # not ours: only on-demand nodes are ever drained
            if node.name in self._active_drains:
                continue
            taint = next(
                (t for t in node.taints if t.key == TO_BE_DELETED_TAINT), None
            )
            if taint is None:
                continue
            parsed = parse_rescheduler_taint_value(taint.value)
            if parsed is None:
                continue  # CA's (or another component's) taint: not ours
            holder, stamped = parsed
            if (
                holder != own
                and stamped is not None
                and now_wall - stamped < self.taint_sweep_grace()
            ):
                continue  # possibly another replica's LIVE drain
            # an unparsable stamp on a MARKED taint is treated as
            # infinitely old (mangled value, other version's layout):
            # skipping it forever would leave exactly the permanent
            # NoSchedule residue this sweep exists to remove
            try:
                self.client.remove_taint(node.name, TO_BE_DELETED_TAINT)
            except Exception as err:  # noqa: BLE001, exception-discipline — retried next tick by the same sweep; success is what's counted (orphaned_taints_recovered)
                log.error(
                    "Failed to remove orphaned taint on %s: %s "
                    "(will retry next tick)", node.name, err,
                )
                continue
            recovered.append(node.name)
            metrics.update_taint_recovered()
            health.STATE.note_taint_recovered()
            flight.note_event(
                "orphan-taint-recovered",
                cause="removed orphaned ToBeDeleted taint left by an "
                      "interrupted drain",
                trace_id=tracing.current_trace_id(),
                node=node.name,
            )
            log.info("Recovered orphaned %s taint on %s",
                     TO_BE_DELETED_TAINT, node.name)
            self.recorder.event(
                "Node", node.name, "Normal", "ReschedulerRecovered",
                "removed orphaned ToBeDeleted taint left by an "
                "interrupted drain",
            )
        if recovered:
            # a polling client's node cache still shows the taints just
            # removed (the pre-gate sweep deliberately reads the
            # previous tick's view); drop it so cooldown-skipped ticks
            # — which never reach the gate's per-tick refresh — don't
            # re-"recover" the same orphan every sweep (duplicate
            # events, inflated counter, needless PATCHes)
            refresh = getattr(self.client, "refresh", None)
            if refresh is not None:
                try:
                    refresh()
                except Exception as err:  # noqa: BLE001, exception-discipline — advisory cache hygiene: the worst case is one redundant re-recovery next tick, itself counted
                    log.error(
                        "Cache refresh after taint recovery failed: %s", err
                    )
        return recovered

    # --- freshness gate + anti-entropy audit (docs/ROBUSTNESS.md) ---

    def _maybe_resync_audit(self) -> None:
        """Run the client's anti-entropy resync audit when due (every
        ``resync_interval`` of wall time). Pre-gate like the taint
        sweep: the mirror must stay verified even while cooldown or the
        unschedulable gate holds ticks back. Drift is logged, evented,
        and already healed by the client when this returns."""
        audit = getattr(self.client, "resync_audit", None)
        if audit is None or self.config.resync_interval <= 0:
            return
        now = self.clock.wall()
        if self._next_resync_wall is None:
            # first tick: the startup LIST just seeded the mirror
            self._next_resync_wall = now + self.config.resync_interval
            return
        if now < self._next_resync_wall:
            return
        # advance the schedule before running: a failing audit retries
        # at the NEXT interval, not every tick (a down apiserver must
        # not be hammered with the very LISTs the watch path avoids)
        self._next_resync_wall = now + self.config.resync_interval
        try:
            drift = audit()
        except Exception as err:  # noqa: BLE001, exception-discipline — audit is advisory and rescheduled; a LIST failure was counted by the kube retry layer, and mirror staleness has its own gate + gauge
            log.error(
                "Anti-entropy resync audit failed (next attempt in "
                "%.0fs): %s", self.config.resync_interval, err,
            )
            return
        total = sum(drift.values())
        if total:
            detail = ", ".join(
                f"{res}={n}" for res, n in sorted(drift.items()) if n
            )
            log.error(
                "Anti-entropy audit healed %d drifted mirror object(s) "
                "(%s)", total, detail,
            )
            self.recorder.event(
                "Node", "", "Warning", "WatchDriftHealed",
                f"anti-entropy resync found {total} drifted object(s) "
                f"in the watch mirror ({detail}); stores replaced from "
                "a fresh LIST",
            )

    def _freshness_gate(self) -> Optional[TickResult]:
        """Refuse to observe through a watch mirror staler than
        ``mirror_staleness_budget``. Degradation ladder: (1) bypass the
        sick cache with the client's direct-LIST twin for this tick;
        (2) no direct path → skip the tick, which feeds the circuit
        breaker. Returns the skip result, or None to proceed (with
        ``self._observe_client`` pointing at this tick's read path)."""
        self._observe_client = self.client
        budget = self.config.mirror_staleness_budget
        stale_fn = getattr(self.client, "mirror_staleness", None)
        if stale_fn is None or budget <= 0:
            return None
        staleness = float(stale_fn())
        metrics.update_mirror_staleness(staleness)
        health.STATE.note_mirror_staleness(staleness, budget)
        if staleness <= budget:
            return None
        direct = getattr(self.client, "direct_client", None)
        bypass = direct() if direct is not None else None
        if bypass is None:
            log.error(
                "Watch mirror is %.1fs stale (budget %.1fs) and no "
                "direct observe path exists; skipping the tick",
                staleness, budget,
            )
            return TickResult(skipped="error")
        log.error(
            "Watch mirror is %.1fs stale (budget %.1fs); observing via "
            "direct LIST this tick (cache bypassed)", staleness, budget,
        )
        metrics.update_freshness_bypass()
        flight.note_event(
            "freshness-bypass",
            cause="watch mirror %.1fs stale (budget %.1fs); direct-LIST "
                  "observe this tick" % (staleness, budget),
            trace_id=tracing.current_trace_id(),
        )
        self._observe_client = bypass
        return None

    def _planned_from_stale_mirror(self) -> bool:
        """Last-line freshness check at the plan boundary: True if this
        tick's observation came from the mirror and the mirror aged
        past the budget while the tick observed. Structurally never —
        the gate just measured it — but enforced, so no eviction can
        ever be planned from over-budget data."""
        budget = self.config.mirror_staleness_budget
        if budget <= 0 or self._observe_client is not self.client:
            return False
        stale_fn = getattr(self.client, "mirror_staleness", None)
        if stale_fn is None:
            return False
        return float(stale_fn()) > budget

    # --- circuit breaker ---

    @property
    def breaker_engaged(self) -> bool:
        threshold = self.config.breaker_threshold
        return threshold > 0 and self._consecutive_errors >= threshold

    def effective_interval(self) -> float:
        """The housekeeping interval ``run_forever`` actually sleeps:
        the configured one, doubled per consecutive error-skipped tick
        past ``breaker_threshold`` and capped at ``breaker_max_interval``
        — persistent observe errors must not hammer a struggling
        apiserver at full cadence. Resets with the error count on the
        next completed tick."""
        base = self.config.housekeeping_interval
        if not self.breaker_engaged:
            return base
        doublings = min(
            self._consecutive_errors - self.config.breaker_threshold + 1, 16
        )
        cap = max(self.config.breaker_max_interval, base)
        return min(base * (2.0 ** doublings), cap)

    # --- the tick ---

    def tick(self) -> TickResult:
        """One housekeeping pass, scoped under a fresh tick trace
        (``trace_enabled``): every phase, kube read, drain round and —
        in agent mode — the service round trip record into one span
        tree, which lands in the flight ring when the tick completes."""
        trace = (
            tracing.start_trace() if self.config.trace_enabled else None
        )
        try:
            result = self._tick_guarded()
        finally:
            if trace is not None:
                tracing.end_trace(trace)
        if trace is not None:
            trace.set_attr("skipped", result.skipped)
            if result.planner_fallback:
                trace.set_attr("planner_fallback", True)
            if result.report is not None:
                trace.set_attr("solver", result.report.solver)
                trace.set_attr(
                    "solve_ms",
                    round(result.report.solve_seconds * 1e3, 3),
                )
            flight.record_tick(trace.to_dict())
        return result

    def _tick_guarded(self) -> TickResult:
        recovered: List[str] = []
        if self.config.reconcile_orphaned_taints:
            # before the gates: an orphaned taint must not wait out a
            # 10-minute drain cooldown to be healed. Guarded — a
            # recorder/sink that raises must not escape tick()
            try:
                recovered = self.reconcile_orphaned_taints()
            except Exception as err:  # noqa: BLE001, exception-discipline — the sweep re-runs next tick; recovery successes are what's counted
                log.error("Orphaned-taint sweep failed: %s", err)
        try:
            # also pre-gate: the mirror stays audited while cooldown or
            # the unschedulable gate holds ticks back
            self._maybe_resync_audit()
        except Exception as err:  # noqa: BLE001, exception-discipline — the audit retries at its next interval; staleness has its own gate + gauge
            log.error("Anti-entropy resync audit crashed: %s", err)
        try:
            result = self._tick_inner()
        except Exception as err:  # noqa: BLE001, exception-discipline — the loop must not die; skipped="error" below drives the breaker + health accounting that records it
            if self._device_fault(err):
                raise
            log.error("Tick aborted by unexpected error: %s", err)
            result = TickResult(skipped="error")
        result.recovered_taints = recovered
        if result.skipped == "error":
            self._consecutive_errors += 1
            if (
                self.config.breaker_threshold > 0
                and self._consecutive_errors == self.config.breaker_threshold
            ):
                # the ENGAGE edge, once per streak (each further failure
                # widens the interval but is the same engagement)
                flight.note_event(
                    "breaker-engage",
                    cause="%d consecutive error-skipped ticks; interval "
                          "widened to %.0fs"
                          % (self._consecutive_errors,
                             self.effective_interval()),
                    trace_id=tracing.current_trace_id(),
                )
            health.STATE.note_error(
                self._consecutive_errors,
                self.effective_interval() if self.breaker_engaged else None,
            )
        elif result.skipped == "":
            self._consecutive_errors = 0
            # agent mode degrades INSIDE the planner (RemotePlanner
            # plans locally when every endpoint is dead, reporting
            # solver "remote-fallback" without raising) — /healthz must
            # read degraded for those ticks exactly as for a contained
            # in-process planner crash
            remote_fell_back = (
                result.report is not None
                and result.report.solver == "remote-fallback"
            )
            health.STATE.note_success(
                fallback=result.planner_fallback or remote_fell_back
            )
        elif result.skipped == "unschedulable":
            # the observation behind this verdict SUCCEEDED — the
            # apiserver is provably healthy, so the observe-error
            # breaker resets even though the gate (correctly) held the
            # tick; fallback-planner degradation stands until a tick
            # completes
            self._consecutive_errors = 0
            health.STATE.note_observe_ok()
        # cooldown skips observe nothing: they neither trip nor reset
        # the breaker
        return result

    def _tick_inner(self) -> TickResult:
        now = self.clock.now()
        if now < self.next_drain_time:
            log.vlog(2, "Waiting %.0fs for drain delay timer.",
                     self.next_drain_time - now)
            return TickResult(skipped="cooldown")

        skip = self._freshness_gate()
        if skip is not None:
            return skip

        try:
            unschedulable = self._observe_client.list_unschedulable_pods()
        except Exception as err:  # noqa: BLE001, exception-discipline — the skipped="error" return feeds the breaker/health accounting (note_error), which records it
            # skip the tick, matching the observe-error policy: treating
            # an unknown state as "zero unschedulable pods" would defeat
            # the don't-make-things-worse gate exactly when the
            # apiserver is flaky
            log.error("Failed to get unschedulable pods: %s", err)
            return TickResult(skipped="error")
        if unschedulable:
            log.vlog(2, "Waiting for unschedulable pods to be scheduled.")
            return TickResult(skipped="unschedulable")

        log.vlog(3, "Starting node processing.")
        with tracing.phase("observe"):
            observation = self._columnar_store()
            if observation is None:
                observation = self.observe()
            if observation is None:
                return TickResult(skipped="error")

            try:
                pdbs = self._observe_client.list_pdbs()
            except Exception as err:  # noqa: BLE001, exception-discipline — skipped="error" feeds the breaker/health accounting, which records it
                log.error("Failed to list PDBs: %s", err)
                return TickResult(skipped="error")

            if not isinstance(observation, NodeMap):
                # one evictability pass per tick, shared between the
                # metrics update and the planner's pack
                observation = self._wrap_columnar(observation, pdbs)

        if self._planned_from_stale_mirror():
            # the mirror aged past the budget while this tick observed
            # — refuse to plan from it (the skip feeds the breaker)
            metrics.update_mirror_stale_planned()
            flight.note_event(
                "stale-mirror-plan-refused",
                cause="mirror aged past the staleness budget between "
                      "the gate and the plan; tick skipped",
                trace_id=tracing.current_trace_id(),
            )
            log.error(
                "Watch mirror aged past the staleness budget between "
                "the gate and the plan; skipping the tick"
            )
            return TickResult(skipped="error")

        report, used_fallback = self._next_plan(observation, pdbs)
        if report is None:
            return TickResult(skipped="error", planner_fallback=True)
        metrics.observe_plan_duration(
            report.solver, report.solve_seconds, report.n_candidates
        )
        metrics.update_incremental_tick(report)

        result = TickResult(report=report, planner_fallback=used_fallback)
        with tracing.phase("actuate"):
            self._actuate(result, report)
        log.vlog(3, "Finished processing nodes.")
        return result

    def _actuate(self, result: TickResult, report: PlanReport) -> None:
        drains = 0
        while drains < self.config.max_drains_per_tick:
            if drains > 0:
                # Multi-drain mode (beyond the reference's one-per-tick):
                # earlier drains changed the spot pool, and every
                # feasibility proof assumed the undisturbed snapshot
                # (independent fork lanes) — so re-observe and re-plan
                # before each additional drain to avoid spot overcommit.
                # Clients with a per-tick cache (polling pod LIST, watch
                # snapshot) must drop it or the re-observe reads the same
                # pre-drain view the first plan used.
                refresh = getattr(self._observe_client, "refresh", None)
                if refresh is not None:
                    refresh()
                observation = self._columnar_store()
                if observation is None:
                    observation = self.observe()
                if observation is None:
                    break
                try:
                    pdbs = self._observe_client.list_pdbs()
                except Exception as err:  # noqa: BLE001, exception-discipline — the multi-drain loop stops at the drains already proven; this tick still completes and reports them
                    log.error("Failed to list PDBs: %s", err)
                    break
                report, used_fallback = self._next_plan(
                    observation, pdbs, run_metrics=False
                )
                if report is None:
                    break
                if used_fallback:
                    result.planner_fallback = True
            plan = report.plan
            if plan is None:
                break
            log.vlog(2, "All pods on %s can be moved. Will drain node.",
                     plan.node.node.name)
            self._active_drains.add(plan.node.node.name)
            try:
                drain_node(
                    self.client,
                    self.recorder,
                    plan.node.node,
                    plan.pods,
                    clock=self.clock,
                    max_graceful_termination=int(
                        self.config.max_graceful_termination
                    ),
                    pod_eviction_timeout=self.config.pod_eviction_timeout,
                    eviction_retry_time=self.config.eviction_retry_time,
                    identity=self.identity,
                    schedule_step=report.schedule_step,
                )
                metrics.update_node_drain_count("Success", plan.node.node.name)
                result.drained.append(plan.node.node.name)
            except DrainError as err:
                log.error("Failed to drain node: %s", err)
                metrics.update_node_drain_count("Failure", plan.node.node.name)
                result.drain_failed.append(plan.node.node.name)
            finally:
                self._active_drains.discard(plan.node.node.name)
            # cooldown arms after a drain attempt, success or not
            # (rescheduler.go:280-286)
            self.next_drain_time = self.clock.now() + self.config.node_drain_delay
            drains += 1

    def run_forever(self) -> None:
        """reference rescheduler.go:161-164: act every housekeeping_interval
        (widened by the circuit breaker while observe errors persist)."""
        while True:
            self.clock.sleep(self.effective_interval())
            try:
                self.tick()
            except Exception as err:  # noqa: BLE001 — belt over tick's guard
                if self._device_fault(err):
                    raise
                self._consecutive_errors += 1
                log.error("Tick crashed: %s", err)
                # keep /healthz and the breaker state coherent even on
                # this escape path — an operator must see the throttling
                health.STATE.note_error(
                    self._consecutive_errors,
                    self.effective_interval()
                    if self.breaker_engaged
                    else None,
                )

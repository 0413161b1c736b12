"""The fleet twin: hundreds of tenant twins vs a real replica set on
one virtual clock — the harness that measures what no per-tick test
can.

The port of the JAX package's ``bench/fleet_twin.py``. The replicas are
the port's ``ServiceServer`` on ``device`` (the card by default) with
``solver="torch"``: each replica's ``solve_hook`` still advances the
virtual clock by the modelled (or calibrated) batch cost, and then
solves through the service's own ``_solve``, so every served selection
comes from kernels B1t/B2t (B1/B2 for a batch of one tenant) on the
card. The spot checks hold them to a solo ``TorchSolverPlanner``. The
artifact also counts ``calibrated_batches``: the batches charged a
measured cost from ``calibration`` rather than the modelled line, and
splits the run's host wall (``host_split``).

The service gives one device a fleet of tenants, but its proofs run
four agents. This module drives the design point: a heterogeneous
fleet of :class:`service.twin.TenantTwin` agents (mixed cluster-size
tiers, per-twin cadences and churn rates, zone-correlated spot storms,
tenants joining and leaving mid-run) against >= 2 real-HTTP
``ServiceServer`` replicas that share one ``FakeClock``. Wall time
stays in minutes because the device is MODELED: each replica's
``solve_hook`` advances the virtual clock by a per-batch cost
(base + per-lane) before running the batch solve, so tenant
queue waits accrue in SIMULATED seconds and saturation emerges from
the same DRR queue / bucket batching / admission edges production
runs — while every served selection stays bit-identical to a solo
in-process plan (spot-checked continuously, serve-smoke's contract at
fleet scale).

Outputs (one JSON artifact line via the driver's ``--fleet-twin``):

- the **capacity-planning curve**: per load phase, device occupancy vs
  queue-wait p50/p99, and the derived tenants-per-device at the
  declared queue-wait SLO;
- **failover convexity**: a replica is killed (graceful) and restarted
  inside every phase; the p99 degradation during the kill window, per
  load level, measures how much headroom failover actually needs;
- **fairness**: Jain's index over per-twin served/offered shares;
- **compile sharing**: bucket-level first-compile hits/misses as twin
  shapes drift (storms change packed shapes mid-run);
- **admission-shed ledger**: every shed edge double-booked — the
  labeled metric vs the flight ``service-shed``/``resync-shed`` events
  — asserted equal, plus a deterministic per-reason edge-induction
  pass (:func:`induce_shed_edges`) that fires every reason in the
  REGISTRY's label set at least once and diffs both surfaces per
  label;
- **restart-storm survival**: after the ramped phases, one replica is
  killed and warm-restarted under the full fleet (tenant cache wiped);
  the run asserts bounded concurrent full-pack ingests, no tenant
  resyncing twice, server-vs-twin resync ledger parity, unaffected
  tenants holding the SLO, and convergence in O(affected) full packs.

``python -m k8s_spot_rescheduler_tpu_torch.bench --fleet-twin-smoke``
runs the same loop at <= 64 twins, ``--storm-smoke`` the restart storm
at 32; the full run (512 twins, one simulated hour) is
``--fleet-twin``.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from k8s_spot_rescheduler_tpu_torch.io.synthetic import CONFIGS
from k8s_spot_rescheduler_tpu_torch.loop import flight
from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.models.delta import pack_fingerprint
from k8s_spot_rescheduler_tpu_torch.service import wire
from k8s_spot_rescheduler_tpu_torch.service.server import ServiceServer
from k8s_spot_rescheduler_tpu_torch.service.twin import (
    TenantTwin,
    fleet_specs,
    post_plan,
)
from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig
from k8s_spot_rescheduler_tpu_torch.utils import logging as log

# the shed-reason label set comes from the REGISTRY, not a local
# literal: a new admission edge added to the service shows up here
# automatically, and ``induce_shed_edges`` then FAILS until it also has
# a deterministic recipe for firing it — the completeness contract
SHED_REASONS = metrics.SHED_REASONS

# the two flight kinds an admission shed can fire as (the resync-storm
# edge has its own kind so storm ingest refusals are separable from
# ordinary queue sheds in the flight log); every ledger diff in this
# module must sum BOTH to stay equal to the labeled metric
SHED_FLIGHT_KINDS = ("service-shed", "resync-shed")


def _shed_flight_total() -> int:
    counts = flight.counts()
    return sum(int(counts.get(k, 0)) for k in SHED_FLIGHT_KINDS)


def _pctl(values: List[float], q: float) -> float:
    """Nearest-rank percentile (same convention as the registry's
    windowed gauges, so the bench's curve and /healthz agree on what
    'p99' means)."""
    if not values:
        return 0.0
    ranked = sorted(values)
    import math

    idx = min(len(ranked) - 1, max(0, int(math.ceil(q * len(ranked))) - 1))
    return float(ranked[idx])


def _shed_totals() -> Dict[str, int]:
    return {
        k: int(v)
        for k, v in metrics.service_snapshot().get(
            "admission_shed", {}
        ).items()
    }


def _shed_delta(before: Dict[str, int]) -> Dict[str, int]:
    out = {}
    for reason, v in _shed_totals().items():
        d = v - before.get(reason, 0)
        if d:
            out[reason] = d
    return out


class _Fleet:
    """The replica set + bookkeeping one fleet run owns."""

    def __init__(self, cfg: ReschedulerConfig, clock: FakeClock,
                 n_replicas: int, max_inflight: int,
                 cost_base_s: float, cost_per_lane_s: float,
                 calibration: Optional[Dict[str, dict]] = None,
                 device=None):
        self.cfg = cfg
        self.device = device
        self.clock = clock
        self.max_inflight = max_inflight
        self.cost_base_s = cost_base_s
        self.cost_per_lane_s = cost_per_lane_s
        # measured per-bucket solve costs (bucket key -> {"solve_s"}),
        # from a real --carry-wall run's ``twin_calibration`` table:
        # when a batch's bucket has a measured cost, the modeled device
        # charges THAT instead of the synthetic base+per-lane line
        self.calibration: Dict[str, dict] = dict(calibration or {})
        self.calibrated_batches = 0  # batches charged a measured cost
        # the host clock's side of the run (the artifact's
        # ``host_split``): the batches solved and the wall of their
        # solves, and each replica's batch log and request traces, kept
        # as the replica shuts down
        self.batches = 0
        self.solve_wall_s = 0.0
        self.batch_logs: List[dict] = []
        self.request_traces: List[dict] = []
        self.busy_s = [0.0] * n_replicas  # modeled device time, per slot
        # per-replica device frontier: the virtual time through which
        # that replica's modeled device is committed. Parallel replicas
        # must OVERLAP in virtual time (naively advancing the shared
        # clock by every batch cost would serialize the fleet's devices
        # and cap occupancy at 1/n); a batch starts at
        # max(its replica's frontier, its own last-enqueue time) and
        # the global clock only catches UP to frontiers, so each
        # device serializes its own batches while devices run
        # concurrently.
        self.frontier = [0.0] * n_replicas
        self._adv_lock = threading.Lock()
        self.replicas: List[Optional[ServiceServer]] = [None] * n_replicas
        self.addrs: List[str] = []
        for i in range(n_replicas):
            self.replicas[i] = self._spawn(i, "127.0.0.1:0")
            self.addrs.append(self.replicas[i].address)

    def _spawn(self, idx: int, addr: str) -> ServiceServer:
        srv = ServiceServer(
            self.cfg, addr, batch_window_s=0.0,
            max_inflight=self.max_inflight, clock=self.clock,
            device=self.device,
        )
        svc = srv.service
        clock = self.clock
        busy = self.busy_s

        def hook(stacked, batch):
            # the modeled device: virtual device time per batch,
            # committed against THIS replica's frontier so queue waits
            # accrue in simulated seconds while the service's own solve
            # (B1t/B2t on the card) gives the answers. The batch could not have started before its
            # last member enqueued — that lower bound (not clock.now(),
            # which a concurrent replica may already have advanced)
            # keeps parallel devices overlapped in virtual time.
            measured = (
                self.calibration.get(batch[0].bucket.key)
                if batch else None
            )
            if measured is not None:
                cost = float(measured.get("solve_s", 0.0)) or (
                    self.cost_base_s
                )
                with self._adv_lock:
                    self.calibrated_batches += 1
            else:
                # the device solves every tenant's FULL lane block no
                # matter how few lanes a delta request touched: charge
                # the stacked batch's valid candidate lanes (equal to
                # the DRR cost for full packs), not r.lanes, which for
                # delta traffic counts only the CHANGED lanes and would
                # make deltas read as nearly free device time
                # numpy on the host path, tensors on the card after a
                # delta scatter: .sum() counts either
                lanes = (
                    int(stacked.cand_valid.sum())
                    if stacked is not None
                    else sum(r.lanes for r in batch)
                )
                cost = (
                    self.cost_base_s + self.cost_per_lane_s * lanes
                )
            ready = max((r.enqueued for r in batch), default=0.0)
            with self._adv_lock:
                start = max(self.frontier[idx], ready)
                end = start + cost
                self.frontier[idx] = end
                behind = end - clock.now()
                if behind > 0:
                    clock.advance(behind)
            busy[idx] += cost
            t_solve = time.perf_counter()
            out = svc._solve(stacked)
            with self._adv_lock:
                self.batches += 1
                self.solve_wall_s += time.perf_counter() - t_solve
            return out

        svc.solve_hook = hook
        srv.start_background(scheduler=True)
        return srv

    def kill(self, idx: int) -> None:
        srv = self.replicas[idx]
        if srv is not None:
            self._shutdown(srv)
            self.replicas[idx] = None

    def restart(self, idx: int) -> None:
        if self.replicas[idx] is None:
            self.replicas[idx] = self._spawn(idx, self.addrs[idx])

    def close(self) -> None:
        for i, srv in enumerate(self.replicas):
            if srv is not None:
                self._shutdown(srv)
                self.replicas[i] = None

    def _shutdown(self, srv: ServiceServer) -> None:
        srv.graceful_shutdown()
        self.batch_logs.extend(srv.service.batch_log)
        self.request_traces.extend(srv.recent_request_traces())


def fleet_twin(
    n_twins: int = 512,
    n_replicas: int = 2,
    sim_s: float = 3600.0,
    seed: int = 0,
    slo_ms: float = 750.0,
    phases: int = 4,
    zones: int = 4,
    cost_base_s: float = 0.25,
    cost_per_lane_s: float = 0.004,
    storm_frac: float = 0.5,
    storm_len_s: float = 90.0,
    leave_frac: float = 0.05,
    max_inflight: int = 16,
    pool_workers: int = 32,
    verify_every: int = 7,
    jain_min: float = 0.8,
    max_wall_s: float = 280.0,
    deadline_frac: float = 0.0,
    resync_storm_s: float = 240.0,
    calibration: Optional[Dict[str, dict]] = None,
    device=None,
) -> dict:
    """Run the fleet twin on ``device``; returns the capacity/observability artifact
    (``ok`` False plus a ``failures`` list when any fleet invariant
    broke). See the module docstring for what each phase does.

    After the ramped phases, ``resync_storm_s`` > 0 appends a dedicated
    **restart-storm** phase under the full fleet: one replica is killed
    and warm-restarted (its tenant cache wiped), and the run asserts
    the anti-entropy contract — bounded concurrent full-pack ingests
    (``resync_ingest_inflight_max`` <= the configured cap), no tenant
    resyncing twice, server resync count == the twins' sum, unaffected
    tenants holding the queue-wait SLO, and convergence in O(affected)
    full packs. ``calibration`` maps bucket keys to measured per-batch
    solve costs (see ``--twin-calibration``)."""
    t_wall = time.perf_counter()
    clock = FakeClock()
    spec0 = CONFIGS[2]
    cfg = ReschedulerConfig(
        resources=spec0.resources, solver="torch",
        device_sick_threshold=0, service_drain_grace=2.0,
        planner_timeout=5.0,
        # short drain schedules keep the twins' periodic wire-v3
        # requests (every SCHEDULE_EVERY-th tick) cheap enough for the
        # modeled device while still exercising the surface at scale
        schedule_horizon=6,
    )
    fleet = _Fleet(cfg, clock, n_replicas, max_inflight,
                   cost_base_s, cost_per_lane_s,
                   calibration=calibration, device=device)
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )

    solo = TorchSolverPlanner(cfg, device=device)
    specs = fleet_specs(n_twins, seed=seed, zones=zones,
                        deadline_frac=deadline_frac)
    rng = np.random.default_rng(seed ^ 0xF1EE7)
    twins: Dict[int, TenantTwin] = {}   # spec index -> twin (ever built)
    active: List[int] = []
    ever_active: set = set()
    next_fresh = 0                      # first never-activated spec index

    def activate(i: int) -> None:
        if i not in twins:
            order = [
                fleet.addrs[(i + k) % n_replicas]
                for k in range(n_replicas)
            ]
            twins[i] = TenantTwin(
                specs[i], cfg, clock,
                [f"http://{a}" for a in order],
            )
        tw = twins[i]
        tw.next_due = clock.now() + float(
            rng.uniform(0, tw.spec.cadence_s)
        )
        active.append(i)
        ever_active.add(i)

    mismatches: List[dict] = []
    verified = 0
    failures: List[str] = []
    curve: List[dict] = []
    fo_rows: List[dict] = []
    storm_window_hits: List[int] = []
    resync_before = metrics.service_snapshot()["delta_requests"].get(
        "resync", 0
    )
    shed_metric_0 = sum(_shed_totals().values())
    shed_flight_0 = _shed_flight_total()
    fo_metric_0 = metrics.service_snapshot()["remote_planner_failover"]
    fo_flight_0 = flight.counts().get("failover", 0)

    # the fleet loop's host wall: the twins' ticks (a thread pool; the
    # replicas serve them meanwhile), the spot checks' solo solves and
    # the churn between ticks
    loop_s = {"ticks": 0.0, "spot_checks": 0.0, "churn": 0.0}
    pool = ThreadPoolExecutor(max_workers=pool_workers)
    phase_len = sim_s / phases
    aborted = ""
    try:
        for p in range(phases):
            phase_start = clock.now()
            phase_end = phase_start + phase_len
            target = int(np.ceil(n_twins * (p + 1) / phases))
            # tenant leave/join churn at the boundary: a slice of the
            # active set departs, replaced (plus the ramp) by fresh
            # twins — the service's bucket map must churn without any
            # delta-wire resync storm (asserted at the end)
            if p > 0 and leave_frac > 0 and active:
                n_leave = max(1, int(len(active) * leave_frac))
                for i in list(rng.choice(active, size=n_leave,
                                         replace=False)):
                    active.remove(int(i))
            while len(active) < target:
                if next_fresh < n_twins:
                    i, next_fresh = next_fresh, next_fresh + 1
                else:  # pool exhausted: rejoin a departed tenant
                    candidates = [
                        j for j in range(n_twins) if j not in active
                    ]
                    if not candidates:
                        break
                    i = int(rng.choice(candidates))
                if i not in active:
                    activate(i)
            metrics.reset_service_window()
            busy_mark = sum(fleet.busy_s)
            marks = {i: len(twins[i].wait_samples_ms) for i in active}
            served_mark = {i: twins[i].served for i in active}
            offered_mark = {i: twins[i].offered for i in active}
            shed_mark = _shed_totals()
            # disjoint scenario windows inside each phase: the storm
            # burst settles before the replica kill, so the failover
            # degradation is measured against steady state, not against
            # (or inside) the storm's own tail
            storm_at = phase_start + 0.45 * phase_len
            storm_restore_at = storm_at + min(
                storm_len_s, 0.15 * phase_len
            )
            fo_start = phase_start + 0.70 * phase_len
            fo_end = phase_start + 0.80 * phase_len
            kill_idx = p % n_replicas
            storm_zone = p % zones
            stormed: List[int] = []
            # actual fire times of the scenario windows: waits are
            # classified by request ENQUEUE time against these, so a
            # request queued during the outage counts against the
            # outage even when it is only served after the restart
            win: Dict[str, float] = {}
            fired = set()

            def fire_events(now: float) -> None:
                if "storm" not in fired and now >= storm_at:
                    fired.add("storm")
                    win["s0"] = now
                    hits = 0
                    for i in active:
                        tw = twins[i]
                        if tw.spec.zone != storm_zone:
                            continue
                        if tw.spot_interrupt(storm_frac):
                            hits += 1
                            stormed.append(i)
                            # interrupted capacity demands an immediate
                            # replan — the correlated burst the storm
                            # exists to model
                            tw.next_due = now + float(rng.uniform(0, 5))
                    storm_window_hits.append(hits)
                if "restore" not in fired and now >= storm_restore_at:
                    fired.add("restore")
                    win["s1"] = now
                    for i in stormed:
                        twins[i].spot_restore()
                if "kill" not in fired and now >= fo_start:
                    fired.add("kill")
                    win["f0"] = now
                    win["busy0"] = sum(
                        b for j, b in enumerate(fleet.busy_s)
                        if j != kill_idx
                    )
                    fleet.kill(kill_idx)
                if "restart" not in fired and now >= fo_end:
                    fired.add("restart")
                    win["f1"] = now
                    win["busy1"] = sum(
                        b for j, b in enumerate(fleet.busy_s)
                        if j != kill_idx
                    )
                    fleet.restart(kill_idx)

            def next_event_time() -> float:
                times = [phase_end]
                if "storm" not in fired:
                    times.append(storm_at)
                if "restore" not in fired:
                    times.append(storm_restore_at)
                if "kill" not in fired:
                    times.append(fo_start)
                if "restart" not in fired:
                    times.append(fo_end)
                return min(times)

            while clock.now() < phase_end:
                if time.perf_counter() - t_wall > max_wall_s:
                    aborted = (
                        "wall budget %.0fs exhausted in phase %d"
                        % (max_wall_s, p)
                    )
                    break
                now = clock.now()
                fire_events(now)
                due = [i for i in active if twins[i].next_due <= now]
                if not due:
                    nxt = min(
                        min(twins[i].next_due for i in active),
                        next_event_time(),
                    )
                    clock.advance(max(1e-3, nxt - now))
                    continue
                t0 = time.perf_counter()
                list(pool.map(lambda i: twins[i].tick(), due))
                loop_s["ticks"] += time.perf_counter() - t0
                for i in due:
                    tw = twins[i]
                    # bit-identity spot checks: every twin's first
                    # served tick, then a steady sample — BEFORE churn
                    # mutates the store the served plan was packed from
                    if tw.last_reply is not None and (
                        tw.served == 1 or tw.served % verify_every == 0
                    ):
                        t0 = time.perf_counter()
                        bad = tw.verify(solo)
                        loop_s["spot_checks"] += time.perf_counter() - t0
                        verified += 1
                        if bad is not None:
                            mismatches.append(bad)
                    # jittered cadence: a joint dispatch round must not
                    # phase-lock its cohort (identical next_due would
                    # turn every later round into one synchronized
                    # burst whose queue waits read as saturation at any
                    # load). A pending resync retry (retry_due > 0)
                    # overrides the cadence: the twin owes the server
                    # exactly one full pack, on ITS jittered schedule
                    if tw.retry_due > 0:
                        tw.next_due = tw.retry_due
                    else:
                        tw.next_due = clock.now() + tw.spec.cadence_s * (
                            float(tw.rng.uniform(0.7, 1.3))
                        )
                    t0 = time.perf_counter()
                    tw.churn()
                    loop_s["churn"] += time.perf_counter() - t0
            if aborted:
                break
            # make sure phase events all fired even if the tick stream
            # went quiet near the boundary
            fire_events(clock.now())

            dur = max(1e-9, clock.now() - phase_start)
            occupancy = (sum(fleet.busy_s) - busy_mark) / (
                dur * n_replicas
            )
            healthy: List[float] = []
            storm_tail: List[float] = []
            failover: List[float] = []
            inf = float("inf")
            s0, s1 = win.get("s0", inf), win.get("s1", inf)
            f0, f1 = win.get("f0", inf), win.get("f1", inf)
            for i in active:
                tw = twins[i]
                a = marks.get(i, 0)
                # steady state excludes both scenario windows, so the
                # capacity curve and the failover baseline are not
                # polluted by the storm's own burst
                for t, w in zip(
                    tw.wait_sample_t[a:], tw.wait_samples_ms[a:]
                ):
                    if s0 <= t < s1:
                        storm_tail.append(w)
                    elif f0 <= t < f1:
                        failover.append(w)
                    else:
                        healthy.append(w)
            shares = [
                (twins[i].served - served_mark.get(i, 0))
                / max(1, twins[i].offered - offered_mark.get(i, 0))
                for i in active
                if twins[i].offered > offered_mark.get(i, 0)
            ]
            row = {
                "phase": p,
                "active_twins": len(active),
                "tenants_per_device": round(len(active) / n_replicas, 2),
                "occupancy": round(occupancy, 4),
                "queue_wait_p50_ms": round(_pctl(healthy, 0.50), 3),
                "queue_wait_p99_ms": round(_pctl(healthy, 0.99), 3),
                "queue_wait_p99_storm_ms": round(
                    _pctl(storm_tail, 0.99), 3
                ),
                "served": sum(
                    twins[i].served - served_mark.get(i, 0)
                    for i in active
                ),
                "jain": round(metrics.jain_fairness(shares), 4),
                "storm_hits": storm_window_hits[-1]
                if storm_window_hits else 0,
                "sheds": _shed_delta(shed_mark),
            }
            curve.append(row)
            mean_h = sum(healthy) / len(healthy) if healthy else 0.0
            mean_f = sum(failover) / len(failover) if failover else 0.0
            fo_dur = max(1e-9, win.get("f1", clock.now())
                         - win.get("f0", clock.now()))
            survivors = max(1, n_replicas - 1)
            surv_occ = (
                win.get("busy1", 0.0) - win.get("busy0", 0.0)
            ) / (fo_dur * survivors)
            fo_rows.append({
                "active_twins": len(active),
                "p99_healthy_ms": row["queue_wait_p99_ms"],
                "p99_failover_ms": round(_pctl(failover, 0.99), 3),
                "mean_healthy_ms": round(mean_h, 3),
                "mean_failover_ms": round(mean_f, 3),
                "degradation_ms": round(mean_f - mean_h, 3),
                # the robust convexity signal: how hot the surviving
                # replica(s) ran while one was down. Below saturation
                # the fleet absorbs a replica loss by consolidating
                # into bigger shared batches (waits can even DROP);
                # the loss of headroom shows up here first, and wait
                # degradation only goes positive once the survivor
                # pins at ~1.0
                "survivor_occupancy": round(surv_occ, 4),
                "failover_samples": len(failover),
            })
            log.info(
                "fleet-twin phase %d: active=%d occ=%.2f p99=%.0fms "
                "jain=%.3f sheds=%s",
                p, len(active), occupancy, row["queue_wait_p99_ms"],
                row["jain"], row["sheds"],
            )

        # --------------------------------------------------------------
        # dedicated restart storm: kill + warm-restart ONE replica under
        # the full fleet, wiping its tenant cache. Every active tenant
        # whose primary it is owes one full-pack resync, all at once —
        # the admission class must SHED the excess (bounded concurrent
        # ingests), never collapse (unaffected tenants hold the SLO),
        # and the fleet must converge in O(affected) full packs with no
        # tenant resyncing twice.
        storm_report: dict = {}
        if not aborted and resync_storm_s > 0 and active:
            storm_kill = phases % n_replicas  # rotate past the phase kills
            metrics.reset_service_window()  # arm the ingest high-water
            sm_resync_0 = metrics.service_snapshot()[
                "delta_requests"
            ].get("resync", 0)
            sm_shed_0 = _shed_totals().get("resync-storm", 0)
            sm_shed_flight_0 = flight.counts().get("resync-shed", 0)
            tw_resync_0 = {i: twins[i].resyncs for i in active}
            tw_fulls_0 = sum(twins[i].full_posts for i in active)
            tw_sched_0 = sum(twins[i].schedule_ticks for i in active)
            tw_bytes_0 = sum(twins[i].wire_bytes_sent for i in active)
            wait_mark = {i: len(twins[i].wait_samples_ms) for i in active}
            affected = [
                i for i in active if i % n_replicas == storm_kill
            ]
            storm_t0 = clock.now()
            fleet.kill(storm_kill)
            fleet.restart(storm_kill)  # warm restart: cache wiped
            srv_restarted = fleet.replicas[storm_kill]
            affected_set = set(affected)
            # the correlated wave: every AFFECTED twin re-ticks within
            # seconds of the restart (their cadences all land on the
            # fresh cache together — the storm this phase exists for);
            # unaffected twins keep their natural cadence, pulled into
            # the window only so their SLO has samples to judge
            for i in active:
                tw = twins[i]
                tw.retry_due = 0.0
                if i in affected_set:
                    tw.next_due = storm_t0 + float(
                        rng.uniform(0.0, 10.0)
                    )
                else:
                    tw.next_due = min(
                        tw.next_due,
                        storm_t0 + float(rng.uniform(0.3, 1.0)) * min(
                            tw.spec.cadence_s, resync_storm_s * 0.5
                        ),
                    )
            storm_end = storm_t0 + resync_storm_s
            # the isolation bound for unaffected tenants: the storm
            # must not make them materially worse than the load the
            # ramp ALREADY exhibited (the top phases may sit past the
            # SLO knee by design — that saturation is the capacity
            # curve's finding, not the storm's fault). Baseline = the
            # worst steady-state p99 of any ramp phase. The affected
            # cohort can be half the fleet, so DRR fair-share alone
            # puts 2x that load on the unaffected while the herd
            # re-seeds, and past the knee queue waits grow
            # superlinearly — 3x the baseline is the survival band
            # (512-twin measured: 2.3x); COLLAPSE, the thing the
            # admission class exists to prevent, reads as an order of
            # magnitude, not a fair-share doubling.
            pre_storm_p99 = max(
                (r["queue_wait_p99_ms"] for r in curve), default=0.0
            )
            storm_slo = max(slo_ms, 3.0 * pre_storm_p99)
            converge_ticks = 0
            converged_s = 0.0

            def _storm_converged() -> bool:
                # ground truth of anti-entropy: the wiped cache holds
                # every affected (primary-owner) tenant again, and no
                # twin still owes a full pack
                svc = srv_restarted.service
                return all(
                    svc.tenant_cached(twins[i].spec.name)
                    for i in affected
                ) and not any(twins[i]._need_full for i in active)

            while clock.now() < storm_end:
                if time.perf_counter() - t_wall > max_wall_s:
                    aborted = (
                        "wall budget %.0fs exhausted in restart storm"
                        % max_wall_s
                    )
                    break
                if converged_s == 0.0 and _storm_converged():
                    converged_s = clock.now() - storm_t0
                    break
                now = clock.now()
                due = [i for i in active if twins[i].next_due <= now]
                if not due:
                    nxt = min(
                        min(twins[i].next_due for i in active), storm_end
                    )
                    clock.advance(max(1e-3, nxt - now))
                    continue
                converge_ticks += 1
                t0 = time.perf_counter()
                list(pool.map(lambda i: twins[i].tick(), due))
                loop_s["ticks"] += time.perf_counter() - t0
                for i in due:
                    tw = twins[i]
                    if tw.last_reply is not None and (
                        tw.served == 1 or tw.served % verify_every == 0
                    ):
                        t0 = time.perf_counter()
                        bad = tw.verify(solo)
                        loop_s["spot_checks"] += time.perf_counter() - t0
                        verified += 1
                        if bad is not None:
                            mismatches.append(bad)
                    if tw.retry_due > 0:
                        tw.next_due = tw.retry_due
                    else:
                        # an affected twin still owing anti-entropy
                        # (primary cache not yet re-seeded) re-ticks
                        # within a minute so convergence completes in
                        # the window; everyone else keeps their natural
                        # cadence. No churn in this phase — the
                        # full-pack ledger below then counts ONLY
                        # resync traffic (plus scheduled v3 fulls),
                        # not shape growth
                        cad = tw.spec.cadence_s
                        if i in affected_set and not (
                            srv_restarted.service.tenant_cached(
                                tw.spec.name
                            )
                        ):
                            cad = min(cad, 60.0)
                        tw.next_due = clock.now() + cad * float(
                            tw.rng.uniform(0.7, 1.3)
                        )
            if converged_s == 0.0 and _storm_converged():
                converged_s = clock.now() - storm_t0

            sm_resync = metrics.service_snapshot()[
                "delta_requests"
            ].get("resync", 0) - sm_resync_0
            sm_shed = _shed_totals().get("resync-storm", 0) - sm_shed_0
            sm_shed_flight = (
                flight.counts().get("resync-shed", 0) - sm_shed_flight_0
            )
            tw_resync = {
                i: twins[i].resyncs - tw_resync_0[i] for i in active
            }
            storm_fulls = (
                sum(twins[i].full_posts for i in active) - tw_fulls_0
                - (sum(twins[i].schedule_ticks for i in active)
                   - tw_sched_0)
            )
            unaffected_waits = [
                w
                for i in active if i not in affected_set
                for w in twins[i].wait_samples_ms[wait_mark.get(i, 0):]
            ]
            storm_p99 = _pctl(unaffected_waits, 0.99)
            ingest_max = metrics.service_snapshot().get(
                "resync_ingest_inflight_max", 0
            )
            cap = int(cfg.service_resync_ingest_cap)
            if converged_s == 0.0 and not aborted:
                failures.append(
                    "restart storm did not converge within %.0fs: "
                    "%d/%d affected tenants re-cached"
                    % (
                        resync_storm_s,
                        sum(
                            1 for i in affected
                            if srv_restarted.service.tenant_cached(
                                twins[i].spec.name
                            )
                        ),
                        len(affected),
                    )
                )
            if ingest_max > cap:
                failures.append(
                    f"concurrent resync ingests peaked at {ingest_max} "
                    f"> cap {cap}"
                )
            twice = {
                twins[i].spec.name: n
                for i, n in tw_resync.items() if n > 1
            }
            if twice:
                failures.append(
                    f"tenants resynced more than once in one storm: "
                    f"{twice}"
                )
            if sm_resync != sum(tw_resync.values()):
                failures.append(
                    f"storm resync ledgers disagree: server {sm_resync} "
                    f"!= twins {sum(tw_resync.values())}"
                )
            if sm_shed != sm_shed_flight:
                failures.append(
                    f"resync-shed ledgers disagree: metric {sm_shed} "
                    f"!= flight {sm_shed_flight}"
                )
            if storm_fulls > 2 * len(affected) + len(active):
                failures.append(
                    f"storm full-pack traffic not O(tenants): "
                    f"{storm_fulls} fulls for {len(affected)} affected "
                    f"/ {len(active)} active"
                )
            if storm_p99 > storm_slo:
                failures.append(
                    f"unaffected tenants broke the SLO during the "
                    f"storm: p99 {storm_p99:.0f}ms > {storm_slo:.0f}ms "
                    f"(slo {slo_ms}ms, pre-storm p99 "
                    f"{pre_storm_p99:.0f}ms)"
                )
            storm_report = {
                "affected": len(affected),
                "active": len(active),
                "resyncs_server": sm_resync,
                "resyncs_twins": sum(tw_resync.values()),
                "resync_sheds": sm_shed,
                "resync_sheds_flight": sm_shed_flight,
                "ingest_inflight_max": int(ingest_max),
                "ingest_cap": cap,
                "full_packs": storm_fulls,
                "wire_bytes": sum(
                    twins[i].wire_bytes_sent for i in active
                ) - tw_bytes_0,
                "converge_ticks": converge_ticks,
                "converge_s": round(converged_s, 1),
                "p99_unaffected_ms": round(storm_p99, 3),
                "storm_slo_ms": round(storm_slo, 1),
            }
            log.info(
                "fleet-twin restart storm: affected=%d resyncs=%d "
                "sheds=%d ingest_max=%d/%d converged in %d ticks "
                "(%.0fs sim) p99=%.0fms",
                len(affected), sm_resync, sm_shed, ingest_max, cap,
                converge_ticks, converged_s, storm_p99,
            )
            if aborted:
                failures.append(aborted)
                aborted = ""
    finally:
        pool.shutdown(wait=True)
        fleet.close()

    # ------------------------------------------------------------------
    # fleet invariants

    crashes = sum(tw.crashes for tw in twins.values())
    if aborted:
        failures.append(aborted)
    if crashes:
        failures.append(f"{crashes} twin crash(es)")
    if mismatches:
        failures.append(
            f"{len(mismatches)} selection mismatch(es) vs solo plans"
        )
    if len(ever_active) < min(n_twins, len(specs)):
        failures.append(
            f"only {len(ever_active)}/{n_twins} twins ever activated"
        )
    occ = [r["occupancy"] for r in curve]
    p99s = [r["queue_wait_p99_ms"] for r in curve]
    if len(curve) < phases:
        failures.append(f"only {len(curve)}/{phases} curve points")
    if any(b <= a for a, b in zip(occ, occ[1:])):
        failures.append(f"occupancy curve not increasing: {occ}")
    if curve and not p99s[-1] > p99s[0]:
        failures.append(
            f"degenerate queue-wait curve: p99 {p99s}"
        )
    if curve and p99s[0] > slo_ms:
        failures.append(
            f"lightest phase already violates the {slo_ms}ms SLO"
        )
    capacity = 0.0
    for r in curve:
        if r["queue_wait_p99_ms"] <= slo_ms:
            capacity = max(capacity, r["tenants_per_device"])
    all_shares = [
        tw.served / tw.offered
        for tw in twins.values() if tw.offered
    ]
    jain_fleet = metrics.jain_fairness(all_shares)
    if jain_fleet < jain_min:
        failures.append(
            f"fleet Jain {jain_fleet:.3f} < {jain_min}"
        )
    # double-booked degradation ledgers: cumulative flight event counts
    # vs the metric counters must agree exactly (shed + failover edges)
    shed_metric = sum(_shed_totals().values()) - shed_metric_0
    shed_flight = _shed_flight_total() - shed_flight_0
    if shed_metric != shed_flight:
        failures.append(
            f"shed ledgers disagree: metric {shed_metric} != "
            f"flight {shed_flight}"
        )
    fo_metric = (
        metrics.service_snapshot()["remote_planner_failover"] - fo_metric_0
    )
    fo_flight = flight.counts().get("failover", 0) - fo_flight_0
    if fo_metric != fo_flight:
        failures.append(
            f"failover ledgers disagree: metric {fo_metric} != "
            f"flight {fo_flight}"
        )
    if fo_metric <= 0:
        failures.append("no failover edges induced by the kill windows")
    # resync PARITY, not resync zero: phase kills and the restart storm
    # legitimately stale the delta bases, so resyncs happen — what must
    # hold is that every server-side resync demand is one twin's
    # observed demand (no lost or phantom anti-entropy), and that no
    # twin resyncs more than once per restart event
    resyncs = (
        metrics.service_snapshot()["delta_requests"].get("resync", 0)
        - resync_before
    )
    twin_resyncs = sum(tw.resyncs for tw in twins.values())
    if resyncs != twin_resyncs:
        failures.append(
            f"resync ledgers disagree: server {resyncs} != "
            f"twins {twin_resyncs}"
        )
    restarts_total = phases + (1 if resync_storm_s > 0 else 0)
    worst = max((tw.resyncs for tw in twins.values()), default=0)
    if worst > restarts_total:
        failures.append(
            f"a twin resynced {worst} times across {restarts_total} "
            f"replica restarts (anti-entropy not converging to one "
            f"full pack per restart)"
        )
    snap = metrics.service_snapshot()
    artifact = {
        "bench": "fleet_twin",
        "n_twins": n_twins,
        "ever_active": len(ever_active),
        "replicas": n_replicas,
        "sim_s": round(clock.now(), 1),
        "wall_s": round(time.perf_counter() - t_wall, 2),
        "slo_ms": slo_ms,
        "capacity_curve": curve,
        "capacity_tenants_per_device_at_slo": capacity,
        "failover_convexity": fo_rows,
        "jain_fleet": round(jain_fleet, 4),
        "compile": {
            "hits": snap.get("compile_hits", 0),
            "misses": snap.get("compile_misses", 0),
        },
        "calibrated_batches": fleet.calibrated_batches,
        "host_split": host_split(
            fleet, twins.values(), loop_s, time.perf_counter() - t_wall
        ),
        "sheds_by_reason": _shed_totals(),
        "shed_total_metric": shed_metric,
        "shed_total_flight": shed_flight,
        "failovers_metric": fo_metric,
        "failovers_flight": fo_flight,
        "storm_hits_per_phase": storm_window_hits,
        "verified_selections": verified,
        "mismatches": mismatches[:8],
        "crashes": crashes,
        "resyncs_server": resyncs,
        "resyncs_twins": twin_resyncs,
        "wire_bytes_sent": sum(
            tw.wire_bytes_sent for tw in twins.values()
        ),
        "full_posts": sum(tw.full_posts for tw in twins.values()),
        "delta_posts": sum(tw.delta_posts for tw in twins.values()),
        "schedule_ticks": sum(
            tw.schedule_ticks for tw in twins.values()
        ),
        "resync_storm": storm_report,
        # the three headline storm numbers, flattened for dashboards
        # (the driver's row carries them under these exact keys)
        "resync_storm_converge_ticks": storm_report.get(
            "converge_ticks", 0
        ),
        "resync_sheds": storm_report.get("resync_sheds", 0),
        "storm_p99_wait_ms": storm_report.get("p99_unaffected_ms", 0.0),
        "ok": not failures,
        "failures": failures,
    }
    return artifact


def host_split(fleet: _Fleet, twins, loop_s: Dict[str, float],
               wall_s: float) -> dict:
    """Where a fleet run's host wall went, on the host clock. The fleet
    loop's own wall splits into the twins' ticks, the spot checks and
    the churn (``loop_s``), the rest being set-up, replica kills and
    restarts and the phase reports. Per twin tick: its pack and encode,
    and its POSTs' round trips (summed over the pool's threads, so
    they hold each other's waits). Per batch: the wall of the
    replicas' solves in their ``solve_hook`` (launch and sync), and the
    medians over the last ``BATCH_LOG_MAX`` batches each replica logged
    of its assemble (the delta scatter included), scatter and reply
    times; per request, the medians of the last traces' admit, decode
    and encode spans."""
    twins = list(twins)
    ticks = sum(tw.offered for tw in twins)
    batches = max(1, fleet.batches)

    def med(values) -> float:
        return round(float(np.median(values)), 4) if values else 0.0

    spans: Dict[str, List[float]] = {}
    for entry in fleet.request_traces:
        for span in entry["spans"]:
            spans.setdefault(span["name"], []).append(span["dur_ms"])
    logs = fleet.batch_logs
    return {
        "wall_s": round(wall_s, 3),
        "loop_s": {
            **{k: round(v, 3) for k, v in loop_s.items()},
            "other": round(wall_s - sum(loop_s.values()), 3),
        },
        "ticks": ticks,
        "batches": fleet.batches,
        "wall_ms_per_batch": round(wall_s * 1e3 / batches, 4),
        "tick_encode_ms": round(
            sum(tw.encode_s for tw in twins) * 1e3 / max(1, ticks), 4
        ),
        "tick_post_ms": round(
            sum(tw.post_s for tw in twins) * 1e3 / max(1, ticks), 4
        ),
        "solve_ms_per_batch": round(fleet.solve_wall_s * 1e3 / batches, 4),
        "logged_batches": len(logs),
        "batch_ms_median": {
            k: med([rec[f"{k}_ms"] for rec in logs])
            for k in ("assemble", "scatter", "reply")
        },
        "request_ms_median": {
            k: med(spans.get(f"service.{k}", []))
            for k in ("admit", "decode", "encode")
        },
    }


# ---------------------------------------------------------------------------
# deterministic shed-edge induction


def induce_shed_edges(seed: int = 0, device=None) -> dict:
    """Fire every admission-shed reason at least once, deterministically,
    against a dedicated single replica — and prove the two ledgers
    (labeled ``service_admission_shed_total`` vs the flight shed events
    grouped by the same reason attr) move in lockstep per label. The
    reason list is the REGISTRY's (``metrics.SHED_REASONS``), not a
    local literal: adding an admission edge to the service makes this
    pass FAIL until a recipe for inducing it exists here.

    The recipe leans on the replica being fully controllable here:
    a ``solve_hook`` that sleeps REAL time keeps the scheduler busy so
    queued victims age past real deadlines; the inflight cap and the
    queue timeout are mutable knobs; drain eviction uses a zero drain
    grace so ``drain_pending`` cannot serve what it should evict. The
    replica runs ``solver="torch"`` on ``device``."""
    clock = FakeClock()
    spec0 = CONFIGS[2]
    cfg = ReschedulerConfig(
        resources=spec0.resources, solver="torch",
        device_sick_threshold=0, service_drain_grace=0.0,
        planner_timeout=5.0,
    )
    srv = ServiceServer(
        cfg, "127.0.0.1:0", batch_window_s=0.0, max_inflight=4,
        clock=clock, device=device,
    )
    svc = srv.service
    real_sleep = {"s": 0.0}

    def hook(stacked, batch):
        if real_sleep["s"] > 0:
            time.sleep(real_sleep["s"])
        clock.advance(0.05)
        return svc._solve(stacked)

    svc.solve_hook = hook
    srv.start_background(scheduler=True)
    specs = fleet_specs(1, seed=seed)
    twin = TenantTwin(specs[0], cfg, clock, [f"http://{srv.address}"])
    packed, _ = twin.store.pack(twin.pdbs)
    body = wire.encode_plan_request("edge-probe", packed)
    url = f"http://{srv.address}/v2/plan"
    octet = {"Content-Type": "application/octet-stream"}

    before_metric = _shed_totals()
    # delta via event sequence numbers, not attr_counts diffs: the
    # event log is a bounded deque, and a full fleet run ahead of this
    # induction can make a before/after count diff see EVICTIONS of old
    # shed events as negative deltas. Events with seq > the start mark
    # are exactly the induced ones (far fewer than the log bound).
    seq0 = {
        kind: max(
            (e["seq"] for e in flight.events(kind)), default=0
        )
        for kind in SHED_FLIGHT_KINDS
    }
    got: Dict[str, str] = {}

    def post_expecting_503(
        headers: dict, label: str, payload: bytes = b""
    ) -> None:
        try:
            post_plan(url, payload or body, headers, timeout=15.0)
            got[label] = "served (expected 503)"
        except Exception as err:  # noqa: BLE001 — the 503 IS the
            # expected outcome here; anything else is reported in the
            # artifact, never raised out of the bench
            got[label] = str(err)

    def blocker(sleep_s: float) -> threading.Thread:
        real_sleep["s"] = sleep_s
        th = threading.Thread(
            target=post_expecting_503, args=(dict(octet), "blocker"),
        )
        th.start()
        time.sleep(0.15)  # let the scheduler pop the blocker batch
        return th

    # deadline: victim declares a 0.1s client deadline while the
    # device is busy 0.6s — evicted under the DEADLINE bound
    th = blocker(0.6)
    post_expecting_503(
        dict(octet, **{"X-Planner-Deadline": "0.1"}), "deadline"
    )
    th.join()
    real_sleep["s"] = 0.0
    # queue-timeout: same shape, but the SERVICE bound is the tight one
    old_qt = svc.queue_timeout_s
    svc.queue_timeout_s = 0.1
    th = blocker(0.6)
    post_expecting_503(dict(octet), "queue-timeout")
    th.join()
    svc.queue_timeout_s = old_qt
    real_sleep["s"] = 0.0
    # max-inflight: close the admission window entirely for one post
    srv.max_inflight = 0
    post_expecting_503(dict(octet), "max-inflight")
    srv.max_inflight = 4
    # resync-storm: a FINGERPRINTED full pack for a tenant this replica
    # has never cached is a resync-class ingest; with the ingest cap
    # forced to zero the admission class must refuse it typed (503 +
    # load-derived Retry-After, the dedicated ``resync-shed`` flight
    # kind) rather than let it crowd the delta queue
    old_cap = srv.resync_ingest_cap
    srv.resync_ingest_cap = 0
    post_expecting_503(
        dict(octet), "resync-storm",
        payload=wire.encode_plan_request(
            "edge-probe-uncached", packed,
            pack_fingerprint=pack_fingerprint(packed),
        ),
    )
    srv.resync_ingest_cap = old_cap
    # drain-refuse + drain-evict: park two victims in the queue with no
    # scheduler to serve them, start draining (new posts refused), then
    # drain_pending with ZERO grace must evict both
    svc.stop_scheduler()
    v1 = svc.submit_nowait("edge-probe", packed)
    v2 = svc.submit_nowait("edge-probe", packed)
    svc.begin_drain()
    post_expecting_503(dict(octet), "drain-refuse")
    svc.drain_pending()
    got["drain-evict"] = (
        "evicted" if (v1.error is not None and v2.error is not None)
        else "victims not evicted"
    )
    srv.close()

    metric_delta = {
        r: int(_shed_totals().get(r, 0) - before_metric.get(r, 0))
        for r in SHED_REASONS
    }
    flight_delta = {r: 0 for r in SHED_REASONS}
    for kind in SHED_FLIGHT_KINDS:
        for event in flight.events(kind):
            if event["seq"] <= seq0[kind]:
                continue
            reason = str(event.get("attrs", {}).get("reason", ""))
            if reason in flight_delta:
                flight_delta[reason] += 1
    failures = []
    for r in SHED_REASONS:
        if metric_delta[r] < 1:
            failures.append(f"edge {r} not induced ({got.get(r)})")
        if metric_delta[r] != flight_delta[r]:
            failures.append(
                f"edge {r}: metric delta {metric_delta[r]} != "
                f"flight delta {flight_delta[r]}"
            )
    return {
        "metric_delta": metric_delta,
        "flight_delta": flight_delta,
        "outcomes": got,
        "ok": not failures,
        "failures": failures,
    }


# ---------------------------------------------------------------------------
# the driver's modes (python -m k8s_spot_rescheduler_tpu_torch.bench)


def fleet_twin_report(result: dict, label: str) -> None:
    """The one progress line of a fleet twin run."""
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import progress

    curve = result.get("capacity_curve", [])
    occ = "/".join("%.2f" % r["occupancy"] for r in curve)
    p99 = "/".join("%.0f" % r["queue_wait_p99_ms"] for r in curve)
    storm = result.get("resync_storm") or {}
    split = result["host_split"]
    storm_note = ""
    if storm:
        storm_note = (
            f"restart-storm[affected={storm.get('affected')} "
            f"resyncs={storm.get('resyncs_server')}=="
            f"{storm.get('resyncs_twins')} "
            f"sheds={storm.get('resync_sheds')} "
            f"ingest_max={storm.get('ingest_inflight_max')}/"
            f"{storm.get('ingest_cap')} "
            f"converged={storm.get('converge_ticks')}t/"
            f"{storm.get('converge_s')}s "
            f"p99={storm.get('p99_unaffected_ms')}ms]  "
        )
    progress(
        f"{label}: {result['ever_active']} twins x {result['replicas']} "
        f"replicas, {result['sim_s']:.0f}s sim in {result['wall_s']:.1f}s "
        f"wall  occ={occ}  p99={p99}ms  capacity@{result['slo_ms']:.0f}ms="
        f"{result['capacity_tenants_per_device_at_slo']} tenants/device  "
        f"jain={result['jain_fleet']}  verified="
        f"{result['verified_selections']}  failovers="
        f"{result['failovers_metric']}=={result['failovers_flight']}  "
        f"sheds={result['shed_total_metric']}=={result['shed_total_flight']}  "
        f"calibrated batches={result['calibrated_batches']}  "
        f"host={split['wall_ms_per_batch']}ms/batch over "
        f"{split['batches']} batches (loop {split['loop_s']})  {storm_note}"
        f"-> {'OK' if result['ok'] else 'FAIL: %s' % result['failures']}"
    )


def _calibration(args) -> Optional[dict]:
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import (
        load_twin_calibration,
    )

    path = getattr(args, "twin_calibration", "")
    return load_twin_calibration(path) if path else None


def _edges_report(edges: dict, label: str) -> None:
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import progress

    progress(
        f"{label} shed edges: metric={edges['metric_delta']} "
        f"flight={edges['flight_delta']} "
        f"-> {'OK' if edges['ok'] else 'FAIL: %s' % edges['failures']}"
    )


def run_fleet_twin_smoke(args, device, metric: str, unit: str) -> tuple:
    """The reference's ``run_fleet_twin_smoke``: 16-64 heterogeneous
    twins x 2 replicas through ~20 simulated minutes (4 occupancy
    phases, a spot storm and a replica kill/restart a phase, the restart
    storm), plus the shed-edge induction. Fails unless no twin crashed,
    every spot-checked selection is solo-identical, the capacity curve
    is monotone and not degenerate, and the flight deltas equal the
    metric deltas for failovers and for each shed reason."""
    calibration = _calibration(args)
    result = fleet_twin(
        n_twins=max(16, min(64, args.tenants if args.tenants > 4 else 64)),
        n_replicas=2, sim_s=1200.0, seed=args.seed, slo_ms=3000.0,
        cost_base_s=0.3, cost_per_lane_s=0.4, max_wall_s=45.0,
        calibration=calibration, device=device,
    )
    edges = induce_shed_edges(seed=args.seed, device=device)
    ok = bool(result["ok"] and edges["ok"])
    fleet_twin_report(result, "fleet-twin-smoke")
    _edges_report(edges, "fleet-twin-smoke")
    return (0 if ok else 1), {
        "metric": metric,
        "value": result["capacity_tenants_per_device_at_slo"],
        "unit": unit,
        "n_twins": result["n_twins"],
        "ever_active": result["ever_active"],
        "replicas": result["replicas"],
        "sim_s": result["sim_s"],
        "wall_s": result["wall_s"],
        "slo_ms": result["slo_ms"],
        "capacity_curve": result["capacity_curve"],
        "failover_convexity": result["failover_convexity"],
        "jain_fleet": result["jain_fleet"],
        "compile": result["compile"],
        "sheds_by_reason": result["sheds_by_reason"],
        "shed_edge_metric_delta": edges["metric_delta"],
        "shed_edge_flight_delta": edges["flight_delta"],
        "failovers": result["failovers_flight"],
        "verified_selections": result["verified_selections"],
        "mismatches": result["mismatches"],
        "crashes": result["crashes"],
        "resyncs_server": result["resyncs_server"],
        "resyncs_twins": result["resyncs_twins"],
        "resync_storm": result["resync_storm"],
        "resync_storm_converge_ticks": result["resync_storm_converge_ticks"],
        "resync_sheds": result["resync_sheds"],
        "storm_p99_wait_ms": result["storm_p99_wait_ms"],
        "calibrated": calibration is not None,
        "calibrated_batches": result["calibrated_batches"],
        "host_split": result["host_split"],
        "ok": ok,
        "failures": result["failures"] + edges["failures"],
    }


def run_fleet_twin(args, device, metric: str, unit: str) -> tuple:
    """The reference's ``run_fleet_twin``: 512 (or ``--tenants``)
    heterogeneous twins x 2 replicas through one simulated hour, the
    capacity-planning artifact. Same invariants as the smoke."""
    calibration = _calibration(args)
    result = fleet_twin(
        n_twins=max(512, args.tenants if args.tenants > 4 else 512),
        n_replicas=2, sim_s=3600.0, seed=args.seed, slo_ms=1000.0,
        cost_base_s=0.05, cost_per_lane_s=0.05, max_wall_s=280.0,
        calibration=calibration, device=device,
    )
    fleet_twin_report(result, "fleet-twin")
    row = dict(result)
    row.update({"metric": metric,
                "value": result["capacity_tenants_per_device_at_slo"],
                "unit": unit, "calibrated": calibration is not None})
    return (0 if result["ok"] else 1), row


def run_storm_smoke(args, device, metric: str, unit: str) -> tuple:
    """The reference's ``run_storm_smoke``: 32-64 twins x 2 replicas,
    two ramped phases, then the restart storm (one replica killed and
    warm-restarted under full load, its tenant cache wiped), plus the
    shed-edge induction. Fails unless the fleet sheds instead of
    collapsing: concurrent full-pack ingests under the cap, unaffected
    tenants within their queue-wait bound, no tenant resyncing twice,
    convergence in O(affected) full packs, every selection solo-
    identical, and every shed and resync ledger in agreement."""
    calibration = _calibration(args)
    result = fleet_twin(
        n_twins=max(32, min(64, args.tenants if args.tenants > 4 else 32)),
        n_replicas=2, sim_s=600.0, seed=args.seed, phases=2,
        slo_ms=3000.0, cost_base_s=0.3, cost_per_lane_s=0.4,
        max_wall_s=45.0, resync_storm_s=300.0,
        calibration=calibration, device=device,
    )
    edges = induce_shed_edges(seed=args.seed, device=device)
    ok = bool(result["ok"] and edges["ok"] and result.get("resync_storm"))
    fleet_twin_report(result, "storm-smoke")
    _edges_report(edges, "storm-smoke")
    return (0 if ok else 1), {
        "metric": metric,
        "value": result["resync_storm_converge_ticks"],
        "unit": unit,
        "n_twins": result["n_twins"],
        "replicas": result["replicas"],
        "sim_s": result["sim_s"],
        "wall_s": result["wall_s"],
        "slo_ms": result["slo_ms"],
        "resync_storm": result.get("resync_storm") or {},
        "resync_storm_converge_ticks": result["resync_storm_converge_ticks"],
        "resync_sheds": result["resync_sheds"],
        "storm_p99_wait_ms": result["storm_p99_wait_ms"],
        "resyncs_server": result["resyncs_server"],
        "resyncs_twins": result["resyncs_twins"],
        "wire_bytes_sent": result["wire_bytes_sent"],
        "full_posts": result["full_posts"],
        "delta_posts": result["delta_posts"],
        "sheds_by_reason": result["sheds_by_reason"],
        "shed_edge_metric_delta": edges["metric_delta"],
        "shed_edge_flight_delta": edges["flight_delta"],
        "verified_selections": result["verified_selections"],
        "mismatches": result["mismatches"],
        "crashes": result["crashes"],
        "calibrated": calibration is not None,
        "calibrated_batches": result["calibrated_batches"],
        "host_split": result["host_split"],
        "ok": ok,
        "failures": result["failures"] + edges["failures"] + (
            [] if result.get("resync_storm")
            else ["restart-storm phase did not run"]
        ),
    }

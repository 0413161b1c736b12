"""``--chaos`` and ``--watch-soak``: the root ``bench.py``'s two soaks,
on the port's controller and planner.

Both run the control loop for ``n_ticks`` ticks on a virtual clock over
a fixture-scale cluster and check its invariants. The reference plans
them on its numpy oracle (``solver="numpy"``); here the planner is
``TorchSolverPlanner`` on ``device`` (the card by default), whose plans
equal the oracle's bit for bit, so every count equals the reference's.

- ``chaos_soak`` (the reference's ``run_chaos``): the fake cluster
  behind the seeded fault client (``io/chaos``, the ``heavy`` profile
  with scripted 429s and one mid-drain interrupt) and two scripted
  planner crashes (``_ScriptedCrashPlanner``). The crashes are the
  planner's, not the card's: the controller contains them on its numpy
  fallback (``planner_fallback_ticks`` 2), and a real kernel fault would
  still end the run. Invariants: the loop never crashes, no ToBeDeleted
  taint is orphaned at the end, no node is drained without pods observed
  on it that tick, a drain lands after the faults clear, and the flight
  recorder holds every contained crash and breaker engagement with its
  cause and trace id (counts equal to the metric deltas), every dump
  naming a degradation kind.
- ``watch_soak`` (the reference's ``watch_soak``): the scripted watch
  apiserver (``io/fakewatch``) behind the fault client, its watchers
  stepped synchronously: open-but-silent stalls, stream drops, two
  scripted 410 streams and one injected mirror corruption. Invariants:
  stalls detected, the freshness bypass engaged, no tick planned from an
  over-budget mirror, the corruption healed within one resync interval
  (plus one tick's worst wall jump), every full LIST a relist or an
  audit's, flight counts equal to the metric deltas, no dump, and the
  mirror's end pack equal to a fresh LIST's.

Each returns (stats, violations); an empty violation list passes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import tempfile
import time

import numpy as np


class _ScriptedCrashPlanner:
    """Planner wrapper raising on scripted call indices: the injected
    planner crash of the chaos soak, which the controller's containment
    catches and the flight recorder must reconstruct. ``plan_async`` and
    ``plan_schedule`` are defined explicitly (a ``__getattr__`` forward
    would hand the loop the inner planner's, bypassing the script)."""

    def __init__(self, inner, crash_calls):
        self._inner = inner
        self._crash_calls = set(crash_calls)
        self._calls = 0

    def _maybe_crash(self):
        self._calls += 1
        if self._calls in self._crash_calls:
            raise RuntimeError(
                "chaos: scripted planner crash #%d" % self._calls
            )

    def plan(self, observation, pdbs):
        self._maybe_crash()
        return self._inner.plan(observation, pdbs)

    def plan_async(self, observation, pdbs):
        self._maybe_crash()
        return self._inner.plan_async(observation, pdbs)

    def plan_schedule(self, observation, pdbs):
        self._maybe_crash()
        return self._inner.plan_schedule(observation, pdbs)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def chaos_soak(n_ticks: int = 300, seed: int = 0, device=None) -> tuple:
    """The chaos soak; returns (stats, violations). ``stats`` holds the
    reference row's count fields."""
    from k8s_spot_rescheduler_tpu_torch.io.chaos import (
        ChaosClusterClient,
        ChaosInterrupt,
        FaultPlan,
    )
    from k8s_spot_rescheduler_tpu_torch.io.fake import FakeCluster
    from k8s_spot_rescheduler_tpu_torch.loop import flight
    from k8s_spot_rescheduler_tpu_torch.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
    from k8s_spot_rescheduler_tpu_torch.models.cluster import (
        CPU,
        MEMORY,
        PODS,
        TO_BE_DELETED_TAINT,
        NodeSpec,
        OwnerRef,
        PodSpec,
    )
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    od_labels = {"kubernetes.io/role": "worker"}
    spot_labels = {"kubernetes.io/role": "spot-worker"}
    clock = FakeClock()
    fc = FakeCluster(clock, reschedule_evicted=True)

    def add_node(name, labels, cpu=4000):
        fc.add_node(NodeSpec(
            name=name, labels=dict(labels),
            allocatable={CPU: cpu, MEMORY: 8 * 1024**3, PODS: 110},
        ))

    def add_pod(name, node, cpu=100):
        fc.add_pod(PodSpec(
            name=name, namespace="default", node_name=node,
            requests={CPU: cpu, MEMORY: 64 * 1024**2},
            labels={"app": name},
            owner_refs=[OwnerRef("ReplicaSet", f"{name}-rs")],
        ))

    for i in range(6):
        add_node(f"od-{i}", od_labels)
        add_node(f"spot-{i}", spot_labels)
    for i in range(6):
        for j in range(3):
            add_pod(f"p{i}-{j}", f"od-{i}")

    plan = dataclasses.replace(
        FaultPlan.profile("heavy", seed),
        evict_429={"default/p0-0": 2, "default/churn-1": 1},
        interrupt_on_taint=3,
    )
    chaos = ChaosClusterClient(fc, plan, clock=clock)
    violations = []
    with tempfile.TemporaryDirectory(prefix="chaos-flight-") as dump_dir:
        config = ReschedulerConfig(
            housekeeping_interval=10.0,
            node_drain_delay=30.0,
            pod_eviction_timeout=60.0,
            eviction_retry_time=5.0,
            flight_dump_dir=dump_dir,
            # the per-tick path, as the reference pins it: its flight ==
            # metric checks are about PLAN-path crash containment
            schedule_horizon=0,
        )
        planner = _ScriptedCrashPlanner(
            TorchSolverPlanner(config, device=device), {5, 40}
        )

        def make_controller():
            return Rescheduler(chaos, planner, config, clock=clock,
                               recorder=chaos)

        quiesce_at = (n_ticks * 7) // 8
        flight.RECORDER.reset()
        metrics_before = metrics.robustness_snapshot()
        r = make_controller()
        interrupts = completed = churn = 0
        drains = []
        fallbacks = breaker_edges = 0
        breaker_was_engaged = False
        for i in range(n_ticks):
            clock.sleep(config.housekeeping_interval)
            if i == quiesce_at:
                # before the tick: the tick may raise the scripted
                # ChaosInterrupt, whose handler skips the rest of the turn
                chaos.enabled = False
            if i % 15 == 0:
                add_pod(f"churn-{churn}", f"od-{churn % 6}")
                churn += 1
            occupied = {
                name for name in fc.nodes
                if name.startswith("od-") and fc.list_pods_on_node(name)
            }
            try:
                result = r.tick()
            except ChaosInterrupt:
                interrupts += 1
                breaker_was_engaged = False  # fresh controller, fresh streak
                r = make_controller()
                continue
            except Exception as err:  # noqa: BLE001 — the invariant itself: a crashed tick is recorded, not raised
                violations.append(f"tick {i} crashed the loop: {err!r}")
                break
            engaged = r.breaker_engaged
            if engaged and not breaker_was_engaged:
                breaker_edges += 1
            breaker_was_engaged = engaged
            completed += 1
            # every drained node was observed WITH pods at the tick's start
            if not set(result.drained) <= occupied:
                violations.append(
                    f"tick {i} drained unobserved/empty node(s): "
                    f"{sorted(set(result.drained) - occupied)}"
                )
            if result.planner_fallback:
                fallbacks += 1
            drains.extend((i, n) for n in result.drained)
        orphans = [
            node.name for node in fc.nodes.values()
            if any(t.key == TO_BE_DELETED_TAINT for t in node.taints)
        ]
        if orphans:
            violations.append(f"orphaned ToBeDeleted taints at end: {orphans}")
        if interrupts != 1:
            violations.append(
                f"expected 1 mid-drain interrupt, saw {interrupts}")
        if not any(i >= quiesce_at for i, _ in drains):
            violations.append("no drain landed after faults cleared")

        metric_fallbacks = int(
            metrics.robustness_snapshot()["planner_fallback"]
            - metrics_before["planner_fallback"]
        )
        fl_counts = flight.RECORDER.counts()
        if metric_fallbacks < 2:
            violations.append(
                "scripted planner crashes never reached containment "
                f"(planner_fallback delta {metric_fallbacks} < 2)"
            )
        if fl_counts.get("planner-fallback", 0) != metric_fallbacks:
            violations.append(
                f"flight ring holds {fl_counts.get('planner-fallback', 0)} "
                f"planner-fallback events but the metric counted "
                f"{metric_fallbacks}"
            )
        if fl_counts.get("breaker-engage", 0) != breaker_edges:
            violations.append(
                f"flight ring holds {fl_counts.get('breaker-engage', 0)} "
                f"breaker-engage events but the loop engaged "
                f"{breaker_edges} time(s)"
            )
        for ev in flight.RECORDER.events():
            if ev["kind"] in ("planner-fallback", "breaker-engage") and (
                not ev["cause"] or not ev["trace_id"]
            ):
                violations.append(
                    f"flight event {ev['kind']} missing its cause/trace "
                    f"id: {ev!r}"
                )
                break
        fb_events = flight.RECORDER.events("planner-fallback")
        if fb_events and not any(
            "scripted planner crash" in ev["cause"] for ev in fb_events
        ):
            violations.append(
                "no planner-fallback event carries the injected crash cause"
            )
        dump_files = sorted(
            f for f in os.listdir(dump_dir) if f.endswith(".json")
        )
        degr_total = sum(fl_counts.get(k, 0) for k in flight.DEGRADATION_KINDS)
        if degr_total and not dump_files:
            violations.append(
                f"{degr_total} degradation event(s) fired but no flight "
                "dump was written"
            )
        if not degr_total and dump_files:
            violations.append(
                f"{len(dump_files)} dump(s) written on a clean soak")
        for fname in dump_files:
            with open(os.path.join(dump_dir, fname)) as fh:
                reason = json.load(fh).get("reason")
            if reason not in flight.DEGRADATION_KINDS:
                violations.append(
                    f"dump {fname} reason {reason!r} is not a degradation "
                    "kind"
                )
                break
    stats = {
        "ticks": int(n_ticks),
        "completed": int(completed),
        "drains": len(drains),
        "drains_after_quiesce": sum(1 for i, _ in drains if i >= quiesce_at),
        "mid_drain_interrupts": int(interrupts),
        "injected_faults": int(sum(chaos.stats.values())),
        "planner_fallback_ticks": int(fallbacks),
        "flight_planner_fallbacks": int(fl_counts.get("planner-fallback", 0)),
        "flight_breaker_engagements": int(fl_counts.get("breaker-engage", 0)),
        "flight_dumps": len(dump_files),
        "orphaned_taints_end": len(orphans),
    }
    return stats, violations


def watch_soak(n_ticks: int = 300, seed: int = 0, device=None, *,
               stall_rate: float = 0.06, drop_rate: float = 0.04,
               progress_deadline: float = 120.0,
               staleness_budget: float = 60.0,
               resync_interval: float = 300.0) -> tuple:
    """The freshness soak; returns (stats, violations), ``stats`` the
    reference's keys."""
    from k8s_spot_rescheduler_tpu_torch.io.chaos import (
        ChaosClusterClient,
        FaultPlan,
    )
    from k8s_spot_rescheduler_tpu_torch.io.fakewatch import (
        ScriptedWatchSource,
        raw_node,
        raw_pod,
    )
    from k8s_spot_rescheduler_tpu_torch.io.watch import (
        WatchingKubeClusterClient,
    )
    from k8s_spot_rescheduler_tpu_torch.loop import flight
    from k8s_spot_rescheduler_tpu_torch.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
    from k8s_spot_rescheduler_tpu_torch.models.cluster import build_node_map
    from k8s_spot_rescheduler_tpu_torch.models.tensors import pack_cluster
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    clock = FakeClock(start=1_000_000.0)
    src = ScriptedWatchSource()
    for i in range(4):
        src.objects["nodes"][f"uid-od-{i}"] = raw_node(f"od-{i}", "worker")
    for i in range(8):
        src.objects["nodes"][f"uid-spot-{i}"] = raw_node(
            f"spot-{i}", "spot-worker")
    for i in range(4):
        for j in range(3):
            name = f"p{i}-{j}"
            src.objects["pods"][f"uid-{name}"] = raw_pod(
                name, f"od-{i}", cpu_millis=100 + 50 * j)

    plan = FaultPlan(seed=seed, watch_stall_rate=stall_rate,
                     watch_drop_rate=drop_rate, watch_410_streams=(9, 57))
    chaos = ChaosClusterClient(src, plan, clock=clock)
    # snapshot before the seeding relists, so the deltas cover every
    # LIST of the run; the flight ring resets to diff against them
    flight.RECORDER.reset()
    before = metrics.freshness_snapshot()
    wc = WatchingKubeClusterClient(
        chaos, clock=clock, progress_deadline=progress_deadline,
        wait_fn=clock.sleep,
    )
    wc.start(background=False)
    config = ReschedulerConfig(
        housekeeping_interval=10.0,
        node_drain_delay=120.0,
        pod_eviction_timeout=60.0,
        eviction_retry_time=5.0,
        mirror_staleness_budget=staleness_budget,
        watch_progress_deadline=progress_deadline,
        resync_interval=resync_interval,
    )
    r = Rescheduler(wc, TorchSolverPlanner(config, device=device), config,
                    clock=clock, recorder=wc)
    rng = random.Random(seed + 1)
    churn_uid = 0

    def churn_once():
        nonlocal churn_uid
        k = rng.random()
        pods = list(src.objects["pods"].values())
        if k < 0.45 or not pods:
            name = f"churn-{churn_uid}"
            churn_uid += 1
            src.push("pods", "ADDED", raw_pod(
                name, f"od-{rng.randrange(4)}",
                cpu_millis=rng.choice((50, 100, 150, 200)),
            ))
        elif k < 0.8:
            src.push("pods", "DELETED", rng.choice(pods))
        else:
            obj = rng.choice(pods)
            node = obj["spec"].get("nodeName", "")
            if node:
                src.push("pods", "MODIFIED", raw_pod(
                    obj["metadata"]["name"], node,
                    cpu_millis=rng.choice((75, 125, 250)),
                ))

    corrupt_cpu = 3333  # impossible allocatable: an unambiguous marker
    # a spot node: never drained or deleted, so only a store replace (an
    # audit heal or a protocol relist) can fix it
    corrupt_key = "uid-spot-7"

    def corrupt_mirror() -> bool:
        # poke the mirror behind the watch stream's back: only the
        # anti-entropy audit can see the disagreement
        node = dict(wc.nodes.snapshot_items()).get(corrupt_key)
        if node is None:
            return False
        wc.nodes.upsert(corrupt_key, dataclasses.replace(
            node, allocatable={**node.allocatable, "cpu": corrupt_cpu}))
        return True

    def mirror_corrupted() -> bool:
        node = dict(wc.nodes.snapshot_items()).get(corrupt_key)
        return node is not None and node.allocatable.get("cpu") == corrupt_cpu

    corrupt_at = n_ticks // 2
    quiesce_at = (n_ticks * 7) // 8
    corrupt_wall = heal_wall = None
    completed = 0
    drains = []
    violations = []
    for i in range(n_ticks):
        clock.sleep(config.housekeeping_interval)
        if i == quiesce_at:
            chaos.enabled = False
        for _ in range(rng.randrange(0, 3)):
            churn_once()
        if i % 7 == 0:
            src.bookmark("pods")
            src.bookmark("nodes")
        if i == corrupt_at and corrupt_mirror():
            corrupt_wall = clock.wall()
        for w in wc._watchers:
            w.step()
        try:
            result = r.tick()
        except Exception as err:  # noqa: BLE001 — the invariant itself: a crashed tick is recorded, not raised
            violations.append(f"tick {i} crashed the loop: {err!r}")
            break
        completed += 1
        drains.extend((i, n) for n in result.drained)
        if (corrupt_wall is not None and heal_wall is None
                and not mirror_corrupted()):
            heal_wall = clock.wall()

    # let the streams drain, then check the end state
    for w in wc._watchers:
        w.step()
    snap = metrics.freshness_snapshot()
    d = {k: snap[k] - before[k] for k in snap if k in before}
    if completed != n_ticks:
        violations.append(f"only {completed}/{n_ticks} ticks completed")
    if d["watch_stalls"] < 1:
        violations.append("no open-but-silent stall was ever detected")
    if chaos.stats.get("watch_410", 0) != 2:
        violations.append(f"expected 2 scripted 410 streams, saw "
                          f"{chaos.stats.get('watch_410', 0)}")
    if d["freshness_bypass"] < 1:
        violations.append(
            "the freshness gate never engaged the direct-LIST bypass")
    if d["mirror_stale_planned"] != 0:
        violations.append(f"{d['mirror_stale_planned']} tick(s) reached the "
                          "planner with an over-budget mirror")
    # one resync interval plus one tick's worst wall jump (a stalled
    # stream's tick advances the clock by a whole read timeout)
    heal_bound = (resync_interval + progress_deadline + 30.0
                  + config.housekeeping_interval)
    if corrupt_wall is None:
        violations.append("mirror corruption was never injected")
    elif heal_wall is None:
        violations.append("injected mirror corruption was never healed")
    elif heal_wall - corrupt_wall > heal_bound:
        violations.append(
            f"corruption healed after {heal_wall - corrupt_wall:.0f}s (> one "
            f"resync interval of {resync_interval:.0f}s plus one tick's "
            "worst-case wall jump)")
    if d["watch_drift"] < 1:
        violations.append("the anti-entropy audit never counted any drift")
    # every full LIST is a protocol relist or one of an audit's 3
    total_lists = sum(src.list_count.values())
    expected_lists = int(d["watch_relists"] + 3 * d["resync_audits"])
    if total_lists != expected_lists:
        violations.append(
            f"{total_lists} full LISTs issued but only {expected_lists} "
            "accounted to relists/audits")
    if d["resync_audits"] < 1:
        violations.append("no anti-entropy audit ever ran")

    fl_counts = flight.RECORDER.counts()
    for kind, key in (("watch-stall", "watch_stalls"),
                      ("freshness-bypass", "freshness_bypass")):
        if fl_counts.get(kind, 0) != int(d[key]):
            violations.append(
                f"flight ring holds {fl_counts.get(kind, 0)} {kind} events "
                f"but metrics counted {int(d[key])}")
    for ev in flight.RECORDER.events():
        if ev["kind"] in ("watch-stall", "freshness-bypass"):
            if not ev["cause"]:
                violations.append(f"flight event missing cause: {ev!r}")
                break
            if ev["kind"] == "freshness-bypass" and not ev["trace_id"]:
                violations.append(
                    f"freshness-bypass event missing trace id: {ev!r}")
                break
    if flight.RECORDER.dump_count() != 0:
        violations.append(f"{flight.RECORDER.dump_count()} dump(s) written "
                          "without a configured dump dir")

    # the incremental mirror packs bit-identically to a fresh LIST of
    # the same end state
    wc.refresh()
    wc.list_unschedulable_pods()
    store = wc.columnar_store(
        ("cpu", "memory"),
        on_demand_label=config.on_demand_node_label,
        spot_label=config.spot_node_label,
    )
    col, _ = store.pack(wc.list_pdbs())
    nodes = src.list_ready_nodes()
    node_map = build_node_map(
        nodes,
        {n.name: src.list_pods_on_node(n.name) for n in nodes},
        on_demand_label=config.on_demand_node_label,
        spot_label=config.spot_node_label,
    )
    obj, _ = pack_cluster(node_map, src.list_pdbs(),
                          resources=("cpu", "memory"))
    mismatch = [f for f in obj._fields
                if not np.array_equal(getattr(obj, f), getattr(col, f))]
    if mismatch:
        violations.append(f"mirror pack diverges from a fresh LIST on "
                          f"{mismatch}")

    stats = {
        "ticks": completed,
        "drains": len(drains),
        "stalls_detected": int(d["watch_stalls"]),
        "stream_errors": int(d["watch_stream_errors"]),
        "scripted_410s": int(chaos.stats.get("watch_410", 0)),
        "relists": int(d["watch_relists"]),
        "resync_audits": int(d["resync_audits"]),
        "drift_objects_healed": int(d["watch_drift"]),
        "presence_heals": int(d["watch_presence_heals"]),
        "drift_heal_seconds": (
            None if heal_wall is None or corrupt_wall is None
            else round(heal_wall - corrupt_wall, 1)
        ),
        "freshness_bypass_ticks": int(d["freshness_bypass"]),
        "flight_stalls": int(fl_counts.get("watch-stall", 0)),
        "flight_bypasses": int(fl_counts.get("freshness-bypass", 0)),
        "mirror_stale_planned": int(d["mirror_stale_planned"]),
        "full_lists": int(total_lists),
        "direct_bypass_reads": int(src.direct_reads),
        "watch_events_applied": int(d["watch_events"]),
        "mirror_parity": not mismatch,
    }
    return stats, violations


def _soak_row(metric, unit, value, stats, violations) -> tuple:
    ok = not violations
    row = {"metric": metric, "value": int(value), "unit": unit,
           "vs_baseline": None, **stats, "ok": ok}
    if violations:
        row["violations"] = violations
    return (0 if ok else 1), row


def run_chaos(args, device, metric: str, unit: str) -> tuple:
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import progress

    t0 = time.perf_counter()
    stats, violations = chaos_soak(int(args.chaos_ticks), args.seed, device)
    wall = time.perf_counter() - t0
    progress(
        f"chaos-soak: {stats['completed']} ticks "
        f"({stats['mid_drain_interrupts']} restart) {stats['drains']} drains "
        f"({stats['drains_after_quiesce']} after quiesce)  "
        f"faults={stats['injected_faults']} wall={wall:.1f}s  -> "
        f"{'OK' if not violations else 'FAIL: ' + '; '.join(violations)}"
    )
    stats = dict(stats)
    completed = stats.pop("completed")
    return _soak_row(metric, unit, completed, stats, violations)


def run_watch_soak(args, device, metric: str, unit: str) -> tuple:
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import progress

    t0 = time.perf_counter()
    stats, violations = watch_soak(int(args.watch_soak_ticks), args.seed,
                                   device)
    wall = time.perf_counter() - t0
    progress(
        f"watch-soak: {stats['ticks']} ticks  {stats['stalls_detected']} "
        f"stalls  {stats['drift_objects_healed']} drift healed "
        f"({stats['drift_heal_seconds']}s)  {stats['freshness_bypass_ticks']} "
        f"bypassed  {stats['full_lists']} LISTs ({stats['resync_audits']} "
        f"audits)  wall={wall:.1f}s  -> "
        f"{'OK' if not violations else 'FAIL: ' + '; '.join(violations)}"
    )
    return _soak_row(metric, unit, stats["ticks"], stats, violations)

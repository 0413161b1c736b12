"""Lightweight tenant twins: the fleet simulation's agent layer.

The port of the JAX package's ``service/twin.py``: the same twin, wire
bytes, breaker arithmetic and seeded draws, over the port's wire codec
and columnar store, spot-checked against ``TorchSolverPlanner``.

A :class:`TenantTwin` is what a full :class:`service.agent.RemotePlanner`
costs too much to be five hundred times over: one synthetic tenant
cluster (columnar store + PDBs), one wire-protocol POST per tick, and
the agent's endpoint-failover breaker re-implemented on the FLEET's
virtual clock — so a thousand twins can drive a real-HTTP replica set
through hours of simulated time in minutes of wall time
(``bench/fleet_twin.py`` owns the event loop; this module owns one
twin's behavior).

What a twin keeps from the real agent, deliberately:

- the wire bytes are the production ones (``wire.encode_plan_request``
  -> ``/v2/plan`` -> ``wire.decode_plan_reply``) against a real
  ``ServiceServer`` socket — transport, decode contract, 503
  Retry-After, all exercised;
- the per-endpoint breaker state is the agent's own
  (:class:`service.agent.Endpoint`) with the agent's thresholds, only
  timed on the shared virtual clock so a skip window costs simulated
  seconds, not wall seconds;
- a tick served by a non-primary replica fires the SAME failover
  accounting the agent fires (``remote_planner_failover`` + the flight
  ``failover`` event) from one site, so flight-delta == metric-delta
  holds for every failover edge the fleet induces;
- every selection is reconstructible (``meta.build_plan``) and
  spot-checkable bit-identical against a solo in-process
  ``TorchSolverPlanner`` — the serve-smoke correctness contract at fleet
  scale.

- since the resync-storm hardening, the twin speaks the agent's FULL
  protocol ladder: v4 ``KIND_PACKED_DELTA`` with pack fingerprints
  (delta to an endpoint whose ``acked_fp`` matches the base, full pack
  otherwise), KIND_RESYNC handling with a jittered decorrelated
  full-pack retry on the virtual clock (per-twin seeded RNG — distinct
  seeds decorrelate the herd deterministically), and occasional v3
  ``schedule_horizon`` requests — so the 512-twin fleet exercises the
  same anti-entropy contract production agents run, restart storms
  included.

What it drops: local-fallback planning and tracing. A twin that cannot
reach any replica records a shed tick and moves on — the fleet bench
asserts on the ACCOUNTING of that degradation, not on hiding it.
"""

from __future__ import annotations

import dataclasses
import time
import urllib.error
import urllib.request
from typing import List, Optional, Sequence, Tuple

import numpy as np

from k8s_spot_rescheduler_tpu_torch.io.synthetic import CONFIGS, generate_cluster
from k8s_spot_rescheduler_tpu_torch.loop import flight
from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.models.delta import (
    emit_packed_delta,
    pack_fingerprint,
)
from k8s_spot_rescheduler_tpu_torch.service import wire
from k8s_spot_rescheduler_tpu_torch.service.agent import (
    Endpoint,
    RemoteCallError,
    RemotePlanner,
)
from k8s_spot_rescheduler_tpu_torch.utils.clock import Clock
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig
from k8s_spot_rescheduler_tpu_torch.utils.labels import matches_label
from k8s_spot_rescheduler_tpu_torch.utils import logging as log

# real-time HTTP budget per POST: generous — queue waits are VIRTUAL
# under the fleet clock (the handler blocks in real time only for the
# host solves ahead of it), so this only bounds a hung socket
HTTP_TIMEOUT_S = 30.0

# every Nth offered tick asks for a whole drain schedule (wire v3)
# instead of a single plan, when the config has schedules on — the
# fleet exercises the KIND_PLAN_SCHEDULE surface at scale without
# paying the horizon-times solve cost on every tick
SCHEDULE_EVERY = 16

# heterogeneity menu: (n_on_demand, n_spot, n_pods) size tiers chosen
# to land in DIFFERENT power-of-two service buckets, so a mixed fleet
# exercises bucket batching + compile sharing instead of collapsing
# into one stacked shape
SIZE_TIERS: Tuple[Tuple[int, int, int], ...] = (
    (3, 3, 18),
    (4, 4, 30),
    (6, 6, 48),
    (8, 8, 80),
)
CADENCE_TIERS_S: Tuple[float, ...] = (30.0, 60.0, 90.0, 180.0)
CHURN_TIERS: Tuple[float, ...] = (0.0, 0.15, 0.35, 0.6)


@dataclasses.dataclass(frozen=True)
class TwinSpec:
    """One twin's identity: cluster shape, tick cadence, churn
    appetite, failure-correlation zone, and RNG seed. ``deadline_s``
    > 0 makes the twin declare a client deadline on every request
    (``X-Planner-Deadline``) — the deadline-cap shed path's tenant."""

    name: str
    n_on_demand: int
    n_spot: int
    n_pods: int
    cadence_s: float
    churn_prob: float
    zone: int
    seed: int
    deadline_s: float = 0.0


def fleet_specs(
    n: int, seed: int = 0, zones: int = 4, deadline_frac: float = 0.0
) -> List[TwinSpec]:
    """A deterministic heterogeneous fleet: sizes, cadences and churn
    rates drawn from the tier menus, zones assigned round-robin so a
    zone-correlated storm hits a seeded, reproducible subset."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n):
        od, spot, pods = SIZE_TIERS[int(rng.integers(len(SIZE_TIERS)))]
        specs.append(TwinSpec(
            name=f"twin-{i:04d}",
            n_on_demand=od,
            n_spot=spot,
            n_pods=pods,
            cadence_s=float(
                CADENCE_TIERS_S[int(rng.integers(len(CADENCE_TIERS_S)))]
            ),
            churn_prob=float(
                CHURN_TIERS[int(rng.integers(len(CHURN_TIERS)))]
            ),
            zone=i % max(1, zones),
            seed=seed * 100_003 + i,
            deadline_s=(
                2.0 if deadline_frac > 0 and rng.random() < deadline_frac
                else 0.0
            ),
        ))
    return specs


def post_plan(
    url: str, body: bytes, headers: dict, timeout: float = HTTP_TIMEOUT_S
) -> bytes:
    """One wire POST, reply bytes back — the twin-sized cut of the
    agent transport: HTTP error statuses become
    :class:`RemoteCallError` carrying any 503 Retry-After (the breaker
    honors it in virtual time); connection-level failures propagate as
    ``URLError``/``OSError`` for the caller's failure accounting."""
    req = urllib.request.Request(
        url, data=body, headers=headers, method="POST"
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read()
    except urllib.error.HTTPError as err:
        retry_after = 0.0
        if err.code == 503:
            try:
                retry_after = float(err.headers.get("Retry-After", 0))
            except (TypeError, ValueError):
                retry_after = 0.0
        raise RemoteCallError(f"HTTP {err.code}", retry_after) from err


def selection(found: bool, meta, index: int, row) -> tuple:
    """The comparable selection triple (found, drained node,
    assignments) — the same shape serve-smoke diffs, so the twin's
    bit-identity check and the original single-tenant one can never
    drift apart in what "identical" means."""
    if not found or index >= meta.n_candidates:
        return (False, None, None)
    plan = meta.build_plan(index, np.asarray(row))
    return (True, plan.node.node.name, dict(plan.assignments))


class TenantTwin:
    """One simulated tenant: synthetic cluster, churn, spot storms,
    and a breaker-guarded wire client. Driven strictly sequentially by
    the fleet event loop — ``tick`` may run on a worker thread, but
    never concurrently with this twin's ``churn``/``spot_interrupt``
    mutations (the loop joins dispatches before mutating)."""

    def __init__(
        self,
        spec: TwinSpec,
        cfg: ReschedulerConfig,
        clock: Clock,
        urls: Sequence[str],
    ):
        self.spec = spec
        self.cfg = cfg
        self.clock = clock
        # the twin's OWN breaker state per replica, in ITS preference
        # order (the fleet splits primary order across twins so load
        # spreads without a balancer)
        self.endpoints: List[Endpoint] = [Endpoint(u) for u in urls]
        sspec = dataclasses.replace(
            CONFIGS[2],
            name=spec.name,
            n_on_demand=spec.n_on_demand,
            n_spot=spec.n_spot,
            n_pods=spec.n_pods,
        )
        client = generate_cluster(sspec, spec.seed, clock=clock)
        self.store = client.columnar_store(
            cfg.resources,
            on_demand_label=cfg.on_demand_node_label,
            spot_label=cfg.spot_node_label,
        )
        self.pdbs = client.list_pdbs()
        self.rng = np.random.default_rng(spec.seed ^ 0x5EED)
        self.next_due = 0.0
        # accounting the fleet aggregates (offered vs served feeds the
        # Jain fairness over demand-normalized shares)
        self.offered = 0
        self.served = 0
        self.shed_ticks = 0
        self.crashes = 0
        self.failovers = 0
        self.wait_samples_ms: List[float] = []
        # enqueue timestamp (virtual clock) per sample, parallel to
        # wait_samples_ms: the fleet bench classifies waits by WHEN THE
        # REQUEST ENTERED the system, so a request queued during an
        # outage counts against the outage even if served after restart
        self.wait_sample_t: List[float] = []
        self.last_reply: Optional[wire.PlanReply] = None
        self.last_meta = None
        self.last_error = ""
        self._parked_pod = None
        self._storm_nodes: List[object] = []  # NodeSpec parked by a storm
        # delta wire (v4): the last PLAN tick's pack + fingerprint —
        # the base the next tick's delta diffs against (per-endpoint
        # acked_fp gates actually shipping it, exactly as in the agent)
        self._prev_packed = None
        self._prev_fp = ""
        # a KIND_RESYNC demand is pending its one full-pack answer;
        # while set, delta emission is suppressed (the retry is a full
        # pack by construction, and acked_fp stays stale until served)
        self._need_full = False
        # jittered early re-tick the fleet loop honors instead of the
        # cadence (the virtual-clock form of the agent's jittered
        # in-budget resync retry): 0 = no early retry scheduled
        self.retry_due = 0.0
        # protocol accounting the storm bench aggregates
        self.resyncs = 0          # KIND_RESYNC demands observed
        self.full_posts = 0       # full-pack bodies POSTed
        self.full_served = 0      # full packs acknowledged by a replica
        self.delta_posts = 0      # delta bodies POSTed
        self.schedule_ticks = 0   # v3 schedule requests served
        self.wire_bytes_sent = 0  # request-body bytes, pack and delta
        # host-clock seconds of this twin's ticks: pack, fingerprint,
        # delta and encode; then every POST's round trip and decode
        # (the fleet twin's ``host_split``)
        self.encode_s = 0.0
        self.post_s = 0.0

    # ------------------------------------------------------------------
    # wire client

    def _note_endpoint_failure(self, ep: Endpoint, why: str,
                               retry_after: float = 0.0) -> None:
        """The agent's breaker arithmetic (same thresholds, same
        Retry-After cap) on the fleet's VIRTUAL clock: a skipped
        replica costs the twin simulated seconds, and a storm's worth
        of 503s opens breakers that expire while the fleet sleeps."""
        ep.consecutive_failures += 1
        suggested = min(
            max(retry_after, 0.0), RemotePlanner.RETRY_AFTER_CAP_S
        )
        if suggested > 0:
            # the agent's decorrelation stretch, from the twin's OWN
            # seeded RNG: distinct per-twin seeds spread equal server
            # horizons across the fleet deterministically
            suggested *= (
                1.0
                + float(self.rng.random()) * RemotePlanner.RETRY_JITTER_FRAC
            )
        if ep.consecutive_failures >= RemotePlanner.FAIL_THRESHOLD:
            n = ep.consecutive_failures - RemotePlanner.FAIL_THRESHOLD
            backoff = min(
                RemotePlanner.BACKOFF_BASE * (2.0 ** n),
                RemotePlanner.BACKOFF_MAX,
            )
            ep.skip_until = self.clock.now() + max(backoff, suggested)
        elif suggested > 0:
            ep.skip_until = self.clock.now() + suggested

    def tick(self) -> Optional[wire.PlanReply]:
        """One planning tick on the agent's full protocol ladder: pack
        (memoized O(1) on a quiet tick), fingerprint + delta against
        the previous plan tick's pack, then POST down the
        breaker-ordered endpoint list — the churn delta to an endpoint
        whose ``acked_fp`` matches the base, the fingerprinted full
        pack otherwise; every ``SCHEDULE_EVERY``-th tick asks for a v3
        drain schedule instead. A KIND_RESYNC answer defers ONE full
        pack to a jittered ``retry_due`` (decorrelation on the virtual
        clock — the agent sleeps the same jitter in real time).
        Returns the reply, or None when unserved this tick."""
        self.offered += 1
        self.last_reply = None
        self.retry_due = 0.0
        schedule_tick = (
            self.cfg.schedule_horizon > 0
            and not self._need_full
            and self.served > 0
            and self.offered % SCHEDULE_EVERY == 0
        )
        t_encode = time.perf_counter()
        try:
            packed, meta = self.store.pack(self.pdbs)
            if schedule_tick:
                # a schedule request ships the full pack WITHOUT a
                # fingerprint (the agent's plan_schedule contract): it
                # neither seeds the tenant cache nor advances the
                # delta base
                body = wire.encode_plan_request(
                    self.spec.name, packed,
                    schedule_horizon=int(self.cfg.schedule_horizon),
                )
                fp = ""
                delta_body = None
                base_fp = ""
            else:
                fp = pack_fingerprint(packed)
                delta = None
                base_fp = ""
                if self._prev_packed is not None and not self._need_full:
                    # None on shape growth past the high-water pads:
                    # this tick ships the full pack (and re-seeds)
                    delta = emit_packed_delta(self._prev_packed, packed)
                    base_fp = self._prev_fp
                body = wire.encode_plan_request(
                    self.spec.name, packed, pack_fingerprint=fp,
                )
                delta_body = (
                    wire.encode_packed_delta(
                        self.spec.name, delta,
                        base_fingerprint=base_fp, new_fingerprint=fp,
                    )
                    if delta is not None
                    and any(ep.acked_fp == base_fp for ep in self.endpoints)
                    else None
                )
                # the next tick diffs against THIS pack regardless of
                # how the tick ends — the per-endpoint acked
                # fingerprints gate shipping, exactly as in the agent
                self._prev_packed = packed
                self._prev_fp = fp
        except Exception as err:  # noqa: BLE001 — a twin must never
            # take the fleet loop down; counted + flight-recorded and
            # asserted ZERO by the fleet bench
            self.crashes += 1
            self.last_error = f"pack/encode: {err}"
            flight.note_event(
                "twin-crash", cause=f"pack/encode failed: {err}",
            )
            return None
        self.encode_s += time.perf_counter() - t_encode
        headers = {"Content-Type": "application/octet-stream"}
        if self.spec.deadline_s > 0:
            headers["X-Planner-Deadline"] = str(self.spec.deadline_s)
        now = self.clock.now()
        reply = None
        served_by = -1
        sent_delta = False
        for slot, ep in enumerate(self.endpoints):
            if ep.skip_until > now:
                continue
            use_delta = (
                delta_body is not None and ep.acked_fp == base_fp
            )
            payload = delta_body if use_delta else body
            t_post = time.perf_counter()
            try:
                raw = post_plan(f"{ep.url}/v2/plan", payload, headers)
                self.wire_bytes_sent += len(payload)
                if use_delta:
                    self.delta_posts += 1
                    decoded = wire.decode_plan_or_resync(raw)
                elif schedule_tick:
                    self.full_posts += 1
                    decoded = wire.decode_plan_schedule_reply(raw)
                else:
                    self.full_posts += 1
                    decoded = wire.decode_plan_reply(raw)
            except RemoteCallError as err:
                self.last_error = str(err)
                self._note_endpoint_failure(
                    ep, str(err), retry_after=err.retry_after
                )
                continue
            except (urllib.error.URLError, OSError, wire.WireError) as err:
                self.last_error = str(err)
                self._note_endpoint_failure(ep, str(err))
                continue
            except Exception as err:  # noqa: BLE001 — contain: an
                # unexpected client-side failure is a twin crash, not a
                # fleet crash; counted + flight-recorded, asserted zero
                self.crashes += 1
                self.last_error = f"tick: {err}"
                flight.note_event(
                    "twin-crash", cause=f"tick failed: {err}",
                )
                return None
            finally:
                self.post_s += time.perf_counter() - t_post
            if isinstance(decoded, wire.ResyncDemand):
                # protocol, not failure: no breaker, no failover walk.
                # The one full-pack answer is DEFERRED a jittered
                # moment (per-twin seeded RNG) — 256 tenants staled by
                # one restart must not re-upload in the same instant.
                # This replica does NOT hold the base it acked (that is
                # what it just said): drop the stale fingerprint, or a
                # quiet tenant's unchanged fp would "match" again after
                # a restart and demand a second resync
                ep.acked_fp = ""
                self.resyncs += 1
                self._need_full = True
                self.last_error = f"resync: {decoded.cause}"
                # spread the full-pack answers over up to half a
                # cadence (capped at the agent's 30s retry ceiling):
                # a restart stales a whole replica's tenants at once,
                # and a 2s herd of full packs is the storm the server
                # would then have to shed
                spread = max(
                    RemotePlanner.RESYNC_JITTER_S,
                    min(self.spec.cadence_s * 0.5,
                        RemotePlanner.RETRY_AFTER_CAP_S),
                )
                self.retry_due = now + float(
                    self.rng.uniform(0.05, spread)
                )
                return None
            reply = decoded
            sent_delta = use_delta
            ep.consecutive_failures = 0
            ep.skip_until = 0.0
            if fp:
                # this replica now holds exactly this pack (full
                # upload, or delta applied over an acknowledged base)
                ep.acked_fp = fp
            served_by = slot
            break
        if reply is None:
            self.shed_ticks += 1
            if self._need_full:
                # a storm-refused resync retry: come back when the
                # soonest breaker window opens, plus jitter — the
                # load-derived Retry-After horizons (different per
                # refusal) stagger the fleet's convergence
                soonest = min(
                    (ep.skip_until for ep in self.endpoints), default=now
                )
                self.retry_due = max(soonest, now) + float(
                    self.rng.uniform(0.1, RemotePlanner.RESYNC_JITTER_S)
                )
            return None
        if served_by > 0:
            # ONE fire site for the twin's failover edge: the metric
            # and the flight event can then be asserted equal
            self.failovers += 1
            metrics.update_remote_planner_failover()
            flight.note_event(
                "failover",
                cause="primary replica unusable; served by fallback",
                reason=f"slot-{served_by}",
            )
        self.served += 1
        if fp and not sent_delta:
            self.full_served += 1
            self._need_full = False
        if schedule_tick:
            self.schedule_ticks += 1
        self.wait_samples_ms.append(float(reply.queue_wait_ms))
        self.wait_sample_t.append(now)
        if not schedule_tick:
            self.last_reply = reply
            self.last_meta = meta
        return reply if not schedule_tick else None

    # ------------------------------------------------------------------
    # correctness spot check

    def verify(self, solo) -> Optional[dict]:
        """Bit-identity spot check: rebuild the served selection from
        the wire reply and diff it against a solo in-process plan over
        the SAME store state (None = identical; a dict names the
        drift). Call between a tick and the next mutation."""
        if self.last_reply is None or self.last_meta is None:
            return None
        got = selection(
            self.last_reply.found, self.last_meta,
            self.last_reply.index, self.last_reply.row,
        )
        report = solo.plan(self.store, self.pdbs)
        if report.plan is None:
            want = (False, None, None)
        else:
            want = (
                True,
                report.plan.node.node.name,
                dict(report.plan.assignments),
            )
        if got != want:
            return {"twin": self.spec.name, "served": got[:2],
                    "solo": want[:2]}
        return None

    # ------------------------------------------------------------------
    # scenario mutations (driver thread only; never concurrent with tick)

    def churn(self) -> bool:
        """One churn roll: with probability ``churn_prob``, toggle a
        pod out of (or back into) the cluster — the steady workload
        drift that keeps re-packs honest without shrinking the twin
        monotonically."""
        if self.spec.churn_prob <= 0:
            return False
        if float(self.rng.random()) >= self.spec.churn_prob:
            return False
        store = self.store
        if self._parked_pod is not None:
            pod = self._parked_pod
            if pod.node_name in store._node_row:
                store.add_pod(pod)
                self._parked_pod = None
                return True
            return False  # its node is storm-parked; retry later
        if not store._pod_row:
            return False
        uid = next(iter(store._pod_row))
        self._parked_pod = store.pod_objs[store._pod_row[uid]]
        store.remove_pod(uid)
        return True

    def live_spot_nodes(self) -> List[object]:
        return [
            n for n in self.store.node_objs
            if n is not None and n.name in self.store._node_row
            and matches_label(n.labels, self.store.spot_label)
        ]

    def spot_interrupt(self, frac: float) -> int:
        """A correlated spot storm hits this twin: reclaim ``frac`` of
        its live spot nodes (at least one). The columnar store parks
        the victims' pods as orphans keyed by node name, so
        ``spot_restore`` re-adding the SAME NodeSpec gets them back —
        the kubelet re-registration semantics the store already
        models."""
        live = self.live_spot_nodes()
        if not live:
            return 0
        take = max(1, int(round(len(live) * frac)))
        victims = live[:take]
        for node in victims:
            self.store.remove_node(node.name)
            self._storm_nodes.append(node)
        log.vlog(
            2, "twin %s: spot storm reclaimed %d/%d spot nodes",
            self.spec.name, len(victims), len(live),
        )
        return len(victims)

    def spot_restore(self) -> int:
        """The storm passes: re-register every parked spot node (its
        orphaned pods come back with it)."""
        n = len(self._storm_nodes)
        for node in self._storm_nodes:
            self.store.add_node(node)
        self._storm_nodes.clear()
        return n

    # ------------------------------------------------------------------

    def bucket_signature(self) -> tuple:
        """The twin's current packed shape (its service-bucket
        identity) — the fleet's join/leave test asserts membership
        churn changes the fleet's bucket MAP without resync storms."""
        packed, _ = self.store.pack(self.pdbs)
        return tuple(packed.slot_req.shape) + tuple(packed.spot_free.shape)

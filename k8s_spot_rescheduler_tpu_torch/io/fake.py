"""In-memory simulated cluster.

The unit-test / benchmark / replay "apiserver": holds node and pod state,
serves the read path, and models the write path with injectable failure
counts and termination latency on a virtual clock. It optionally runs a
tiny first-fit scheduler so evicted pods *re-appear* on spot nodes — the
closed-loop behavior the reference relies on the real kube-scheduler for
(README.md:116-123: evicted pods get rescheduled onto the spot pool).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from k8s_spot_rescheduler_tpu_torch.io.cluster import EvictionError
from k8s_spot_rescheduler_tpu_torch.models.cluster import (
    CPU,
    MEMORY,
    PODS,
    NodeSpec,
    PDBSpec,
    PodSpec,
    Taint,
)
from k8s_spot_rescheduler_tpu_torch.predicates.masks import (
    ZONE_LABEL,
    hosts_affinity_match,
    match_node_affinity,
)
from k8s_spot_rescheduler_tpu_torch.predicates.selectors import (
    selector_matches,
    term_matches,
)
from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock
from k8s_spot_rescheduler_tpu_torch.utils.labels import matches_label


@dataclasses.dataclass
class Event:
    kind: str
    name: str
    event_type: str
    reason: str
    message: str


class FakeCluster:
    """ClusterClient + EventSink implementation over plain dicts."""

    # an eviction here is an in-memory append plus a scheduled
    # termination: the drain actuator runs a round's evictions in pod
    # order instead of over its thread pool (actuator/drain.py), so the
    # eviction log, the termination order and the re-placements never
    # depend on thread scheduling
    serial_evictions = True

    def __init__(
        self,
        clock: Optional[FakeClock] = None,
        *,
        termination_latency: float = 1.0,
        reschedule_evicted: bool = False,
        spot_label: str = "kubernetes.io/role=spot-worker",
    ):
        self.clock = clock or FakeClock()
        self.termination_latency = termination_latency
        self.reschedule_evicted = reschedule_evicted
        self.spot_label = spot_label
        self.nodes: Dict[str, NodeSpec] = {}
        self.pods: Dict[str, PodSpec] = {}  # keyed by namespace/name
        self._by_node: Dict[str, Dict[str, PodSpec]] = {}  # node -> uid -> pod
        self.pdbs: List[PDBSpec] = []
        # volume topology: claims keyed by uid, volumes by name. Pods are
        # resolved against these at add_pod (models/volumes.py) — add
        # PVs/PVCs BEFORE their pods, as a real cluster's bindings
        # pre-date the running pods the planner moves.
        self.pvcs: Dict[str, object] = {}
        self.pvs: Dict[str, object] = {}
        self.events: List[Event] = []
        self.pending: List[PodSpec] = []  # unschedulable (evicted, unplaced)
        # pod uid -> number of eviction calls that must fail first
        self.eviction_failures: Dict[str, int] = {}
        self.evictions: List[str] = []  # audit log of successful evictions
        self._columnar = None  # lazily attached ColumnarStore mirror
        # pod uid -> spot node name: the planner's proven placement for an
        # imminent eviction (DrainPlan.assignments). When set, _schedule
        # tries this node first — standing in for a scheduler that honors
        # the drain plan (the real kube-scheduler re-places pods by its own
        # scoring, README.md:116-123; the quality benchmarks measure
        # *planner* quality, so they route by the proof).
        self.placement_hints: Dict[str, str] = {}

    # --- columnar fast path ---

    def columnar_store(
        self, resources, *, on_demand_label: str, spot_label: str
    ):
        """Attach (or return) the incrementally-maintained columnar mirror
        of this cluster — the control loop's vectorized observe path."""
        from k8s_spot_rescheduler_tpu_torch.models.columnar import ColumnarStore

        store = self._columnar
        if (
            store is None
            or store.resources != tuple(resources)
            or store.on_demand_label != on_demand_label
            or store.spot_label != spot_label
        ):
            store = ColumnarStore(
                resources,
                on_demand_label=on_demand_label,
                spot_label=spot_label,
            )
            for node in self.nodes.values():
                store.add_node(node)
            for pod in self.pods.values():
                store.add_pod(pod)
            self._columnar = store
        return store

    # --- state construction helpers ---

    def add_node(self, node: NodeSpec) -> None:
        self.nodes[node.name] = node
        if self._columnar is not None:
            self._columnar.add_node(node)
        self.retry_pending()

    def add_pod(self, pod: PodSpec) -> None:
        assert pod.node_name in self.nodes, f"unknown node {pod.node_name}"
        if pod.pvc_resolvable:
            from k8s_spot_rescheduler_tpu_torch.models.volumes import (
                resolve_volume_affinity,
            )

            pod = resolve_volume_affinity(pod, self.pvcs, self.pvs)
        stale = self.pods.get(pod.uid)
        self.pods[pod.uid] = pod  # dict upsert: position is preserved
        if stale is not None and stale.node_name != pod.node_name:
            # a re-add under the same uid is a move: one placement only.
            # The production watch path derives its per-node view from
            # the uid-keyed dict, where the upsert kept the pod's global
            # position — rebuild the destination bucket in that order so
            # CPU-tie slot order matches (moves are rare; O(pods)).
            self._by_node.get(stale.node_name, {}).pop(pod.uid, None)
            self._by_node[pod.node_name] = {
                p.uid: p
                for p in self.pods.values()
                if p.node_name == pod.node_name
            }
        else:
            self._by_node.setdefault(pod.node_name, {})[pod.uid] = pod
        if self._columnar is not None:
            self._columnar.add_pod(pod)

    def _remove_pod(self, uid: str) -> Optional[PodSpec]:
        pod = self.pods.pop(uid, None)
        if pod is not None:
            self._by_node.get(pod.node_name, {}).pop(uid, None)
        if self._columnar is not None:
            self._columnar.remove_pod(uid)
        return pod

    def remove_node(self, name: str) -> List[PodSpec]:
        """Spot interruption: the node and its pods vanish; returns the
        displaced pods (the replay harness re-queues them as pending)."""
        self.nodes.pop(name, None)
        displaced = list(self._by_node.pop(name, {}).values())
        for p in displaced:
            self.pods.pop(p.uid, None)
            if self._columnar is not None:
                self._columnar.remove_pod(p.uid)
        if self._columnar is not None:
            self._columnar.remove_node(name)
        return displaced

    # --- read path ---

    def list_ready_nodes(self) -> List[NodeSpec]:
        # reference uses NewReadyNodeLister (rescheduler.go:154): not-ready
        # nodes are invisible to the controller.
        return [n for n in self.nodes.values() if n.ready]

    def list_unready_nodes(self) -> List[NodeSpec]:
        # presence-only visibility (NodeMap.unready): zone/spread counts
        # span these nodes' pods; they are never planning surface
        return [n for n in self.nodes.values() if not n.ready]

    def list_pods_on_node(self, node_name: str) -> List[PodSpec]:
        return list(self._by_node.get(node_name, {}).values())

    def list_unschedulable_pods(self) -> List[PodSpec]:
        return list(self.pending)

    def list_pdbs(self) -> List[PDBSpec]:
        return list(self.pdbs)

    def get_pod(self, namespace: str, name: str) -> Optional[PodSpec]:
        return self.pods.get(f"{namespace}/{name}")

    # --- write path ---

    def evict_pod(self, pod: PodSpec, grace_seconds: int) -> None:
        live = self.pods.get(pod.uid)
        if live is None:
            return  # already gone — eviction succeeds trivially
        remaining = self.eviction_failures.get(pod.uid, 0)
        if remaining > 0:
            self.eviction_failures[pod.uid] = remaining - 1
            raise EvictionError(f"simulated eviction failure for {pod.uid}")
        self.evictions.append(pod.uid)
        # pod terminates after its graceful period (bounded by latency knob)
        delay = min(float(grace_seconds), self.termination_latency)
        self.clock.call_at(self.clock.now() + delay, lambda: self._terminate(pod.uid))

    def _terminate(self, uid: str) -> None:
        pod = self._remove_pod(uid)
        if pod is None:
            return
        if self.reschedule_evicted:
            self._schedule(pod)
            self.retry_pending()

    def retry_pending(self) -> None:
        """Re-attempt placement of unschedulable pods (capacity may have
        appeared since)."""
        if not self.reschedule_evicted or not self.pending:
            return
        waiting, self.pending = self.pending, []
        for pod in waiting:
            self._schedule(pod)

    def _can_place(self, pod: PodSpec, node: NodeSpec) -> bool:
        """The fake scheduler's admission check for one (pod, node) pair —
        the same predicate surface _schedule always enforced."""
        if not matches_label(node.labels, self.spot_label):
            return False
        if not node.ready or node.unschedulable:
            return False
        if any(node.labels.get(k) != v for k, v in pod.node_selector.items()):
            return False
        if not match_node_affinity(pod.node_affinity, node.labels, node.name):
            return False
        hard = [t for t in node.taints if t.effect in ("NoSchedule", "NoExecute")]
        if any(
            not any(tol.tolerates(t) for tol in pod.tolerations) for t in hard
        ):
            return False
        here = self.list_pods_on_node(node.name)
        if len(here) >= node.allocatable.get(PODS, 110):
            return False
        free_cpu = node.allocatable.get(CPU, 0) - sum(
            p.requests.get(CPU, 0) for p in here
        )
        free_mem = node.allocatable.get(MEMORY, 0) - sum(
            p.requests.get(MEMORY, 0) for p in here
        )
        # every check here is a pure predicate, so their order changes
        # no answer; the cheap resource fit goes first because the zone
        # and spread checks below scan the whole cluster
        if pod.requests.get(CPU, 0) > free_cpu or (
            pod.requests.get(MEMORY, 0) > free_mem
        ):
            return False
        if pod.anti_affinity_group and any(
            p.anti_affinity_group == pod.anti_affinity_group for p in here
        ):
            return False

        # selector anti-affinity, both directions (the scheduler
        # respects existing pods' required anti-affinity too) — round-5
        # widened terms: any term of a's whose scope covers b and whose
        # selector matches b repels
        def _repels(a: PodSpec, b: PodSpec) -> bool:
            return any(
                term_matches(t, b.namespace, b.labels)
                for t in a.anti_affinity_match
            )

        if any(_repels(pod, p) or _repels(p, pod) for p in here):
            return False
        # required positive pod-affinity: the node must already host a
        # match for EVERY term (hostname topology) — the same predicate
        # the packers' PodAffinityBit node side evaluates
        if pod.pod_affinity_match and not all(
            hosts_affinity_match(here, nss, items)
            for nss, items in pod.pod_affinity_match
        ):
            return False
        # zone-topology positive pod-affinity: the node's ZONE must
        # already host a match per term (masks.ZonePodAffinityBit)
        if pod.pod_affinity_zone_match:
            zone_val = node.labels.get(ZONE_LABEL)
            if zone_val is None:
                return False
            zone_pods = [
                q
                for n2 in self.nodes.values()
                if n2.labels.get(ZONE_LABEL) == zone_val
                for q in self.list_pods_on_node(n2.name)
            ]
            if not all(
                hosts_affinity_match(zone_pods, nss, items)
                for nss, items in pod.pod_affinity_zone_match
            ):
                return False
        # zone-topology anti-affinity, both directions, across the whole
        # zone (nodes without the zone label never conflict)
        zone = node.labels.get(ZONE_LABEL)
        if zone is not None:
            def _zone_pods():
                for n2 in self.nodes.values():
                    if n2.labels.get(ZONE_LABEL) == zone:
                        yield from self.list_pods_on_node(n2.name)

            if pod.anti_affinity_zone_match and any(
                term_matches(t, p.namespace, p.labels)
                for p in _zone_pods()
                for t in pod.anti_affinity_zone_match
            ):
                return False
            for p in _zone_pods():
                if any(
                    term_matches(t, pod.namespace, pod.labels)
                    for t in p.anti_affinity_zone_match
                ):
                    return False
        # hard topology-spread (canonical shapes): refuse placements
        # that would exceed maxSkew — kube-scheduler's PodTopologySpread
        # filter over existing pods (the evicted pod is pending, so it
        # is already off its old node here), incl. the selfMatch rule
        for topo, skew, items in pod.spread_constraints:
            d = node.labels.get(topo)
            if d is None:
                return False  # nodes lacking the key are filtered
            counts: Dict[str, int] = {}
            for n2 in self.nodes.values():
                d2 = n2.labels.get(topo)
                if d2 is None:
                    continue
                counts.setdefault(d2, 0)
                for p in self.list_pods_on_node(n2.name):
                    if p.namespace == pod.namespace and selector_matches(
                        items, p.labels
                    ):
                        counts[d2] += 1
            self_m = selector_matches(items, pod.labels)
            if counts[d] + (1 if self_m else 0) - min(counts.values()) > skew:
                return False
        return True

    def _schedule(self, pod: PodSpec) -> None:
        """Minimal kube-scheduler stand-in: the planner's hinted node if one
        is recorded and still admissible, else first spot node with room."""
        if pod.unmodeled_constraints:
            self.pending.append(pod)  # can't reason about it; stays pending
            return
        hint = self.placement_hints.pop(pod.uid, None)
        if hint is not None:
            node = self.nodes.get(hint)
            if node is not None and self._can_place(pod, node):
                self.add_pod(dataclasses.replace(pod, node_name=node.name))
                return
        for node in self.nodes.values():
            if self._can_place(pod, node):
                self.add_pod(dataclasses.replace(pod, node_name=node.name))
                return
        self.pending.append(pod)

    def add_taint(self, node_name: str, taint: Taint) -> None:
        from k8s_spot_rescheduler_tpu_torch.models.cluster import (
            parse_rescheduler_taint_value,
        )

        node = self.nodes[node_name]
        if taint in node.taints:
            return
        for t in node.taints:
            # mirror KubeClusterClient.add_taint: a same-key entry we
            # own is replaced (re-drains refresh the ownership stamp),
            # a FOREIGN same-key entry (CA's scale-down marker) is kept
            # untouched — taint keys are unique per node, and stealing
            # CA's would let the orphan sweep later strip it
            if t.key == taint.key and t.value and (
                parse_rescheduler_taint_value(t.value) is None
            ):
                return
        # REPLACE the list, never mutate in place: the columnar store's
        # per-row mask cache keys on the taint list's identity
        # (models/columnar._spot_taint_rows), exactly like the real
        # kube/watch paths deliver fresh objects
        node.taints = [t for t in node.taints if t.key != taint.key] + [taint]

    def remove_taint(self, node_name: str, taint_key: str) -> None:
        node = self.nodes.get(node_name)
        if node:
            node.taints = [t for t in node.taints if t.key != taint_key]

    # --- event sink ---

    def event(
        self, kind: str, name: str, event_type: str, reason: str, message: str
    ) -> None:
        self.events.append(Event(kind, name, event_type, reason, message))

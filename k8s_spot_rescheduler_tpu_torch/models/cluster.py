"""Host-side cluster model: pods, nodes, and the classified node map.

This is the framework's equivalent of the reference's ``nodes`` package
(reference nodes/nodes.go): plain-data pod/node specs (instead of client-go
API objects), a ``NodeInfo`` carrying per-node accounting, and
``build_node_map`` reproducing the reference's classification and sort
policy — spot nodes most-requested-CPU-first, on-demand nodes
least-requested-first, pods biggest-CPU-request-first
(nodes/nodes.go:63-101; policy rationale README.md:136-149).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from k8s_spot_rescheduler_tpu_torch.utils.labels import matches_label

# Resource names use k8s conventions. Base units: "cpu" is in millicores
# (the reference's MilliValue, nodes/nodes.go:149-165), "memory" and
# "ephemeral-storage" in bytes, "pods" in count.
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL = "ephemeral-storage"
PODS = "pods"

MIRROR_POD_ANNOTATION = "kubernetes.io/config.mirror"

# Taint key the actuator sets while draining; equivalent of the cluster-
# autoscaler ToBeDeleted taint applied via deletetaint.MarkToBeDeleted
# (reference scaler/scaler.go:77).
TO_BE_DELETED_TAINT = "ToBeDeletedByClusterAutoscaler"

# Value the actuator writes into its ToBeDeleted taint: an explicit
# ownership marker. The REAL cluster autoscaler applies the same taint
# key during its own scale-downs (with a bare unix timestamp as the
# value) — including on the drained-empty on-demand nodes this
# rescheduler produces, whose deletion is the product's end goal. The
# orphaned-taint sweep must therefore be able to tell "mine, left by a
# crashed drain" apart from "CA's, mid scale-down"; only values carrying
# this marker are ever swept. Format:
# ``spot-rescheduler_<unix-wall-ts>_<holder-identity>``, capped at the
# 63 characters a taint value allows.
RESCHEDULER_TAINT_MARKER = "spot-rescheduler"
_TAINT_VALUE_MAX = 63
# marker + two "_" separators + an up-to-11-digit timestamp
_TAINT_IDENTITY_MAX = _TAINT_VALUE_MAX - len(RESCHEDULER_TAINT_MARKER) - 2 - 11


def rescheduler_taint_identity(identity: str) -> str:
    """Holder identity exactly as embedded in (and parsed back out of) a
    rescheduler taint value: sanitized to legal taint-value characters,
    shortened so the full value fits in 63 chars, and guaranteed to end
    alphanumeric (k8s validates taint values as label values — a
    trailing '_'/'-'/'.' would make every add_taint 422). Over-long
    identities keep a prefix PLUS a hash of the whole string — pod
    names carry their distinguishing hash at the END, and two replicas
    must never truncate to the same embedded identity (a shared "own"
    identity would let one sweep the other's live drain with no grace
    wait). Sweepers must compare against THIS, not the raw identity."""
    cleaned = re.sub(r"[^A-Za-z0-9._-]", "-", identity or "")
    if len(cleaned) > _TAINT_IDENTITY_MAX:
        import hashlib

        digest = hashlib.sha1(cleaned.encode()).hexdigest()[:8]
        cleaned = cleaned[: _TAINT_IDENTITY_MAX - 9] + "-" + digest
    cleaned = cleaned.rstrip("_.-")
    return cleaned or "unknown"


def rescheduler_taint_value(identity: str, wall_ts: float) -> str:
    return (
        f"{RESCHEDULER_TAINT_MARKER}_{int(wall_ts)}_"
        f"{rescheduler_taint_identity(identity)}"
    )


def parse_rescheduler_taint_value(
    value: str,
) -> Optional[Tuple[str, Optional[float]]]:
    """``(holder-identity, wall-ts | None)`` when ``value`` carries the
    rescheduler marker, else None — not our taint, leave it alone."""
    prefix = RESCHEDULER_TAINT_MARKER + "_"
    if not value or not value.startswith(prefix):
        return None
    ts_str, _, identity = value[len(prefix):].partition("_")
    try:
        ts: Optional[float] = float(ts_str)
    except ValueError:
        ts = None
    return identity, ts


@dataclasses.dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclasses.dataclass(frozen=True)
class Toleration:
    key: str = ""  # empty key + Exists tolerates everything
    value: str = ""
    operator: str = "Equal"  # Equal | Exists
    effect: str = ""  # empty matches all effects

    def tolerates(self, taint: Taint) -> bool:
        """k8s toleration matching semantics."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


@dataclasses.dataclass(frozen=True)
class OwnerRef:
    kind: str
    name: str
    controller: bool = True


@dataclasses.dataclass
class PodSpec:
    """A pod, reduced to what scheduling/eviction decisions need."""

    name: str
    namespace: str = "default"
    node_name: str = ""
    requests: Dict[str, int] = dataclasses.field(default_factory=dict)
    priority: int = 0
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    owner_refs: List[OwnerRef] = dataclasses.field(default_factory=list)
    tolerations: List[Toleration] = dataclasses.field(default_factory=list)
    # Simplified pod-anti-affinity: pods sharing a non-empty group refuse to
    # co-locate on one node (topologyKey=hostname requiredDuringScheduling).
    anti_affinity_group: str = ""
    # Required podAntiAffinity terms with topologyKey=hostname, in the
    # round-5 canonical form (predicates/selectors.py): a tuple of
    # ``(namespaces, selector)`` terms, any number of them, each
    # selector the full LabelSelector operator surface (In / NotIn /
    # Exists / DoesNotExist, multi-value In) and each namespaces tuple
    # either the pod's own namespace (the implicit default) or an
    # explicit cross-namespace list. The pod refuses nodes hosting any
    # pod in a term's scope matched by its selector, and — symmetrically,
    # like the real scheduler — matched pods refuse nodes hosting this
    # pod. Construction accepts the matchLabels-dict shorthand (one
    # own-namespace term); ``__post_init__`` canonicalizes. Shapes
    # beyond this (namespaceSelector, other topology keys) fall back to
    # ``unmodeled_constraints``.
    anti_affinity_match: Tuple = ()
    # Required anti-affinity terms with
    # topologyKey=topology.kubernetes.io/zone (same canonical term
    # shape): the pod refuses nodes in any ZONE hosting a matched pod,
    # and — symmetrically — matched pods refuse zones hosting this pod.
    # Zones come from the standard node label. Modeled statically per
    # tick via zone-salted affinity-group bits
    # (predicates/masks.zone_match_affinity_mask); when two
    # zone-involved pods share one candidate lane the packers
    # conservatively mark them unplaceable (static bits cannot prove the
    # in-plan interaction safe). Legacy zone label keys and other
    # topology keys fall back to ``unmodeled_constraints``.
    anti_affinity_zone_match: Tuple = ()
    # Required POSITIVE pod-affinity terms, topologyKey=hostname (same
    # canonical term shape, any number of terms — every term must be
    # satisfied): the pod may only schedule onto a node already hosting
    # a pod matched by each selector in its scope. The planner is
    # conservative about the dynamics: only pods RESIDENT on a spot node
    # before the plan count as matches (placements made by the plan
    # itself could only create additional matches, so ignoring them can
    # only lose a drain, never strand a pod). A term whose selector can
    # match no pod keeps the pod exactly unplaceable (no node can ever
    # qualify — the scheduler's own verdict).
    pod_affinity_match: Tuple = ()
    # Required POSITIVE pod-affinity terms with ZONE topology: the pod
    # may only schedule into a zone already hosting a match per term.
    # Same canonical term rules; per-carrier allowed-zone verdicts
    # (masks.ZonePodAffinityBit) computed from pre-plan counted
    # residents, excluding matches on the carrier's own candidate node
    # (they leave in the same drain). Hostname and zone positive terms
    # may coexist in any number.
    pod_affinity_zone_match: Tuple = ()
    phase: str = "Running"
    # spec.nodeSelector: the pod only schedules onto nodes carrying every
    # one of these labels (the kube-scheduler's NodeSelector predicate,
    # part of the reference's CheckPredicates surface, README.md:103-114).
    node_selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    # Required node-affinity (spec.affinity.nodeAffinity.requiredDuring
    # SchedulingIgnoredDuringExecution), canonicalized: a tuple of terms
    # (OR), each a tuple of (key, operator, values) expressions (AND)
    # with operators In/NotIn/Exists/DoesNotExist/Gt/Lt — the full
    # NodeSelectorTerm matchExpressions surface. Evaluated host-side per
    # node (predicates/masks.match_node_affinity) and interned as one
    # pseudo-taint bit per distinct requirement. matchFields and
    # malformed shapes fall back to ``unmodeled_constraints``.
    node_affinity: Tuple = ()
    # PersistentVolumeClaim names this pod's volumes reference (the
    # pod's own namespace). Decode marks such pods unmodeled; the
    # volume-affinity resolver (models/volumes.py) lifts that when every
    # claim is Bound to a PV whose nodeAffinity is absent or modelable,
    # folding the PVs' terms into ``node_affinity``.
    pvc_names: Tuple = ()
    # True iff the ONLY reason this pod is unmodeled is its PVCs — the
    # resolver may clear ``unmodeled_constraints`` exactly then. Keeping
    # the flag separate keeps every unresolved path fail-safe: a pod
    # that never meets the resolver stays placeable-nowhere.
    pvc_resolvable: bool = False
    # Hard topologySpreadConstraints (whenUnsatisfiable=DoNotSchedule,
    # the k8s default), modeled in the canonical shape: topologyKey is
    # hostname or the standard zone label, a non-empty selector in the
    # round-5 widened operator form (matchLabels and/or matchExpressions
    # with In/NotIn/Exists/DoesNotExist — always own-namespace, per the
    # k8s API), integer maxSkew >= 1, and none of the counting-semantics
    # modifiers (minDomains, matchLabelKeys, nodeAffinityPolicy,
    # nodeTaintsPolicy). Each entry is a canonical tuple
    # (topology_key, max_skew, selector requirements); any number of
    # entries (the hostname+zone pair is the common Deployment shape).
    # The packers turn each into a per-carrier SpreadBit pseudo-taint
    # (predicates/masks.py) whose refused-domain set is computed from
    # this tick's per-domain match counts; ScheduleAnyway entries are
    # soft and ignored; shapes beyond the canonical form fall back to
    # ``unmodeled_constraints``. Construction accepts legacy
    # ((key, value), ...) selector items; ``__post_init__``
    # canonicalizes.
    spread_constraints: Tuple = ()
    # Scheduling constraints this framework does not model (unresolved
    # volume topology, cross-namespace affinity, non-canonical spread
    # constraints, ...). Conservative in the safe direction: such a pod
    # is treated as placeable nowhere, so its node can never be proven
    # drainable — we may miss a drain the real scheduler would allow,
    # but never approve one that strands the pod.
    unmodeled_constraints: bool = False

    def __post_init__(self) -> None:
        # canonicalize the affinity/spread selector fields (the dict /
        # legacy-items shorthands used by tests and synthetic generators
        # become full canonical terms; decode output passes through)
        from k8s_spot_rescheduler_tpu_torch.predicates.selectors import (
            canon_match_terms,
            canon_spread_entries,
        )

        self.anti_affinity_match = canon_match_terms(
            self.anti_affinity_match, self.namespace
        )
        self.anti_affinity_zone_match = canon_match_terms(
            self.anti_affinity_zone_match, self.namespace
        )
        self.pod_affinity_match = canon_match_terms(
            self.pod_affinity_match, self.namespace
        )
        self.pod_affinity_zone_match = canon_match_terms(
            self.pod_affinity_zone_match, self.namespace
        )
        self.spread_constraints = canon_spread_entries(self.spread_constraints)

    @property
    def uid(self) -> str:
        return f"{self.namespace}/{self.name}"

    def is_mirror(self) -> bool:
        return MIRROR_POD_ANNOTATION in self.annotations

    def controller_ref(self) -> Optional[OwnerRef]:
        for ref in self.owner_refs:
            if ref.controller:
                return ref
        return None

    def is_daemonset(self) -> bool:
        """DaemonSet-controlled, per the reference's ownerRef check
        (rescheduler.go:243-249)."""
        ref = self.controller_ref()
        return ref is not None and ref.kind == "DaemonSet"


@dataclasses.dataclass
class NodeSpec:
    name: str
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    allocatable: Dict[str, int] = dataclasses.field(default_factory=dict)
    taints: List[Taint] = dataclasses.field(default_factory=list)
    ready: bool = True
    unschedulable: bool = False

    def allocatable_cpu(self) -> int:
        return int(self.allocatable.get(CPU, 0))


@dataclasses.dataclass
class PVCSpec:
    """PersistentVolumeClaim, reduced to the binding the volume-affinity
    resolver needs."""

    name: str
    namespace: str = "default"
    volume_name: str = ""  # bound PV name; "" while unbound
    phase: str = "Bound"

    @property
    def uid(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclasses.dataclass
class PVSpec:
    """PersistentVolume, reduced to its node-affinity constraint
    (spec.nodeAffinity.required — zonal/local volumes pin their pods to
    matching nodes; the same canonical terms form as pod nodeAffinity)."""

    name: str
    node_affinity: Tuple = ()  # canonical terms; () = no constraint
    unmodeled: bool = False  # affinity shape beyond the canonical form


@dataclasses.dataclass
class PDBSpec:
    """PodDisruptionBudget, reduced to the evictability decision: which pods
    it selects and how many more disruptions it currently allows.

    ``match_labels`` holds the canonical requirement selector
    (predicates/selectors.py; round 5 widened to the full
    matchLabels/matchExpressions operator surface — the reference gets
    this free through cluster-autoscaler's drain filter,
    rescheduler.go:231). Construction accepts the matchLabels-dict
    shorthand. An EMPTY selector selects every pod in the namespace
    (k8s PDB semantics — also the conservative decode fallback for
    selector shapes beyond the modeled surface, so an unparseable PDB
    blocks rather than under-protects)."""

    name: str
    namespace: str = "default"
    match_labels: Tuple = ()
    disruptions_allowed: int = 0

    def __post_init__(self) -> None:
        if isinstance(self.match_labels, dict):
            from k8s_spot_rescheduler_tpu_torch.predicates.selectors import (
                canon_labels,
            )

            self.match_labels = canon_labels(self.match_labels)
        else:
            self.match_labels = tuple(sorted(set(self.match_labels)))

    def selects(self, pod: PodSpec) -> bool:
        if pod.namespace != self.namespace:
            return False
        from k8s_spot_rescheduler_tpu_torch.predicates.selectors import (
            selector_matches,
        )

        return selector_matches(self.match_labels, pod.labels)


def pod_cpu_requests(pod: PodSpec) -> int:
    """Total requested CPU millicores (reference nodes/nodes.go:158-165
    ``getPodCPURequests``; containers are pre-summed into ``requests``)."""
    return int(pod.requests.get(CPU, 0))


def pods_requested(pods: Iterable[PodSpec], resource: str = CPU) -> int:
    """Reference nodes/nodes.go:149-155 ``calculateRequestedCPU``,
    generalized over the resource axis."""
    return sum(int(p.requests.get(resource, 0)) for p in pods)


@dataclasses.dataclass
class NodeInfo:
    """Reference nodes/nodes.go:46-51 ``NodeInfo``."""

    node: NodeSpec
    pods: List[PodSpec]
    requested_cpu: int
    free_cpu: int

    @classmethod
    def build(cls, node: NodeSpec, pods: Sequence[PodSpec]) -> "NodeInfo":
        requested = pods_requested(pods)
        return cls(
            node=node,
            pods=list(pods),
            requested_cpu=requested,
            free_cpu=node.allocatable_cpu() - requested,
        )

    def add_pod(self, pod: PodSpec) -> None:
        """Reference nodes/nodes.go:121-126 ``AddPod``: append and
        recompute requested/free."""
        self.pods.append(pod)
        self.requested_cpu = pods_requested(self.pods)
        self.free_cpu = self.node.allocatable_cpu() - self.requested_cpu

    def copy(self) -> "NodeInfo":
        """Shallow copy with its own pods list, like the reference's
        ``CopyNodeInfos`` element copy (nodes/nodes.go:211-224)."""
        return NodeInfo(
            node=self.node,
            pods=list(self.pods),
            requested_cpu=self.requested_cpu,
            free_cpu=self.free_cpu,
        )


@dataclasses.dataclass
class NodeMap:
    """Reference nodes/nodes.go:37-39, 54-60 ``Map``: node infos keyed by
    class, in planning order.

    ``other`` holds ready nodes matching neither class label; ``unready``
    holds not-ready nodes of ANY class (the reference's lister drops
    both, rescheduler.go:154 / nodes/nodes.go:90-91, and so does our
    planning surface) — but their RESIDENT PODS still exist to the real
    scheduler: zone anti-affinity presence reaches them, and
    PodTopologySpread counts their domains and pods (NotReady manifests
    as taints, which the default nodeTaintsPolicy=Ignore ignores).
    Missing either could approve a drain the scheduler then refuses.
    The packers fold both buckets into the zone/spread presence only;
    they never become candidates or placement targets."""

    on_demand: List[NodeInfo]
    spot: List[NodeInfo]
    other: List[NodeInfo] = dataclasses.field(default_factory=list)
    unready: List[NodeInfo] = dataclasses.field(default_factory=list)


def is_spot_node(node: NodeSpec, spot_label: str) -> bool:
    return matches_label(node.labels, spot_label)


def is_on_demand_node(node: NodeSpec, on_demand_label: str) -> bool:
    return matches_label(node.labels, on_demand_label)


def build_node_map(
    nodes: Sequence[NodeSpec],
    pods_by_node: Mapping[str, Sequence[PodSpec]],
    *,
    on_demand_label: str,
    spot_label: str,
    priority_threshold: int = 0,
    unready_nodes: Sequence[NodeSpec] = (),
) -> NodeMap:
    """Classify and sort nodes; reference nodes/nodes.go:63-119 ``NewNodeMap``
    + ``newNodeInfo`` + ``getPodsOnNode``.

    Policy reproduced exactly:
    - pods with priority below ``priority_threshold`` are ignored **on spot
      nodes only** (they are presumed preemptible; nodes/nodes.go:137-141),
    - each node's pods sort biggest-CPU-request-first (nodes/nodes.go:76-80),
    - spot-before-on-demand classification precedence (the ``switch`` at
      nodes/nodes.go:82-92: a node carrying both labels lands in spot),
    - spot nodes sort most-requested-CPU-first, on-demand nodes
      least-requested-first (nodes/nodes.go:95-101) — empty the emptiest
      on-demand node onto the fullest spot nodes (README.md:136-149).
    """
    on_demand: List[NodeInfo] = []
    spot: List[NodeInfo] = []
    other: List[NodeInfo] = []

    for node in nodes:
        spot_node = is_spot_node(node, spot_label)
        pods = [
            p
            for p in pods_by_node.get(node.name, [])
            if not (spot_node and p.priority < priority_threshold)
        ]
        pods.sort(key=pod_cpu_requests, reverse=True)
        info = NodeInfo.build(node, pods)
        if spot_node:
            spot.append(info)
        elif is_on_demand_node(node, on_demand_label):
            on_demand.append(info)
        else:
            # Unclassified nodes are not planning surface (the reference
            # ignores them, nodes/nodes.go:90-91) but their pods are kept
            # visible for zone-wide anti-affinity presence (NodeMap.other).
            other.append(info)

    # Python's sort is stable, like Go's sort.Slice is not — but ties keep
    # input order here, which is deterministic for our packers.
    spot.sort(key=lambda n: n.requested_cpu, reverse=True)
    on_demand.sort(key=lambda n: n.requested_cpu)
    # not-ready nodes (any class): presence-only visibility, no planning
    unready = [
        NodeInfo.build(n, pods_by_node.get(n.name, []))
        for n in unready_nodes
    ]
    return NodeMap(on_demand=on_demand, spot=spot, other=other,
                   unready=unready)

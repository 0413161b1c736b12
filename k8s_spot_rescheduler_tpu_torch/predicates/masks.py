"""Vectorized scheduler predicates.

The reference asks the real kube-scheduler "would pod p fit on node n?" one
(pod, node) pair at a time through ``PredicateChecker.CheckPredicates``
(reference rescheduler.go:344; predicate list README.md:103-114: resource
fit, taints/tolerations, node readiness, affinity, ...). Here the same
questions are answered for *all* pairs at once from dense arrays:

- **resource fit** — elementwise ``free >= request`` over the resource axis
  plus a pod-count-vs-max-pods check;
- **taints/tolerations** — taints on spot nodes are interned into a global
  bit table; a node's taint bitmask AND NOT the pod's toleration bitmask
  must be zero. Only hard effects (NoSchedule/NoExecute) block placement;
  PreferNoSchedule is advisory and excluded from the table;
- **readiness/schedulability** — folded into a per-node validity bit
  (the reference only ever sees ready nodes via ``NewReadyNodeLister``,
  rescheduler.go:154, and the scheduler rejects cordoned nodes);
- **anti-affinity** — simplified hostname-topology groups, hashed onto a
  fixed 64-bit mask. Hash collisions can only *forbid* extra placements,
  never allow an invalid one — conservative in the safe direction (a plan
  we approve must never strand a pod; SURVEY.md §7 "hard parts" (e)).

All mask math is uint32 words so it runs identically under NumPy (oracle
solver) and jnp (TPU solver).
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import List, Sequence, Tuple

import numpy as np

from k8s_spot_rescheduler_tpu_torch.models.cluster import (
    NodeSpec,
    PodSpec,
    Taint,
    TO_BE_DELETED_TAINT,
)
from k8s_spot_rescheduler_tpu_torch.predicates.selectors import (
    selector_matches,
    term_key,
    term_matches,
)

HARD_EFFECTS = ("NoSchedule", "NoExecute")

# strconv.ParseInt(s, 10, 64)-compatible integer literal: optional sign
# (Go accepts '+' and '-'), ASCII digits only (\d would admit Unicode
# digits Go rejects), no '_' or whitespace; range-checked to int64 below.
_INT_RE = re.compile(r"[+-]?[0-9]+")
_INT64_MIN, _INT64_MAX = -(2**63), 2**63 - 1


def _parse_int64(s: str):
    """int(s) under Go strconv.ParseInt(s, 10, 64) rules; None on any
    input Go rejects (syntax or 64-bit range)."""
    if not _INT_RE.fullmatch(s):
        return None
    v = int(s)
    if not _INT64_MIN <= v <= _INT64_MAX:
        return None
    return v

# Anti-affinity groups hash onto 64 bits = 2 uint32 words.
AFFINITY_WORDS = 2
AFFINITY_BITS = 32 * AFFINITY_WORDS


@dataclasses.dataclass
class TaintTable:
    """Global interning of hard taints found on spot nodes."""

    taints: List[Taint]
    words: int  # number of uint32 words per mask

    def index(self, taint: Taint) -> int:
        return self.taints.index(taint)


def intern_taints(nodes: Sequence[NodeSpec]) -> TaintTable:
    """Collect distinct hard taints across ``nodes`` into a bit table.

    The actuator's drain taint (TO_BE_DELETED_TAINT, reference
    scaler/scaler.go:77) is always interned so a draining node never
    receives planned pods.
    """
    seen: dict = {}
    for node in nodes:
        for taint in node.taints:
            if taint.effect in HARD_EFFECTS and taint not in seen:
                seen[taint] = len(seen)
    drain = Taint(TO_BE_DELETED_TAINT, "", "NoSchedule")
    if drain not in seen:
        seen[drain] = len(seen)
    taints = list(seen)
    words = max(1, -(-len(taints) // 32))
    return TaintTable(taints=taints, words=words)


# --- pseudo-taints: nodeSelector and unmodeled constraints ---------------
#
# The kube-scheduler's NodeSelector/affinity/volume predicates don't fit
# the "node repels pod" shape of taints, but they DO fit the same bit
# algebra inverted: define a pseudo-taint per distinct nodeSelector
# (key, value) pair, set on every node that LACKS the label; a pod that
# requires the pair simply doesn't tolerate it. Constraints the framework
# can't express (required node-affinity expressions, PVC topology) become
# one "unplaceable" pseudo-taint set on every node that only the affected
# pod fails to tolerate. The payoff: full NodeSelector semantics and
# safe-direction conservatism for the rest, with ZERO changes to any
# solver or the Pallas kernel — they already AND these words.


@dataclasses.dataclass(frozen=True)
class SelectorBit:
    """Pseudo-taint for one required node label (key=value)."""

    key: str
    value: str


@dataclasses.dataclass(frozen=True)
class NodeAffinityBit:
    """Pseudo-taint for one distinct required node-affinity expression
    set (canonical terms: OR of ANDs of (key, op, values)). Set on every
    node that does NOT satisfy the requirement; only pods carrying
    exactly this requirement fail to tolerate it.

    This generalizes the SelectorBit trick: ANY pure node-property
    predicate collapses to one interned bit whose node side is evaluated
    on host at pack time — the solvers' bit algebra never changes.
    Replaces the reference's reliance on the real scheduler's
    node-affinity predicate (reference rescheduler.go:344; predicate
    list README.md:103-114)."""

    terms: Tuple  # ((key, op, (values...)), ...) per term, OR of terms


@dataclasses.dataclass(frozen=True)
class PodAffinityBit:
    """Pseudo-taint for one distinct required POSITIVE pod-affinity
    TERM (round-5 canonical shape, predicates/selectors.py: a
    namespaces scope + a full-operator selector; hostname topology).
    Set on every spot node that does NOT currently host a pod in the
    term's scope matched by its selector; only pods carrying this term
    fail to tolerate it — the inverted-taint encoding of "may only join
    a node with a match". A pod with several positive terms simply
    fails to tolerate several bits (every term must hold).

    Unlike every other pseudo-taint, the node side depends on the pods
    RESIDENT on the node this tick, not on node properties — so it is
    evaluated against the packers' per-tick resident view and excluded
    from any label-keyed node-mask caches. Conservative dynamics: the
    plan's own placements could only create additional matches, so
    counting pre-plan residents only can lose a drain but never approve
    a stranding one."""

    namespaces: Tuple  # sorted namespace scope of the term
    items: Tuple  # canonical selector requirements (key, op, values)


@dataclasses.dataclass(frozen=True)
class ZonePodAffinityBit:
    """Pseudo-taint for one required POSITIVE pod-affinity TERM with
    ZONE topology, per CARRIER CONTEXT: the sorted zones hosting a
    qualifying match this tick. Set on every spot node that lacks the
    zone label or whose zone is not in ``allowed_zones``; only the
    carrier fails to tolerate it. A carrier with several zone terms
    carries several context bits (every term must hold).

    Conservative in two deliberate ways: matches are counted from
    pre-plan COUNTED residents only (in-plan placements could only add
    matches — ignoring them loses a drain, never strands), and matches
    residing on the carrier's own candidate node are EXCLUDED from its
    context — they leave in the same drain, so a zone satisfied only by
    them would strand the carrier at reschedule time (the packers pass
    the exclusion; same per-carrier-context pattern as SpreadBit)."""

    namespaces: Tuple  # sorted namespace scope of the term
    items: Tuple  # canonical selector requirements
    allowed_zones: Tuple  # sorted zone values hosting a qualifying match


@dataclasses.dataclass(frozen=True)
class SpreadBit:
    """Pseudo-taint for one hard topologySpreadConstraint CARRIER
    CONTEXT: the set of topology domains a specific moving pod may not
    enter without exceeding its maxSkew, precomputed from this tick's
    per-domain match counts (``compute_spread_bit``). Set on every spot
    node that lacks the topology key (PodTopologySpread filters such
    nodes) or whose domain is in ``refused``; only the carrier fails to
    tolerate it.

    Like PodAffinityBit, the node side depends on per-tick cluster
    state (match counts), not node properties alone — the packers
    evaluate it outside any label-keyed cache. Two carriers whose
    contexts produce the same (topology_key, refused) verdict share one
    bit harmlessly. What static verdicts cannot prove is two in-plan
    movers involved with one spread identity (their placements shift
    each other's counts) — ``spread_lane_guard`` conservatively kills
    those lanes, exactly like the zone guard."""

    topology_key: str
    refused: Tuple  # sorted domain values the carrier may not enter


@dataclasses.dataclass(frozen=True)
class UnplaceableBit:
    """Pseudo-taint carried by every node; only pods with unmodeled
    constraints fail to tolerate it."""


def selector_universe(pods: Sequence[PodSpec]) -> List[Tuple[str, str]]:
    """Sorted distinct (key, value) pairs across the pods' nodeSelectors —
    the deterministic pseudo-taint universe both packers must share."""
    return sorted({(k, v) for p in pods for k, v in p.node_selector.items()})


def node_affinity_universe(pods: Sequence[PodSpec]) -> List[Tuple]:
    """Sorted distinct canonical required-node-affinity terms across the
    pods — the NodeAffinityBit universe both packers must share."""
    return sorted({p.node_affinity for p in pods if p.node_affinity})


def pod_affinity_universe(pods: Sequence[PodSpec]) -> List[Tuple]:
    """Sorted distinct positive-affinity TERMS across the pods — the
    PodAffinityBit universe both packers must share. A pod's own terms
    live directly in ``pod.pod_affinity_match`` (round-5 canonical
    form)."""
    return sorted({t for p in pods for t in p.pod_affinity_match})


def hosts_affinity_match(
    residents: Sequence[PodSpec], namespaces: Tuple, items: Tuple
) -> bool:
    """Does any resident pod fall in the term's namespace scope and
    match its selector? The node-side evaluation of PodAffinityBit."""
    return any(
        term_matches((namespaces, items), p.namespace, p.labels)
        for p in residents
    )


def match_expr(expr: Tuple, labels, node_name: str) -> bool:
    """One NodeSelectorRequirement against a node's labels — semantics of
    k8s.io/apimachinery labels.Requirement.Matches (NotIn/DoesNotExist
    match when the key is absent; Gt/Lt are base-10 integer compares).
    The reserved FieldIn/FieldNotIn operators are matchFields on
    ``metadata.name`` (io/kube.decode_node_affinity) and compare
    ``node_name``, never labels — a label literally named
    "metadata.name" cannot shadow the field."""
    key, op, values = expr
    if op == "FieldIn":
        return node_name in values
    if op == "FieldNotIn":
        return node_name not in values
    v = labels.get(key)
    if op == "In":
        return v is not None and v in values
    if op == "NotIn":
        return v is None or v not in values
    if op == "Exists":
        return v is not None
    if op == "DoesNotExist":
        return v is None
    if op in ("Gt", "Lt"):
        if v is None or len(values) != 1:
            return False
        # Exact strconv.ParseInt parity: Python's int() also accepts
        # '_', whitespace and arbitrary precision, which would deem a
        # node affinity-satisfying when the real scheduler rejects it —
        # the non-conservative direction.
        lv, rv = _parse_int64(v), _parse_int64(values[0])
        if lv is None or rv is None:
            return False
        return lv > rv if op == "Gt" else lv < rv
    return False


def match_node_affinity(terms: Tuple, labels, node_name: str) -> bool:
    """Required node-affinity: OR over terms, AND within a term (empty
    terms tuple = no constraint; decode drops empty terms, which k8s
    defines to match nothing)."""
    if not terms:
        return True
    return any(
        all(match_expr(e, labels, node_name) for e in term) for term in terms
    )


def intern_constraints(
    nodes: Sequence[NodeSpec],
    selector_pairs: Sequence[Tuple[str, str]],
    affinity_terms: Sequence[Tuple] = (),
    pod_affinity_keys: Sequence[Tuple] = (),
    spread_bits: Sequence["SpreadBit"] = (),
    zone_paff_bits: Sequence["ZonePodAffinityBit"] = (),
) -> TaintTable:
    """``intern_taints`` plus the pseudo-taint tail: selector pairs (in
    the given sorted order), node-affinity requirement bits, positive
    pod-affinity bits, spread-verdict bits, zone-pod-affinity verdict
    bits, and the always-present unplaceable bit."""
    base = intern_taints(nodes)
    taints = list(base.taints)
    taints.extend(SelectorBit(k, v) for k, v in selector_pairs)
    taints.extend(NodeAffinityBit(t) for t in affinity_terms)
    taints.extend(PodAffinityBit(ns, items) for ns, items in pod_affinity_keys)
    taints.extend(spread_bits)
    taints.extend(zone_paff_bits)
    taints.append(UnplaceableBit())
    words = max(1, -(-len(taints) // 32))
    return TaintTable(taints=taints, words=words)


def node_constraint_mask(
    node: NodeSpec, table: TaintTable, residents: Sequence[PodSpec] = ()
) -> np.ndarray:
    """Node-side bits: real hard taints + selector pairs the node lacks +
    affinity requirements the node fails + positive pod-affinity
    selectors no resident matches + the unplaceable bit (always set).
    ``residents`` is the node's model-visible pods this tick (only read
    by PodAffinityBit entries)."""
    mask = np.zeros(table.words, dtype=np.uint32)
    for i, entry in enumerate(table.taints):
        if isinstance(entry, Taint):
            continue  # real taints handled below via the node's own list
        if isinstance(entry, SelectorBit):
            if node.labels.get(entry.key) != entry.value:
                mask[i // 32] |= np.uint32(1 << (i % 32))
        elif isinstance(entry, NodeAffinityBit):
            if not match_node_affinity(entry.terms, node.labels, node.name):
                mask[i // 32] |= np.uint32(1 << (i % 32))
        elif isinstance(entry, PodAffinityBit):
            if not hosts_affinity_match(
                residents, entry.namespaces, entry.items
            ):
                mask[i // 32] |= np.uint32(1 << (i % 32))
        elif isinstance(entry, SpreadBit):
            domain = node.labels.get(entry.topology_key)
            if domain is None or domain in entry.refused:
                mask[i // 32] |= np.uint32(1 << (i % 32))
        elif isinstance(entry, ZonePodAffinityBit):
            zone = node.labels.get(ZONE_LABEL)
            if zone is None or zone not in entry.allowed_zones:
                mask[i // 32] |= np.uint32(1 << (i % 32))
        else:  # UnplaceableBit
            mask[i // 32] |= np.uint32(1 << (i % 32))
    return mask | taint_mask(node.taints, table)


def constraint_mask(
    tolerations: Sequence,
    node_selector,
    unmodeled: bool,
    table: TaintTable,
    node_affinity: Tuple = (),
    pod_affinity: Tuple = (),
    spread_bits: frozenset = frozenset(),
    zone_paff_bits: frozenset = frozenset(),
) -> np.ndarray:
    """Pod-side bits: tolerated real taints + selector pairs the pod does
    NOT require + affinity requirements that are not the pod's own + the
    unplaceable bit unless the pod carries unmodeled constraints.
    ``pod_affinity`` is the pod's own tuple of positive-affinity TERMS
    (``pod.pod_affinity_match``; every term must hold, so the pod fails
    to tolerate each of its terms' bits); ``spread_bits`` the pod's own
    SpreadBit contexts and ``zone_paff_bits`` its own ZonePodAffinityBit
    contexts (every other pod tolerates them)."""
    mask = np.zeros(table.words, dtype=np.uint32)
    for i, entry in enumerate(table.taints):
        if isinstance(entry, Taint):
            ok = any(tol.tolerates(entry) for tol in tolerations)
        elif isinstance(entry, SelectorBit):
            ok = node_selector.get(entry.key) != entry.value
        elif isinstance(entry, NodeAffinityBit):
            ok = entry.terms != node_affinity
        elif isinstance(entry, PodAffinityBit):
            ok = (entry.namespaces, entry.items) not in pod_affinity
        elif isinstance(entry, SpreadBit):
            ok = entry not in spread_bits
        elif isinstance(entry, ZonePodAffinityBit):
            ok = entry not in zone_paff_bits
        else:  # UnplaceableBit
            ok = not unmodeled
        if ok:
            mask[i // 32] |= np.uint32(1 << (i % 32))
    return mask


def taint_mask(taints: Sequence[Taint], table: TaintTable) -> np.ndarray:
    """Bitmask of the hard taints present in ``taints``."""
    mask = np.zeros(table.words, dtype=np.uint32)
    for taint in taints:
        if taint.effect in HARD_EFFECTS:
            i = table.index(taint)
            mask[i // 32] |= np.uint32(1 << (i % 32))
    return mask


def node_taint_mask(node: NodeSpec, table: TaintTable) -> np.ndarray:
    return taint_mask(node.taints, table)


def toleration_mask(tolerations: Sequence, table: TaintTable) -> np.ndarray:
    """Bit t set iff ``tolerations`` tolerate interned taint t."""
    mask = np.zeros(table.words, dtype=np.uint32)
    for i, taint in enumerate(table.taints):
        if any(tol.tolerates(taint) for tol in tolerations):
            mask[i // 32] |= np.uint32(1 << (i % 32))
    return mask


def pod_toleration_mask(pod: PodSpec, table: TaintTable) -> np.ndarray:
    """Bit t set iff the pod tolerates interned taint t."""
    return toleration_mask(pod.tolerations, table)


def affinity_bits(group: str) -> Tuple[int, int]:
    """(word, bit) for an anti-affinity group name (stable hash)."""
    h = int.from_bytes(hashlib.blake2b(group.encode(), digest_size=8).digest(), "little")
    b = h % AFFINITY_BITS
    return b // 32, b % 32


def pod_affinity_mask(pod: PodSpec) -> np.ndarray:
    mask = np.zeros(AFFINITY_WORDS, dtype=np.uint32)
    if pod.anti_affinity_group:
        w, b = affinity_bits(pod.anti_affinity_group)
        mask[w] |= np.uint32(1 << b)
    return mask


def node_affinity_mask(pods: Sequence[PodSpec]) -> np.ndarray:
    """Groups already present on a node (union of its pods' masks)."""
    mask = np.zeros(AFFINITY_WORDS, dtype=np.uint32)
    for pod in pods:
        mask |= pod_affinity_mask(pod)
    return mask


# --- selector-based hostname anti-affinity (the k8s spread pattern) ------
#
# A pod carrying anti-affinity TERMS refuses nodes hosting pods matched
# by any term (within the term's namespace scope), and matched pods
# symmetrically refuse nodes hosting it (what the real scheduler
# enforces for existing pods' required anti-affinity). Encoding: hash
# each distinct term (namespaces + canonical selector) to a bit; a pod's
# affinity mask is its own terms' bits (requirements) OR'd with the bit
# of every universe term that MATCHES the pod (presence). Since the
# same mask is both the fit check and the placement contribution, any
# requirement/presence overlap between two pods forbids co-location —
# exactly the scheduler's symmetric check, over-restricting only in one
# corner (two plain pods both merely *matched* by some third selector,
# or two carriers of one term neither of which matches it), which is
# the safe direction: collisions can only lose a drain, never strand a
# pod.


def match_selector_key(term: Tuple) -> str:
    """Deterministic hash key for a hostname-family term."""
    return term_key(term)


def collect_match_universe(pods) -> List[Tuple]:
    """Sorted distinct hostname anti-affinity terms across the pods —
    deterministic, shared by both packers."""
    return sorted({t for p in pods for t in p.anti_affinity_match})


def match_affinity_mask(
    own_terms: Tuple,
    namespace: str,
    labels,
    universe: Sequence[Tuple],
) -> np.ndarray:
    """Requirement bits (own terms) | presence bits (universe terms
    whose scope covers ``namespace`` and whose selector matches
    ``labels``)."""
    mask = np.zeros(AFFINITY_WORDS, dtype=np.uint32)
    for term in own_terms:
        w, b = affinity_bits(match_selector_key(term))
        mask[w] |= np.uint32(1 << b)
    for term in universe:
        if term_matches(term, namespace, labels):
            w, b = affinity_bits(match_selector_key(term))
            mask[w] |= np.uint32(1 << b)
    return mask


MERGE_TERM_CAP = 16


def merge_affinity_terms(*term_sets: Tuple):
    """AND several canonical required-affinity term sets (each an OR of
    AND-terms) into one canonical OR-of-ANDs, by distribution:
    (A1|A2) & (B1|B2) = A1B1 | A1B2 | A2B1 | A2B2. Used to fold bound
    PersistentVolumes' nodeAffinity into a pod's own requirement
    (models/volumes.py) so the result flows through the existing
    NodeAffinityBit machinery unchanged.

    An empty set means "no constraint" (identity). Returns None when the
    distributed product exceeds MERGE_TERM_CAP terms — the caller treats
    the pod as conservatively unmodeled rather than interning a huge
    requirement."""
    merged: Tuple = ()
    for terms in term_sets:
        if not terms:
            continue
        if not merged:
            merged = terms
            continue
        if len(merged) * len(terms) > MERGE_TERM_CAP:
            return None
        merged = tuple(
            sorted(
                {
                    tuple(sorted(set(a) | set(b)))
                    for a in merged
                    for b in terms
                }
            )
        )
    return merged


# --- zone-topology anti-affinity (static, zone-salted group bits) ---------
#
# Required anti-affinity with topologyKey=topology.kubernetes.io/zone uses
# the SAME requirement|presence hashing as the hostname machinery above,
# but with a zone salt in the key and zone-wide node-side aggregation: a
# spot node's affinity word ORs in the zone masks of every counted pod in
# its entire ZONE — spanning all ready nodes of ANY class, including
# unclassified ones (NodeMap.other / columnar _OTHER): a requirer on a
# control-plane node still repels zone-wide — so a requirer refuses zones hosting a
# match and a matched pod refuses zones hosting a requirer — the
# scheduler's symmetric semantics, statically per tick. What static bits
# CANNOT prove safe is two zone-involved pods inside one candidate lane
# (their in-plan placements could collide zone-wide); the packers mark
# those pods unplaceable (see lane guard in models/tensors.py /
# models/columnar.py). Hash collisions only ever forbid placements — the
# safe direction.

ZONE_LABEL = "topology.kubernetes.io/zone"


def zone_selector_key(term: Tuple) -> str:
    """Hash key for a zone-family term. The \\x1d prefix keeps the zone
    keyspace disjoint from hostname keys (a term_key always starts with
    a namespace name, never a separator byte)."""
    return "\x1dzone" + term_key(term)


def collect_zone_universe(pods) -> List[Tuple]:
    """Sorted distinct zone anti-affinity terms across the pods —
    deterministic, shared by both packers."""
    return sorted({t for p in pods for t in p.anti_affinity_zone_match})


def zone_match_affinity_mask(
    own_terms: Tuple,
    namespace: str,
    labels,
    universe: Sequence[Tuple],
) -> np.ndarray:
    """Requirement bits (own zone terms) | presence bits (universe zone
    terms matching this pod) — the zone-family analog of
    ``match_affinity_mask``."""
    mask = np.zeros(AFFINITY_WORDS, dtype=np.uint32)
    for term in own_terms:
        w, b = affinity_bits(zone_selector_key(term))
        mask[w] |= np.uint32(1 << b)
    for term in universe:
        if term_matches(term, namespace, labels):
            w, b = affinity_bits(zone_selector_key(term))
            mask[w] |= np.uint32(1 << b)
    return mask


def zone_lane_guard(pods: Sequence[PodSpec]) -> set:
    """Slot indices (within one candidate lane) to mark unplaceable.

    For each zone TERM carried by a lane pod: if two or more lane pods
    are involved with it (carry it, or are in its scope and matched by
    its selector), their in-plan placements could collide zone-wide in
    ways the static zone bits cannot see — mark every involved pod,
    which conservatively fails the lane. A single involved pod per term
    is fully covered by the static bits. Shared by both packers so the
    decision is bit-identical."""
    carried: dict = {}
    for i, p in enumerate(pods):
        for term in p.anti_affinity_zone_match:
            carried.setdefault(term, set()).add(i)
    out: set = set()
    for term, involved in carried.items():
        involved = set(involved)
        for i, p in enumerate(pods):
            if term_matches(term, p.namespace, p.labels):
                involved.add(i)
        if len(involved) >= 2:
            out |= involved
    return out


# --- hard topologySpreadConstraints (per-carrier static verdicts) ---------
#
# A hard (DoNotSchedule) spread constraint bounds, for the pod CARRYING
# it at ITS schedule time, the per-domain count of selector-matched pods:
# placing p in domain d must keep count(d) - min-over-domains <= maxSkew.
# Unlike anti-affinity there is no symmetric direction — resident
# carriers never repel incoming pods — so only MOVING carriers need
# modeling. The verdict is computed statically per tick per carrier
# (compute_spread_bit) and interned as a SpreadBit pseudo-taint:
#
# - counts tally selector matches over every model-visible pod (counted
#   pods of both classes + pods on unclassified-ready and NOT-READY
#   nodes — kube-scheduler's default nodeTaintsPolicy=Ignore counts
#   dead nodes' domains and pods), keyed by the node's topology-key
#   value; nodes lacking the key contribute nothing and admit nothing
#   (PodTopologySpread filters them);
# - domains span every visible node's key value, INCLUDING zero-count
#   domains — the min is what makes skew bite;
# - the carrier's own departure is exact: if p itself matches its
#   selector, its source domain's count drops by one, which can lower
#   the global min (stricter) and lowers its own domain's bar by one
#   (the "d == own" offset);
# - domain-eligibility filtering the real scheduler applies
#   (nodeAffinityPolicy=Honor) is deliberately ignored: a min over MORE
#   domains is never larger, so the verdict is only ever stricter —
#   the safe direction. Below-threshold spot pods are invisible here
#   exactly as they are to the reference's own snapshot
#   (nodes/nodes.go:137-141: presumed preemptible).
#
# What the static verdict cannot see is in-plan interaction: a second
# mover involved with the same identity (carrying it or matched by its
# selector) shifts counts mid-plan — spread_lane_guard marks all
# involved slots unplaceable, conservatively failing the lane.


def spread_self_match(pod: PodSpec, items: Tuple) -> bool:
    """Does the carrier match its own selector (Deployment spread does)?
    Only then does its move shift the counts its verdict depends on.
    ``items`` is a canonical requirement selector (round 5 widened to
    the full operator surface)."""
    return selector_matches(items, pod.labels)


def compute_spread_bit(
    topology_key: str,
    max_skew: int,
    own_domain,
    counts,
    all_domains,
    self_match: bool,
) -> "SpreadBit":
    """The refused-domain verdict for one carrier context.

    ``counts``: matching-pod tally per domain (zero-count domains may be
    absent); ``all_domains``: every topology-key value among visible
    ready nodes; ``own_domain``: the carrier's current domain (None when
    its node lacks the key); ``self_match``: does the carrier match its
    own selector (kube-scheduler's selfMatchNum — only then does its
    own move shift counts, and only then does its arrival count).
    Refused(d) ⇔ counts_excl(d) + selfMatch - min_excl > maxSkew, with
    counts_excl the tally after the carrier's departure (kube-scheduler
    computes the same check over existing pods at the re-schedule
    instant, when the carrier has already left its node). No domains at
    all ⇒ nothing to enumerate; keyless nodes are always refused by the
    node-side rule."""
    full = {d: int(counts.get(d, 0)) for d in all_domains}
    if self_match and own_domain is not None and own_domain in full:
        full = {
            d: v - (1 if d == own_domain else 0) for d, v in full.items()
        }
    if not full:
        return SpreadBit(topology_key=topology_key, refused=())
    limit = min(full.values()) + max_skew - (1 if self_match else 0)
    return SpreadBit(
        topology_key=topology_key,
        refused=tuple(sorted(d for d, v in full.items() if v > limit)),
    )


def spread_lane_guard(pods: Sequence[PodSpec]) -> set:
    """Slot indices (within one candidate lane) to mark unplaceable:
    for each spread selector identity carried by a lane pod, if two or
    more lane pods are involved with it (carry it, or are matched by
    it), their in-plan placements shift each other's domain counts in
    ways the static verdicts cannot see. Same shape as
    ``zone_lane_guard``; shared by both packers so the decision is
    bit-identical."""
    carried: dict = {}
    for i, p in enumerate(pods):
        for _, _, items in p.spread_constraints:
            carried.setdefault((p.namespace, items), set()).add(i)
    out: set = set()
    for (ns, items), involved in carried.items():
        involved = set(involved)
        for i, p in enumerate(pods):
            if p.namespace == ns and selector_matches(items, p.labels):
                involved.add(i)
        if len(involved) >= 2:
            out |= involved
    return out


def fit_mask(
    xp,
    *,
    free,  # [..., S, R] remaining capacity
    count,  # [..., S] current pod count
    max_pods,  # [S]
    node_taints,  # [S, W] uint32
    node_ok,  # [S] bool (ready, schedulable, non-padding)
    node_aff,  # [..., S, A] uint32 groups present
    req,  # [..., R] pod request
    tol,  # [..., W] uint32 pod tolerations
    aff,  # [..., A] uint32 pod group mask
):
    """The full per-(pod, spot-node) admissibility mask.

    ``xp`` is ``numpy`` or ``jax.numpy`` — the oracle and the TPU solver
    share this exact predicate definition, which is what the parity tests
    lean on. Leading batch dims of ``free``/``count``/``node_aff`` and of
    the pod operands must broadcast against each other.
    """
    res_ok = xp.all(free >= req[..., None, :], axis=-1)  # [..., S]
    cnt_ok = count < max_pods
    taint_ok = xp.all((node_taints & ~tol[..., None, :]) == 0, axis=-1)
    aff_ok = xp.all((node_aff & aff[..., None, :]) == 0, axis=-1)
    return res_ok & cnt_ok & taint_ok & aff_ok & node_ok


def fit_mask_t(
    xp,
    *,
    free_t,  # [..., R, S] remaining capacity, S minor
    count,  # [..., S]
    max_pods,  # [S]
    node_taints_t,  # [W, S] uint32
    node_ok,  # [S] bool
    node_aff_t,  # [..., A, S] uint32
    req,  # [..., R]
    tol,  # [..., W]
    aff,  # [..., A]
):
    """``fit_mask`` with the spot axis minor.

    Device solvers keep their big carries as [..., R, S]/[..., A, S]: on
    TPU the minor dimension is tiled to 128 lanes, so a minor axis of
    R=2 would pad 64x in HBM (observed: a [C, S, 2] carry ballooned to
    12.5 GB). Semantics are identical to ``fit_mask`` — the randomized
    oracle-parity suites pin the two together.
    """
    res_ok = xp.all(free_t >= req[..., :, None], axis=-2)  # [..., S]
    cnt_ok = count < max_pods
    taint_ok = xp.all((node_taints_t & ~tol[..., :, None]) == 0, axis=-2)
    aff_ok = xp.all((node_aff_t & aff[..., :, None]) == 0, axis=-2)
    return res_ok & cnt_ok & taint_ok & aff_ok & node_ok

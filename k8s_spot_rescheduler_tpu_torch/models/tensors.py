"""The static-shape planning problem, as numpy on the host and as torch
tensors on the device.

``PackedCluster`` copies the 11-field contract of the JAX package's
``models/tensors.PackedCluster``: C candidate lanes, K pod slots, S spot
nodes, R resources, W taint words, A affinity words.

- host form (numpy, what a pack produces): ``slot_req`` f32 [C, K, R],
  ``slot_valid`` bool [C, K], ``slot_tol`` u32 [C, K, W], ``slot_aff``
  u32 [C, K, A], ``cand_valid`` bool [C], ``spot_free`` f32 [S, R],
  ``spot_count`` i32 [S], ``spot_max_pods`` i32 [S], ``spot_taints`` u32
  [S, W], ``spot_ok`` bool [S], ``spot_aff`` u32 [S, A];
- device form (torch): the same shapes, with the three kinds of uint32
  words held as **int32 bit patterns** (``.view(np.int32)``). Torch's
  uint32 has no ``~`` and no ``amax`` on the CPU; ``&``, ``|``, ``~``
  and ``== 0`` on the int32 view give the same bits.

``to_device`` and ``to_numpy`` carry a pack across without losing a bit;
``save_npz`` and ``load_npz`` freeze one to disk.

``pack_cluster`` is the host pack path, copied from the JAX package's
``models/tensors.py`` with ``PackMeta``: a classified ``NodeMap``
becomes the static-shape problem, and ``PackMeta`` maps tensor indices
back to cluster objects. Every candidate on-demand node becomes an
independent lane over the same initial spot-pool tensors (the
reference's per-candidate ``Fork``/``Revert``, rescheduler.go:269-275);
slots are each candidate's evictable pods in placement order, spots the
spot nodes in first-fit probe order. Requests are ceil-scaled and
allocatable floor-scaled into units below 2**24 (exact in float32):
memory in MiB, CPU in millicores, rounding in the safe direction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from k8s_spot_rescheduler_tpu_torch.device import resolve_device
from k8s_spot_rescheduler_tpu_torch.models.cluster import (
    NodeInfo,
    NodeMap,
    PDBSpec,
    PodSpec,
)
from k8s_spot_rescheduler_tpu_torch.models.evictability import (
    BlockingPod,
    get_pods_for_deletion,
)
from k8s_spot_rescheduler_tpu_torch.predicates.masks import (
    AFFINITY_WORDS,
    TaintTable,
    collect_match_universe,
    compute_spread_bit,
    constraint_mask,
    intern_constraints,
    match_affinity_mask,
    node_affinity_universe,
    node_constraint_mask,
    pod_affinity_mask,
    pod_affinity_universe,
    selector_universe,
    spread_lane_guard,
    spread_self_match,
    ZONE_LABEL,
    collect_zone_universe,
    zone_lane_guard,
    zone_match_affinity_mask,
)
from k8s_spot_rescheduler_tpu_torch.predicates.selectors import (
    selector_matches,
    term_matches,
)


# Scale divisor per resource so packed values stay < 2**24 (float32-exact).
RESOURCE_SCALE: Dict[str, int] = {
    "cpu": 1,  # millicores
    "memory": 1 << 20,  # bytes -> MiB
    "ephemeral-storage": 1 << 20,
    "pods": 1,
}

DEFAULT_MAX_PODS = 110  # k8s kubelet default when a node publishes no cap


def _ceil_div(v: int, d: int) -> int:
    return -(-int(v) // d)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_dim(n: int) -> int:
    """The JAX package's padding, kept so packs stay bit-identical to its
    own: multiples of 8 below 128, multiples of 128 above."""
    if n <= 0:
        return 8
    if n < 128:
        return _round_up(n, 8)
    return _round_up(n, 128)


class PackedCluster(NamedTuple):
    """The problem tensors (numpy on the host, torch on the device)."""

    # candidate pod slots
    slot_req: object  # f32 [C, K, R]
    slot_valid: object  # bool [C, K]
    slot_tol: object  # u32 (host) / i32 bits (device) [C, K, W]
    slot_aff: object  # u32 (host) / i32 bits (device) [C, K, A]
    cand_valid: object  # bool [C]
    # spot pool
    spot_free: object  # f32 [S, R]
    spot_count: object  # i32 [S]
    spot_max_pods: object  # i32 [S]
    spot_taints: object  # u32 (host) / i32 bits (device) [S, W]
    spot_ok: object  # bool [S]
    spot_aff: object  # u32 (host) / i32 bits (device) [S, A]


# host dtype of every field; the WORD_FIELDS travel as int32 bits
HOST_DTYPES = {
    "slot_req": np.float32,
    "slot_valid": np.bool_,
    "slot_tol": np.uint32,
    "slot_aff": np.uint32,
    "cand_valid": np.bool_,
    "spot_free": np.float32,
    "spot_count": np.int32,
    "spot_max_pods": np.int32,
    "spot_taints": np.uint32,
    "spot_ok": np.bool_,
    "spot_aff": np.uint32,
}
WORD_FIELDS = ("slot_tol", "slot_aff", "spot_taints", "spot_aff")


def host_array(name: str, arr) -> np.ndarray:
    """``arr`` as the contiguous device-ready numpy array of field
    ``name``: the host dtype, with words reinterpreted as int32 bits."""
    out = np.ascontiguousarray(np.asarray(arr, HOST_DTYPES[name]))
    if name in WORD_FIELDS:
        out = out.view(np.int32)
    return out


def to_device(packed, device=None) -> PackedCluster:
    """A host PackedCluster (numpy) as torch tensors on ``device``
    (default ``cuda``; a CUDA request without a card raises). Always a
    copy: on the CPU too, the tensors never alias the numpy arrays, so
    writing into them in place leaves the host pack as it was."""
    dev = resolve_device(device)
    return PackedCluster(
        *(
            torch.from_numpy(host_array(f, getattr(packed, f))).to(
                dev, copy=True
            )
            for f in PackedCluster._fields
        )
    )


def to_numpy(packed) -> PackedCluster:
    """A device PackedCluster back in host form (uint32 words)."""
    out = []
    for f in PackedCluster._fields:
        arr = getattr(packed, f).detach().cpu().numpy()
        if f in WORD_FIELDS:
            arr = arr.view(np.uint32)
        out.append(arr)
    return PackedCluster(*out)


def save_npz(path: str, packed, **extra) -> None:
    """Write a host PackedCluster (and ``extra`` arrays) compressed."""
    np.savez_compressed(
        path,
        **{f: np.asarray(getattr(packed, f)) for f in PackedCluster._fields},
        **extra,
    )


def load_npz(path: str):
    """(host PackedCluster, dict of the other arrays in the file)."""
    with np.load(path) as z:
        packed = PackedCluster(
            *(
                np.asarray(z[f], HOST_DTYPES[f])
                for f in PackedCluster._fields
            )
        )
        extra = {k: z[k] for k in z.files if k not in PackedCluster._fields}
    return packed, extra


def tenant_slice(stacked, t: int) -> PackedCluster:
    """Tenant ``t`` of T problems stacked along a leading axis (numpy or
    torch; a view, not a copy)."""
    return PackedCluster(*(f[t] for f in stacked))


def shapes(packed):
    """(C, K, S, R, W, A) of a PackedCluster in either form."""
    C, K, R = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    return C, K, S, R, packed.spot_taints.shape[1], packed.spot_aff.shape[1]


@dataclasses.dataclass
class PackMeta:
    """Host-side mapping from tensor indices back to cluster objects.

    Shares a planner-facing surface (``n_candidates`` / ``blocking_pods``
    / ``build_plan``) with ``models/columnar.ColumnarMeta``.
    """

    candidates: List[NodeInfo]  # index = candidate lane (unpadded prefix)
    cand_pods: List[List[PodSpec]]  # per lane, slot order
    blocking: List[Optional[BlockingPod]]
    spot: List[NodeInfo]  # index = spot lane (unpadded prefix)
    taint_table: TaintTable
    resources: Sequence[str]

    @property
    def n_candidates(self) -> int:
        return len(self.candidates)

    def blocking_pods(self) -> List[BlockingPod]:
        return [b for b in self.blocking if b is not None]

    def unmodeled_candidate_mask(self) -> np.ndarray:
        """bool [n_candidates]: lane carries >=1 unmodeled-constraint pod
        (packed as placeable-nowhere -> the lane can never prove)."""
        return np.array(
            [any(p.unmodeled_constraints for p in pods) for pods in self.cand_pods],
            bool,
        )

    def unplaceable_pod_count(self) -> int:
        return sum(
            1
            for pods in self.cand_pods
            for p in pods
            if p.unmodeled_constraints
        )

    def build_plan(self, c: int, row: np.ndarray):
        from k8s_spot_rescheduler_tpu_torch.planner.base import DrainPlan

        pods = self.cand_pods[c]
        assignments = {
            pod.uid: self.spot[int(row[k])].node.name
            for k, pod in enumerate(pods)
        }
        return DrainPlan(
            node=self.candidates[c],
            pods=list(pods),
            assignments=assignments,
            candidate_index=c,
        )


def scale_allocatable(alloc: Dict[str, int], resources: Sequence[str]) -> np.ndarray:
    # A node that publishes no pods cap gets the kubelet default, matching
    # the spot_max_pods predicate — not 0, which would make nothing fit.
    return np.array(
        [
            int(alloc.get(r, DEFAULT_MAX_PODS if r == "pods" else 0))
            // RESOURCE_SCALE.get(r, 1)
            for r in resources
        ],
        dtype=np.float32,
    )


def _build_spread_bits(node_map, candidates, cand_pods) -> Dict:
    """(lane, slot) -> frozenset of SpreadBit for hard-spread carriers.

    The static verdict machinery of predicates/masks.py: per carrier
    context, the refused-domain set from this tick's per-domain match
    counts. Counts and domains span every model-visible node — both
    classes, unclassified ready nodes (NodeMap.other), AND not-ready
    nodes of any class (NodeMap.unready: kube-scheduler's default
    nodeTaintsPolicy=Ignore counts their domains and pods, and an
    unseen low-count domain would overstate the min — the permissive
    direction); spot residents below the priority threshold are
    invisible exactly as they are to the reference's own snapshot
    (nodes/nodes.go:137-141). Replaces the reference's delegation to
    the PodTopologySpread plugin inside CheckPredicates
    (rescheduler.go:344; README.md:103-114)."""
    if not any(p.spread_constraints for pods in cand_pods for p in pods):
        return {}
    infos = (
        list(node_map.on_demand) + list(node_map.spot)
        + list(node_map.other) + list(node_map.unready)
    )
    domain_cache: Dict = {}
    count_cache: Dict = {}
    bit_cache: Dict = {}

    def all_domains(topo):
        doms = domain_cache.get(topo)
        if doms is None:
            doms = domain_cache[topo] = sorted(
                {
                    info.node.labels[topo]
                    for info in infos
                    if topo in info.node.labels
                }
            )
        return doms

    def counts_for(ns, topo, items):
        key = (ns, topo, items)
        c = count_cache.get(key)
        if c is None:
            c = count_cache[key] = {}
            for info in infos:
                d = info.node.labels.get(topo)
                if d is None:
                    continue
                for p in info.pods:
                    if p.namespace == ns and selector_matches(
                        items, p.labels
                    ):
                        c[d] = c.get(d, 0) + 1
        return c

    out: Dict = {}
    for c, (info, pods) in enumerate(zip(candidates, cand_pods)):
        for k, p in enumerate(pods):
            if not p.spread_constraints:
                continue
            bits = []
            for topo, skew, items in p.spread_constraints:
                self_m = spread_self_match(p, items)
                own = info.node.labels.get(topo)
                bkey = (p.namespace, topo, skew, items, own, self_m)
                bit = bit_cache.get(bkey)
                if bit is None:
                    bit = bit_cache[bkey] = compute_spread_bit(
                        topo,
                        skew,
                        own,
                        counts_for(p.namespace, topo, items),
                        all_domains(topo),
                        self_m,
                    )
                bits.append(bit)
            out[(c, k)] = frozenset(bits)
    return out


def _build_zone_paff_bits(candidates, spot, cand_pods) -> Dict:
    """(lane, slot) -> frozenset of ZonePodAffinityBit for
    zone-positive-affinity carriers (one bit per carried TERM — every
    term must hold). Allowed zones = zones of COUNTED residents (both
    classes, post priority filter) in the term's scope matching its
    selector, EXCLUDING residents of the lane's own candidate node —
    those leave in the same drain, and a zone satisfied only by them
    would strand the carrier at reschedule time. In-plan placements
    could only add matches (ignoring them loses a drain, never
    strands)."""
    if not any(
        p.pod_affinity_zone_match for pods in cand_pods for p in pods
    ):
        return {}
    from k8s_spot_rescheduler_tpu_torch.predicates.masks import ZonePodAffinityBit

    infos = list(candidates) + list(spot)
    hits_cache: Dict = {}

    def zone_hits(term):
        cached = hits_cache.get(term)
        if cached is not None:
            return cached
        per_zone: Dict[str, int] = {}
        per_info: Dict[int, int] = {}
        for idx, info in enumerate(infos):
            zone = info.node.labels.get(ZONE_LABEL)
            n = sum(
                1
                for q in info.pods
                if term_matches(term, q.namespace, q.labels)
            )
            per_info[idx] = n
            if zone is not None and n:
                per_zone[zone] = per_zone.get(zone, 0) + n
        cached = hits_cache[term] = (per_zone, per_info)
        return cached

    out: Dict = {}
    for c, (info, pods) in enumerate(zip(candidates, cand_pods)):
        for k, p in enumerate(pods):
            if not p.pod_affinity_zone_match:
                continue
            bits = []
            for term in p.pod_affinity_zone_match:
                per_zone, per_info = zone_hits(term)
                own_zone = info.node.labels.get(ZONE_LABEL)
                own_hits = per_info.get(c, 0)
                allowed = tuple(sorted(
                    z for z, n in per_zone.items()
                    if n - (own_hits if z == own_zone else 0) > 0
                ))
                bits.append(ZonePodAffinityBit(
                    namespaces=term[0], items=term[1], allowed_zones=allowed
                ))
            out[(c, k)] = frozenset(bits)
    return out


def pack_cluster(
    node_map: NodeMap,
    pdbs: Sequence[PDBSpec] = (),
    *,
    resources: Sequence[str] = ("cpu", "memory"),
    delete_non_replicated: bool = False,
    pad_candidates: int = 0,
    pad_spot: int = 0,
    pad_slots: int = 0,
) -> tuple[PackedCluster, PackMeta]:
    """Pack a classified node map into the solver problem.

    The evictability filter runs here, per candidate, exactly as the control
    loop does per node (reference rescheduler.go:231-256): a blocking pod or
    an empty evictable set invalidates the candidate lane (it is skipped,
    not drained). Explicit ``pad_*`` floors let callers keep shapes constant
    across ticks to avoid recompilation (streaming replay).
    """
    candidates = node_map.on_demand
    spot = node_map.spot

    cand_pods: List[List[PodSpec]] = []
    blocking: List[Optional[BlockingPod]] = []
    for info in candidates:
        pods, blocked = get_pods_for_deletion(
            info.pods, pdbs, delete_non_replicated=delete_non_replicated
        )
        cand_pods.append(pods if not blocked else [])
        blocking.append(blocked)

    # constraint table: the spot pool's hard taints + pseudo-taints for
    # the slot pods' nodeSelector pairs, required node-affinity
    # expressions, spread verdicts, and unmodeled constraints
    slot_pods_flat = [p for pods in cand_pods for p in pods]
    spread_bits_by = _build_spread_bits(
        node_map, candidates, cand_pods
    )  # (lane, slot) -> frozenset(SpreadBit)
    spread_universe = sorted(
        {b for bits in spread_bits_by.values() for b in bits},
        key=lambda b: (b.topology_key, b.refused),
    )
    zone_paff_by = _build_zone_paff_bits(
        candidates, spot, cand_pods
    )  # (lane, slot) -> frozenset(ZonePodAffinityBit)
    zone_paff_universe = sorted(
        {b for bits in zone_paff_by.values() for b in bits},
        key=lambda b: (b.namespaces, b.items, b.allowed_zones),
    )
    table = intern_constraints(
        [n.node for n in spot],
        selector_universe(slot_pods_flat),
        node_affinity_universe(slot_pods_flat),
        pod_affinity_universe(slot_pods_flat),
        spread_universe,
        zone_paff_universe,
    )
    # anti-affinity selector universes span every counted pod (resident
    # pods repel incoming matches and vice versa; zone identities reach
    # across node classes because zones do). The ZONE family additionally
    # spans pods on unclassified ready nodes (NodeMap.other) AND on
    # not-ready nodes of any class (NodeMap.unready): a requirer or
    # match resident there still repels zone-wide in the real scheduler,
    # and missing it would approve a drain whose pod then strands.
    # Hostname-family presence stays scoped to candidates+spot — we
    # never place onto those nodes, so their residents cannot create
    # per-node conflicts.
    presence_extra = list(node_map.other) + list(node_map.unready)
    counted_pods = [p for info in candidates for p in info.pods] + [
        p for info in spot for p in info.pods
    ]
    zone_pods = counted_pods + [
        p for info in presence_extra for p in info.pods
    ]
    match_universe = collect_match_universe(counted_pods)
    zone_universe = collect_zone_universe(zone_pods)
    W, A, R = table.words, AFFINITY_WORDS, len(resources)

    C = max(_pad_dim(len(candidates)), _pad_dim(pad_candidates))
    S = max(_pad_dim(len(spot)), _pad_dim(pad_spot))
    K = max(
        _pad_dim(max((len(p) for p in cand_pods), default=1)),
        _pad_dim(pad_slots),
    )

    packed = PackedCluster(
        slot_req=np.zeros((C, K, R), np.float32),
        slot_valid=np.zeros((C, K), bool),
        slot_tol=np.zeros((C, K, W), np.uint32),
        slot_aff=np.zeros((C, K, A), np.uint32),
        cand_valid=np.zeros((C,), bool),
        spot_free=np.zeros((S, R), np.float32),
        spot_count=np.zeros((S,), np.int32),
        spot_max_pods=np.zeros((S,), np.int32),
        spot_taints=np.zeros((S, W), np.uint32),
        spot_ok=np.zeros((S,), bool),
        spot_aff=np.zeros((S, A), np.uint32),
    )

    # Memoized per-pod mask helpers: pods overwhelmingly share toleration
    # sets and affinity groups — compute each distinct value once. Request
    # rows are batched per node (req_matrix): per-pod Python helpers were
    # the packing hot spot at 50k pods (~45% of pack time).
    scales = [RESOURCE_SCALE.get(r, 1) for r in resources]
    tol_cache: dict = {}
    aff_cache: dict = {}

    def req_matrix(pods: List[PodSpec]) -> np.ndarray:
        # "pods" is synthesized: every pod counts exactly 1 toward a node's
        # pod capacity regardless of its requests dict (kubelet semantics),
        # so no pod source needs to emit it. As a packed dimension it
        # intentionally duplicates the spot_count/spot_max_pods predicate —
        # BASELINE config 3/4 promise 4 resource dimensions; the VMEM guard
        # (ops/pallas_ffd.needs_scan_fallback) covers the extra plane.
        n = len(pods)
        out = np.empty((n, R), np.float32)
        for j, (r, d) in enumerate(zip(resources, scales)):
            if r == "pods":
                out[:, j] = 1.0
            else:
                col = np.fromiter(
                    (p.requests.get(r, 0) for p in pods),
                    dtype=np.int64, count=n,
                )
                # vectorized ceil-div: requests round up (safe direction)
                out[:, j] = -(-col // d) if d != 1 else col
        return out

    def tol_row(
        pod: PodSpec,
        sbits: frozenset = frozenset(),
        zpbits: frozenset = frozenset(),
    ):
        # sbits/zpbits join the key: a carrier's verdict depends on its
        # LANE's node, so identical pods on different candidates may
        # carry different context bits
        key = (
            tuple(pod.tolerations),
            tuple(sorted(pod.node_selector.items())),
            pod.node_affinity,
            pod.pod_affinity_match,
            sbits,
            zpbits,
            pod.unmodeled_constraints,
        )
        row = tol_cache.get(key)
        if row is None:
            row = tol_cache[key] = constraint_mask(
                pod.tolerations, pod.node_selector,
                pod.unmodeled_constraints, table,
                node_affinity=pod.node_affinity,
                pod_affinity=pod.pod_affinity_match,
                spread_bits=sbits,
                zone_paff_bits=zpbits,
            )
        return row

    zone_cache: dict = {}

    def zone_row(pod: PodSpec):
        """Zone-family bits only (aggregated zone-wide on the node side)."""
        key = (
            pod.namespace,
            pod.anti_affinity_zone_match,
            tuple(sorted(pod.labels.items())),
        )
        row = zone_cache.get(key)
        if row is None:
            row = zone_cache[key] = zone_match_affinity_mask(
                pod.anti_affinity_zone_match, pod.namespace, pod.labels,
                zone_universe,
            )
        return row

    host_cache: dict = {}

    def host_row(pod: PodSpec):
        """Hostname-family bits only — what a resident contributes to
        its OWN node's mask. Zone bits must never ride along here: they
        flow exclusively through the zone-wide accumulation below, so a
        zoneless node never acquires zone conflicts."""
        key = (
            pod.anti_affinity_group,
            pod.namespace,
            pod.anti_affinity_match,
            tuple(sorted(pod.labels.items())),
        )
        row = host_cache.get(key)
        if row is None:
            row = host_cache[key] = pod_affinity_mask(pod) | match_affinity_mask(
                pod.anti_affinity_match, pod.namespace, pod.labels,
                match_universe,
            )
        return row

    def aff_row(pod: PodSpec):
        """Pod-side mask (slots): hostname family | zone family."""
        key = (
            pod.anti_affinity_group,
            pod.namespace,
            pod.anti_affinity_match,
            pod.anti_affinity_zone_match,
            tuple(sorted(pod.labels.items())),
        )
        row = aff_cache.get(key)
        if row is None:
            row = aff_cache[key] = host_row(pod) | zone_row(pod)
        return row

    # zone-wide presence: OR of the zone-family masks of every counted
    # pod — plus every pod on an unclassified-ready or not-ready node —
    # keyed by its node's zone label (nodes without the label are
    # zoneless and neither contribute nor receive)
    zone_accum: dict = {}
    if zone_universe:
        for info in list(candidates) + list(spot) + presence_extra:
            zone = info.node.labels.get(ZONE_LABEL)
            if zone is None:
                continue
            for pod in info.pods:
                acc = zone_accum.get(zone)
                row = zone_row(pod)
                zone_accum[zone] = row.copy() if acc is None else acc | row

    # the unplaceable bit is always the table's last entry
    unplace_idx = len(table.taints) - 1
    unplace_word, unplace_bit = unplace_idx // 32, np.uint32(
        1 << (unplace_idx % 32)
    )

    for c, (info, pods, blocked) in enumerate(zip(candidates, cand_pods, blocking)):
        # a candidate with no evictable pods is skipped, not drained
        # (reference rescheduler.go:260-265); likewise a blocked one.
        packed.cand_valid[c] = blocked is None and len(pods) > 0
        if pods:
            n = len(pods)
            packed.slot_req[c, :n] = req_matrix(pods)
            packed.slot_valid[c, :n] = True
            packed.slot_tol[c, :n] = [
                tol_row(
                    p,
                    spread_bits_by.get((c, k), frozenset()),
                    zone_paff_by.get((c, k), frozenset()),
                )
                for k, p in enumerate(pods)
            ]
            packed.slot_aff[c, :n] = [aff_row(p) for p in pods]
            if zone_universe:
                # two zone-involved pods in one lane: static zone bits
                # cannot prove their in-plan interaction safe — mark
                # them unplaceable (clears the lane, conservatively)
                for k in zone_lane_guard(pods):
                    packed.slot_tol[c, k, unplace_word] &= ~unplace_bit
            if spread_universe:
                # likewise for spread: two in-plan movers involved with
                # one spread identity shift each other's domain counts
                for k in spread_lane_guard(pods):
                    packed.slot_tol[c, k, unplace_word] &= ~unplace_bit

    for s, info in enumerate(spot):
        alloc = scale_allocatable(info.node.allocatable, resources)
        if info.pods:
            used = req_matrix(info.pods).sum(0)
        else:
            used = np.zeros(R, np.float32)
        packed.spot_free[s] = alloc - used
        packed.spot_count[s] = len(info.pods)
        packed.spot_max_pods[s] = int(
            info.node.allocatable.get("pods", DEFAULT_MAX_PODS)
        )
        packed.spot_taints[s] = node_constraint_mask(
            info.node, table, residents=info.pods
        )
        packed.spot_ok[s] = info.node.ready and not info.node.unschedulable
        aff = np.zeros(AFFINITY_WORDS, np.uint32)
        for pod in info.pods:
            if pod.anti_affinity_group or pod.anti_affinity_match or match_universe:
                aff |= host_row(pod)
        if zone_universe:
            zone = info.node.labels.get(ZONE_LABEL)
            if zone is not None and zone in zone_accum:
                aff |= zone_accum[zone]
        packed.spot_aff[s] = aff

    meta = PackMeta(
        candidates=list(candidates),
        cand_pods=cand_pods,
        blocking=blocking,
        spot=list(spot),
        taint_table=table,
        resources=tuple(resources),
    )
    return packed, meta

"""Synthetic cluster generation — the benchmark configs of BASELINE.md.

Descendant of the reference tests' fixture constructors
(``createTestPod``/``createTestNode``/``createFakeClient``, reference
nodes/nodes_test.go:324-449), scaled from the 3+3-node fixture up to the
north-star 5k-node/50k-pod clusters with Zipf pod sizes, taints,
anti-affinity groups, PDBs and spot-interruption replay
(BASELINE.json ``configs`` 1-5).

Pods are packed onto nodes up to a target utilization so that some
on-demand nodes are genuinely drainable and spot capacity is contended but
not exhausted — the regime the rescheduler operates in (README.md:136-149).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from k8s_spot_rescheduler_tpu_torch.io.fake import FakeCluster
from k8s_spot_rescheduler_tpu_torch.models.cluster import (
    CPU,
    EPHEMERAL,
    MEMORY,
    PODS,
    NodeSpec,
    OwnerRef,
    PDBSpec,
    PodSpec,
    Taint,
    Toleration,
)
from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock

ON_DEMAND_LABELS = {"kubernetes.io/role": "worker"}
SPOT_LABELS = {"kubernetes.io/role": "spot-worker"}

# machine shapes: (cpu millicores, memory bytes, max pods, ephemeral bytes)
SHAPES = [
    (4000, 16 * 1024**3, 110, 100 * 1024**3),
    (8000, 32 * 1024**3, 110, 200 * 1024**3),
    (16000, 64 * 1024**3, 250, 400 * 1024**3),
]

SPOT_TAINT = Taint("cloud.provider/spot", "true", "NoSchedule")
SPOT_TOLERATION = Toleration("cloud.provider/spot", "true", "Equal", "NoSchedule")


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    """Knobs for one benchmark config."""

    name: str
    n_on_demand: int
    n_spot: int
    n_pods: int
    zipf_sizes: bool = False
    taints: bool = False  # spot taint + partial toleration coverage
    anti_affinity: bool = False
    pdbs: bool = False
    # hostname/zone labels on every node + hard topologySpreadConstraints
    # on a sparse subset of apps (the round-4 modeled predicate under
    # churn; constrained replay)
    spread: bool = False
    # mean utilization targets (fraction of allocatable CPU)
    on_demand_util: float = 0.45
    spot_util: float = 0.50
    # resource dimensions the solver should pack for this config
    # (BASELINE.json: config 2 = 2 resources, configs 3-4 = 4 resources)
    resources: Tuple[str, ...] = (CPU, MEMORY)


CONFIGS = {
    # 1: the reference's own test-fixture scale (rescheduler_test.go:40-151)
    1: SyntheticSpec("fixture-3x3", 3, 3, 20),
    # 2: first scale step — uniform sizes, cpu+mem
    2: SyntheticSpec("500n-5kp", 250, 250, 5_000),
    # 3: north star — Zipf sizes, taints/tolerations, 4 resources
    3: SyntheticSpec("5kn-50kp-taints", 2_500, 2_500, 50_000,
                     zipf_sizes=True, taints=True,
                     resources=(CPU, MEMORY, EPHEMERAL, PODS)),
    # 4: combinatorial predicates at scale
    4: SyntheticSpec("5kn-50kp-affinity-pdb", 2_500, 2_500, 50_000,
                     zipf_sizes=True, taints=True, anti_affinity=True,
                     pdbs=True, resources=(CPU, MEMORY, EPHEMERAL, PODS)),
    # 5: streaming replay base cluster (events generated separately)
    5: SyntheticSpec("replay-1k-events", 500, 500, 8_000, zipf_sizes=True),
}

# Config-5 churn with the full predicate surface loaded on (round 4):
# taints + partial tolerations, anti-affinity groups, widened round-5
# selector terms (operator-based spread selectors, NotIn'd anti-affinity
# terms, cross-namespace scopes), PDBs, and sparse hostname/zone hard
# spread constraints — the constrained replay row of
# docs/RESULTS.md (bench.py --config 5 --constrained).
REPLAY_CONSTRAINED = SyntheticSpec(
    "replay-constrained", 500, 500, 8_000,
    zipf_sizes=True, taints=True, anti_affinity=True, pdbs=True, spread=True,
)


def _pod_sizes(rng: np.random.Generator, n: int, zipf: bool) -> np.ndarray:
    """CPU requests in millicores. Zipf-ish skew: many small pods, a few
    huge ones, clipped to [50m, 4000m]."""
    if zipf:
        raw = (rng.zipf(2.2, n) * 50).clip(50, 4000)
    else:
        raw = rng.integers(50, 500, n)
    return raw.astype(np.int64)


def generate_cluster(
    spec: SyntheticSpec,
    seed: int = 0,
    clock: Optional[FakeClock] = None,
    **fake_kwargs,
) -> FakeCluster:
    rng = np.random.default_rng(seed)
    fc = FakeCluster(clock or FakeClock(), **fake_kwargs)

    def mk_nodes(count: int, labels: dict, prefix: str, tainted: bool) -> List[NodeSpec]:
        nodes = []
        for i in range(count):
            cpu, mem, cap, eph = SHAPES[rng.integers(0, len(SHAPES))]
            node_labels = dict(labels)
            if spec.spread:
                name = f"{prefix}-{i}"
                node_labels["kubernetes.io/hostname"] = name
                node_labels["topology.kubernetes.io/zone"] = f"z{i % 4}"
            node = NodeSpec(
                name=f"{prefix}-{i}",
                labels=node_labels,
                allocatable={CPU: cpu, MEMORY: mem, PODS: cap, EPHEMERAL: eph},
                taints=[SPOT_TAINT] if tainted else [],
            )
            nodes.append(node)
            fc.add_node(node)
        return nodes

    on_demand = mk_nodes(spec.n_on_demand, ON_DEMAND_LABELS, "od", False)
    # with taints enabled, 40% of spot nodes carry the spot taint
    spot = []
    for i, node in enumerate(mk_nodes(spec.n_spot, SPOT_LABELS, "spot", False)):
        if spec.taints and rng.random() < 0.4:
            node.taints.append(SPOT_TAINT)
        spot.append(node)

    sizes = _pod_sizes(rng, spec.n_pods, spec.zipf_sizes)
    # memory request correlated with cpu: ~2-6 MiB per millicore
    mem_per_cpu = rng.integers(2, 6, spec.n_pods).astype(np.int64)
    mems = sizes * mem_per_cpu * 1024**2
    # ephemeral-storage correlated with cpu: ~16-128 KiB per millicore,
    # so even a fully packed node stays well under its SHAPES[eph] budget
    ephs = sizes * rng.integers(16, 128, spec.n_pods).astype(np.int64) * 1024

    # Fill the emptiest-fitting node first (biggest pods placed first) via a
    # max-heap on remaining budget — O(P log N), scales to 50k pods.
    import heapq

    all_nodes = [(n, spec.on_demand_util) for n in on_demand] + [
        (n, spec.spot_util) for n in spot
    ]
    heap = [
        (-(n.allocatable[CPU] * u), 0, idx)
        for idx, (n, u) in enumerate(all_nodes)
    ]
    heapq.heapify(heap)

    n_apps = max(4, spec.n_pods // 100)
    for p in np.argsort(-sizes):
        cpu = int(sizes[p])
        app = int(rng.integers(0, n_apps))
        if not heap:
            break
        neg_room, cnt, best = heap[0]
        if -neg_room < cpu:
            continue  # even the roomiest node is full at target utilization
        heapq.heappop(heap)
        node = all_nodes[best][0]
        if cnt + 1 < node.allocatable[PODS] - 5:
            heapq.heappush(heap, (neg_room + cpu, cnt + 1, best))
        # role-key check, not dict equality — spread mode adds
        # hostname/zone labels to every node
        is_spot = (
            node.labels.get("kubernetes.io/role")
            == SPOT_LABELS["kubernetes.io/role"]
        )
        tolerations = []
        if spec.taints and (is_spot or rng.random() < 0.7):
            # pods already on tainted spot nodes must tolerate; 70% of
            # on-demand pods are spot-tolerant (the movable majority)
            tolerations = [SPOT_TOLERATION]
        # sparse hard spread: every 13th app's pods carry the common
        # hostname+zone constraint pair over their own app label (the
        # round-4 modeled predicate; loose skews so drains stay
        # possible); every 26th uses the round-5 WIDENED selector form
        # (In over the app pair + a canary DoesNotExist) so churn
        # exercises operator-based spread counting too
        ns = f"ns-{app % 16}"
        spread_constraints = ()
        if spec.spread and app % 13 == 0:
            if app % 26 == 0:
                sel = (
                    ("app", "In", (f"app-{app}", f"app-{app}-canary")),
                    ("canary", "DoesNotExist", ()),
                )
            else:
                sel = (("app", f"app-{app}"),)
            spread_constraints = (
                ("kubernetes.io/hostname", 3, sel),
                ("topology.kubernetes.io/zone", 4, sel),
            )
        # sparse round-5 widened anti-affinity terms (on top of the
        # group-based 10%): every 17th app's pods refuse co-location
        # with SAME-APP pods via a NotIn-excluded sibling selector;
        # every 19th carries a CROSS-NAMESPACE term against the
        # neighboring namespace's copy of the app label. Loose by
        # construction (each app is a small fraction of any node) so
        # drains stay possible while the operators and ns scopes churn.
        anti_terms = ()
        if spec.anti_affinity and app % 17 == 0:
            anti_terms += (
                ((ns,), (
                    ("app", "In", (f"app-{app}",)),
                    ("decoy", "NotIn", ("1",)),
                )),
            )
        if spec.anti_affinity and app % 19 == 0:
            other_ns = f"ns-{(app + 1) % 16}"
            anti_terms += (
                (tuple(sorted({ns, other_ns})),
                 (("app", "In", (f"app-{app}",)),)),
            )
        pod = PodSpec(
            name=f"pod-{p}",
            namespace=ns,
            node_name=node.name,
            requests={CPU: cpu, MEMORY: int(mems[p]), EPHEMERAL: int(ephs[p])},
            labels={"app": f"app-{app}"},
            owner_refs=[OwnerRef("ReplicaSet", f"app-{app}-rs")],
            tolerations=tolerations,
            anti_affinity_group=(
                f"aff-{app}" if spec.anti_affinity and rng.random() < 0.1 else ""
            ),
            anti_affinity_match=anti_terms,
            spread_constraints=spread_constraints,
        )
        fc.add_pod(pod)

    if spec.pdbs:
        for a in range(0, n_apps, 3):  # every third app gets a PDB
            fc.pdbs.append(
                PDBSpec(
                    name=f"pdb-app-{a}",
                    namespace=f"ns-{a % 16}",
                    match_labels={"app": f"app-{a}"},
                    disruptions_allowed=int(rng.integers(1, 10)),
                )
            )
    return fc


@dataclasses.dataclass(frozen=True)
class ContendedSpec:
    """Adversarial quality config: node pools at high spot utilization
    where greedy packing demonstrably loses drains.

    The cluster is G independent pools (apps pinned to their pool's spot
    nodes via ``spec.nodeSelector`` — the standard multi-node-pool k8s
    pattern). Pool kinds, drawn per seed:

    - **easy** — ample slack; any solver proves the drain.
    - **swap** — the regime where one-pass greedy fails: the pool's
      untainted spot capacity is scarce and exactly fits the candidate's
      *intolerant* pod, but a *tolerant* pod is slightly bigger and sorts
      first, so first-fit (probe order: most-requested-first, reference
      rescheduler.go:336-344) and best-fit (tightest slack) both burn the
      untainted node on the tolerant pod and strand the intolerant one.
      Relocating the tolerant pod to the pool's looser *tainted* node —
      one eject-and-reinsert move (solver/repair.py) — unlocks the drain
      the ILP oracle finds.
    - **blocked** — the candidate's pod exceeds every pool node's slack;
      no solver (nor the oracle) drains it.

    Spot nodes in swap pools sit at ≥0.85 utilization; sizes jitter per
    seed so no solver can pattern-match the construction.
    """

    name: str
    n_groups: int = 12
    swap_frac: float = 0.5
    easy_frac: float = 0.35  # remainder of groups is blocked
    node_cpu: int = 4000
    resources: Tuple[str, ...] = (CPU, MEMORY)


@dataclasses.dataclass(frozen=True)
class AffinitySpec:
    """Round-4 adversarial pools: greedy loses *because of* required
    anti-affinity, and (optionally) a two-pod interlock that defeats
    depth-1 eject-reinsert — the published repair boundary.

    Pool kinds, drawn per seed:

    - **aswap** — the anti-affinity swap: two pods of one self-selecting
      group (labels ``app=app-g`` + required hostname anti-affinity
      matching that label — the k8s spread-via-anti-affinity pattern) on
      the candidate. The bigger one (T, spot-taint-tolerant) sorts
      first and greedy burns the pool's only untainted spot node on it;
      the smaller one (I, intolerant) then has nowhere: the tainted
      node refuses it and the untainted one now hosts its group-mate.
      Ejecting T to the tainted node — an AFFINITY-driven relocation,
      impossible under monotone affinity accumulation — frees the node
      for I. The affinity-aware ILP drains the pool; so does repair
      with exact ejection (solver/repair.py round 4).
    - **interlock** — the depth-1 boundary, CLOSED in round 4 by the
      depth-2 chain: the candidate holds A, B, C (sizes a > b > c).
      Greedy lands A on u1 (exactly a slack) and B on u2 (taint only
      A/B tolerate; b+ε slack, ε ≥ a-b); C fits only u1 (z's taint only
      B tolerates). The only unlocker is A, and A can re-place only on
      u2 — which needs B ejected first: the chained move
      (C→u1, A→u2, B→z) that depth-1 eject-reinsert cannot express and
      the round-4 depth-2 chain executes. Now part of the headline
      quality metric (shipped 1.000).
    - **chain3** — the NEW published boundary: a three-link chain
      (c→u1, m1→u2, m2→u3, m3→z) with per-level taints so each mover
      statically fits only its current and next node. The only unlocker
      (m1) can re-place only on u2, whose occupant m2 can re-place only
      on u3 — TWO chained ejections deep, beyond the depth-2 search.
      The ILP (simultaneous) drains it; shipped < 1.000 by
      construction.
    - **easy** — ample slack; any solver proves the drain.
    """

    name: str
    n_groups: int = 12
    aswap_frac: float = 0.5
    interlock_frac: float = 0.0
    chain3_frac: float = 0.0  # remainder of groups is easy
    node_cpu: int = 4000
    resources: Tuple[str, ...] = (CPU, MEMORY)


@dataclasses.dataclass(frozen=True)
class SpreadQualitySpec:
    """Round-5 adversarial pools: greedy loses a drain *because of* a
    hard topologySpreadConstraint, and repair recovers it.

    Per pool ``g`` (own namespace, pool-selector isolated): zone
    ``za-g`` holds spot-a with two selector-matched residents; zone
    ``zb-g`` holds spot-b with heavy NON-matching residents (so probe
    order ranks spot-b first). The candidate carries a big plain filler
    and a smaller zone-spread CARRIER (maxSkew 2, self-matching): the
    skew math refuses ``za-g`` (2 matched there, 0 in ``zb-g``), so the
    carrier fits ONLY spot-b — but greedy places the filler first, and
    both first-fit and best-fit (slack tie -> probe order) burn spot-b
    on it. The repair phase ejects the filler to spot-a and seats the
    carrier — a SPREAD-driven relocation. The ILP (which reads the same
    static SpreadBit words in the packed masks) proves one drain per
    pool; pure greedy proves zero. Static verdicts are EXACT here: one
    carrier per spread identity, nothing else matching its selector
    moves (the bench/quality.py exactness scope)."""

    name: str
    n_groups: int = 12
    resources: Tuple[str, ...] = (CPU, MEMORY)


QUALITY_CONFIGS = {
    # the round-1/2 balanced regime (greedy ties the oracle here — kept as
    # the regression guard that quality never drops below 1.0 on it)
    "balanced": SyntheticSpec("quality-40n-300p", 20, 20, 300),
    # contention: high-utilization pools, taints, selector-pinned apps
    "contended": ContendedSpec("quality-contended-12g"),
    # contention + Zipf-skewed background load on the easy pools
    "contended-zipf": ContendedSpec("quality-contended-zipf-16g", n_groups=16,
                                    swap_frac=0.4, easy_frac=0.45),
    # anti-affinity contention: drains only an affinity-driven
    # relocation recovers (VERDICT r3 #3)
    "affinity": AffinitySpec("quality-affinity-12g"),
    # two-pod interlocks: depth-1's old boundary, closed by the round-4
    # depth-2 chain — now a headline row
    "interlock": AffinitySpec("quality-interlock-8g", n_groups=8,
                              aswap_frac=0.0, interlock_frac=0.25),
    # hard topologySpread contention: drains only a spread-driven
    # relocation recovers (VERDICT r4 #3)
    "spread": SpreadQualitySpec("quality-spread-12g"),
}

# Published-boundary configs: NOT part of the headline worst-ratio metric
# (the boundary is a documented limitation, not a regression) — run via
# bench.py --quality-boundary and pinned by tests/test_quality_adversarial.
BOUNDARY_CONFIGS = {
    # three-link chains need TWO chained ejections; the depth-2 search
    # cannot express them — shipped < 1.000 BY CONSTRUCTION
    # (docs/RESULTS.md)
    "chain3": AffinitySpec("quality-chain3-8g", n_groups=8,
                           aswap_frac=0.0, chain3_frac=0.25),
}


def _mem_for(cpu: int) -> int:
    return int(cpu) * 2 * 1024**2  # 2 MiB per millicore: mem never binds


def generate_contended_cluster(
    spec: ContendedSpec, seed: int = 0, **fake_kwargs
) -> FakeCluster:
    rng = np.random.default_rng(seed)
    fc = FakeCluster(FakeClock(), **fake_kwargs)
    mem = 16 * 1024**3
    zipfish = "zipf" in spec.name

    def add_node(name, labels, taints=()):
        node = NodeSpec(
            name=name,
            labels=dict(labels),
            allocatable={CPU: spec.node_cpu, MEMORY: mem, PODS: 110,
                         EPHEMERAL: 100 * 1024**3},
            taints=list(taints),
        )
        fc.add_node(node)
        return node

    def add_pod(name, node, cpu, *, app, tolerations=(), selector=None):
        fc.add_pod(PodSpec(
            name=name,
            namespace=f"ns-{app % 16}",
            node_name=node,
            requests={CPU: int(cpu), MEMORY: _mem_for(cpu),
                      EPHEMERAL: int(cpu) * 64 * 1024},
            labels={"app": f"app-{app}"},
            owner_refs=[OwnerRef("ReplicaSet", f"app-{app}-rs")],
            tolerations=list(tolerations),
            node_selector=dict(selector or {}),
        ))

    kinds = (["swap"] * round(spec.n_groups * spec.swap_frac)
             + ["easy"] * round(spec.n_groups * spec.easy_frac))
    kinds += ["blocked"] * (spec.n_groups - len(kinds))
    rng.shuffle(kinds)

    for g, kind in enumerate(kinds):
        pool = {"pool": f"g{g}"}
        spot_labels = {**SPOT_LABELS, **pool}
        add_node(f"od-{g}", ON_DEMAND_LABELS)
        if kind == "swap":
            # untainted node: slack exactly one intolerant-pod-sized hole,
            # >=0.85 utilized; tainted node: loose enough to take the
            # tolerant pod after the repair move
            slack_u = int(rng.integers(540, 600))
            t_cpu = slack_u - int(rng.integers(5, 25))
            i_cpu = t_cpu - int(rng.integers(5, 15))
            slack_z = t_cpu + int(rng.integers(60, 140))
            add_node(f"spot-u-{g}", spot_labels)
            add_node(f"spot-z-{g}", spot_labels, [SPOT_TAINT])
            add_pod(f"res-u-{g}", f"spot-u-{g}", spec.node_cpu - slack_u,
                    app=g)
            add_pod(f"res-z-{g}", f"spot-z-{g}", spec.node_cpu - slack_z,
                    app=g, tolerations=[SPOT_TOLERATION])
            add_pod(f"tol-{g}", f"od-{g}", t_cpu, app=g,
                    tolerations=[SPOT_TOLERATION], selector=pool)
            add_pod(f"intol-{g}", f"od-{g}", i_cpu, app=g, selector=pool)
        elif kind == "easy":
            # two small pods, one spot node with comfortable slack
            if zipfish:
                sizes = (rng.zipf(2.2, 2) * 60).clip(60, 700).astype(int)
            else:
                sizes = rng.integers(150, 320, 2)
            slack = int(sizes.sum() + rng.integers(120, 260))
            add_node(f"spot-u-{g}", spot_labels)
            add_pod(f"res-u-{g}", f"spot-u-{g}", spec.node_cpu - slack,
                    app=g)
            for j, cpu in enumerate(sizes):
                add_pod(f"app-{g}-{j}", f"od-{g}", int(cpu), app=g,
                        selector=pool)
        else:  # blocked: pod larger than any slack in its pool
            slack = int(rng.integers(300, 480))
            add_node(f"spot-u-{g}", spot_labels)
            add_pod(f"res-u-{g}", f"spot-u-{g}", spec.node_cpu - slack,
                    app=g)
            add_pod(f"big-{g}", f"od-{g}", slack + int(rng.integers(300, 700)),
                    app=g, selector=pool)
    return fc


U2_TAINT = Taint("quality.test/reserved-u2", "1", "NoSchedule")
U2_TOLERATION = Toleration("quality.test/reserved-u2", "1", "Equal",
                           "NoSchedule")
U3_TAINT = Taint("quality.test/reserved-u3", "1", "NoSchedule")
U3_TOLERATION = Toleration("quality.test/reserved-u3", "1", "Equal",
                           "NoSchedule")


def generate_affinity_cluster(
    spec: AffinitySpec, seed: int = 0, **fake_kwargs
) -> FakeCluster:
    """See ``AffinitySpec`` — aswap / interlock / easy pools."""
    rng = np.random.default_rng(seed)
    fc = FakeCluster(FakeClock(), **fake_kwargs)
    mem = 16 * 1024**3

    def add_node(name, labels, taints=()):
        fc.add_node(NodeSpec(
            name=name,
            labels=dict(labels),
            allocatable={CPU: spec.node_cpu, MEMORY: mem, PODS: 110,
                         EPHEMERAL: 100 * 1024**3},
            taints=list(taints),
        ))

    def add_pod(name, node, cpu, *, app, labels=None, tolerations=(),
                selector=None, anti_match=None):
        fc.add_pod(PodSpec(
            name=name,
            namespace=f"ns-{app % 16}",
            node_name=node,
            requests={CPU: int(cpu), MEMORY: _mem_for(cpu),
                      EPHEMERAL: int(cpu) * 64 * 1024},
            labels=dict(labels if labels is not None else
                        {"app": f"app-{app}"}),
            owner_refs=[OwnerRef("ReplicaSet", f"app-{app}-rs")],
            tolerations=list(tolerations),
            node_selector=dict(selector or {}),
            anti_affinity_match=dict(anti_match or {}),
        ))

    kinds = (["aswap"] * round(spec.n_groups * spec.aswap_frac)
             + ["interlock"] * round(spec.n_groups * spec.interlock_frac)
             + ["chain3"] * round(spec.n_groups * spec.chain3_frac))
    kinds += ["easy"] * (spec.n_groups - len(kinds))
    rng.shuffle(kinds)

    for g, kind in enumerate(kinds):
        pool = {"pool": f"g{g}"}
        spot_labels = {**SPOT_LABELS, **pool}
        add_node(f"od-{g}", ON_DEMAND_LABELS)
        group_sel = {"app": f"app-{g}"}
        if kind == "aswap":
            # untainted node (plain resident) fits T-or-I one at a time;
            # tainted node is loose enough for T after the repair move
            slack_u = int(rng.integers(540, 600))
            t_cpu = slack_u - int(rng.integers(5, 25))
            i_cpu = t_cpu - int(rng.integers(5, 15))
            slack_z = t_cpu + int(rng.integers(60, 140))
            add_node(f"spot-u-{g}", spot_labels)
            add_node(f"spot-z-{g}", spot_labels, [SPOT_TAINT])
            add_pod(f"res-u-{g}", f"spot-u-{g}", spec.node_cpu - slack_u,
                    app=g, labels={"bg": f"bg-{g}"})
            add_pod(f"res-z-{g}", f"spot-z-{g}", spec.node_cpu - slack_z,
                    app=g, labels={"bg": f"bg-{g}"},
                    tolerations=[SPOT_TOLERATION])
            add_pod(f"tol-{g}", f"od-{g}", t_cpu, app=g,
                    tolerations=[SPOT_TOLERATION], selector=pool,
                    anti_match=group_sel)
            add_pod(f"intol-{g}", f"od-{g}", i_cpu, app=g,
                    selector=pool, anti_match=group_sel)
        elif kind == "interlock":
            b = int(rng.integers(300, 400))
            delta = int(rng.integers(5, 20))
            a = b + delta
            eps = delta + int(rng.integers(5, 20))
            zeta = eps + int(rng.integers(5, 20))
            c = int(rng.integers(150, min(250, b - 10)))
            add_node(f"spot-u1-{g}", spot_labels)
            add_node(f"spot-u2-{g}", spot_labels, [U2_TAINT])
            add_node(f"spot-z-{g}", spot_labels, [SPOT_TAINT])
            slack_u1 = a + int(rng.integers(0, 5))
            add_pod(f"res-u1-{g}", f"spot-u1-{g}",
                    spec.node_cpu - slack_u1, app=g,
                    labels={"bg": f"bg-{g}"})
            add_pod(f"res-u2-{g}", f"spot-u2-{g}",
                    spec.node_cpu - (b + eps), app=g,
                    labels={"bg": f"bg-{g}"}, tolerations=[U2_TOLERATION])
            add_pod(f"res-z-{g}", f"spot-z-{g}",
                    spec.node_cpu - (b + zeta), app=g,
                    labels={"bg": f"bg-{g}"}, tolerations=[SPOT_TOLERATION])
            add_pod(f"ilk-a-{g}", f"od-{g}", a, app=g, selector=pool,
                    tolerations=[U2_TOLERATION])
            add_pod(f"ilk-b-{g}", f"od-{g}", b, app=g, selector=pool,
                    tolerations=[U2_TOLERATION, SPOT_TOLERATION])
            add_pod(f"ilk-c-{g}", f"od-{g}", c, app=g, selector=pool)
        elif kind == "chain3":
            # three-link chain: c->u1, m1->u2 (eject m2), m2->u3 (eject
            # m3), m3->z. Per-level taints pin each mover to its current
            # and next node; slack ordering pins greedy's placements
            # (u1 fullest, then u2, u3, z). See AffinitySpec.
            m3 = int(rng.integers(280, 340))
            d3 = int(rng.integers(15, 25))
            m2 = m3 + d3
            d2 = int(rng.integers(15, 25))
            m1 = m2 + d2
            e2 = d2 + int(rng.integers(3, 10))
            e3 = d3 + e2 + int(rng.integers(3, 10))
            c = int(rng.integers(150, 250))
            slack_u1 = m1 + int(rng.integers(0, 5))
            slack_z = m3 + e3 + int(rng.integers(10, 60))
            add_node(f"spot-u1-{g}", spot_labels)
            add_node(f"spot-u2-{g}", spot_labels, [U2_TAINT])
            add_node(f"spot-u3-{g}", spot_labels, [U3_TAINT])
            add_node(f"spot-z-{g}", spot_labels, [SPOT_TAINT])
            add_pod(f"res-u1-{g}", f"spot-u1-{g}",
                    spec.node_cpu - slack_u1, app=g,
                    labels={"bg": f"bg-{g}"})
            add_pod(f"res-u2-{g}", f"spot-u2-{g}",
                    spec.node_cpu - (m2 + e2), app=g,
                    labels={"bg": f"bg-{g}"}, tolerations=[U2_TOLERATION])
            add_pod(f"res-u3-{g}", f"spot-u3-{g}",
                    spec.node_cpu - (m3 + e3), app=g,
                    labels={"bg": f"bg-{g}"}, tolerations=[U3_TOLERATION])
            add_pod(f"res-z-{g}", f"spot-z-{g}",
                    spec.node_cpu - slack_z, app=g,
                    labels={"bg": f"bg-{g}"}, tolerations=[SPOT_TOLERATION])
            add_pod(f"ch-m1-{g}", f"od-{g}", m1, app=g, selector=pool,
                    tolerations=[U2_TOLERATION])
            add_pod(f"ch-m2-{g}", f"od-{g}", m2, app=g, selector=pool,
                    tolerations=[U2_TOLERATION, U3_TOLERATION])
            add_pod(f"ch-m3-{g}", f"od-{g}", m3, app=g, selector=pool,
                    tolerations=[U3_TOLERATION, SPOT_TOLERATION])
            add_pod(f"ch-c-{g}", f"od-{g}", c, app=g, selector=pool)
        else:  # easy
            sizes = rng.integers(150, 320, 2)
            slack = int(sizes.sum() + rng.integers(120, 260))
            add_node(f"spot-u-{g}", spot_labels)
            add_pod(f"res-u-{g}", f"spot-u-{g}", spec.node_cpu - slack,
                    app=g, labels={"bg": f"bg-{g}"})
            for j, cpu in enumerate(sizes):
                add_pod(f"app-{g}-{j}", f"od-{g}", int(cpu), app=g,
                        selector=pool)
    return fc


from k8s_spot_rescheduler_tpu_torch.predicates.masks import ZONE_LABEL


def generate_spread_quality_cluster(
    spec: SpreadQualitySpec, seed: int = 0, **fake_kwargs
) -> FakeCluster:
    """See ``SpreadQualitySpec`` — one spread-contended pool per group."""
    rng = np.random.default_rng(seed)
    fc = FakeCluster(FakeClock(), **fake_kwargs)
    mem = 16 * 1024**3

    def add_node(name, labels, cpu):
        fc.add_node(NodeSpec(
            name=name,
            labels=dict(labels),
            allocatable={CPU: int(cpu), MEMORY: mem, PODS: 110,
                         EPHEMERAL: 100 * 1024**3},
        ))

    for g in range(spec.n_groups):
        ns = f"ns-{g}"
        pool = {"pool": f"g{g}"}
        carrier_cpu = int(rng.integers(450, 550))
        filler_cpu = carrier_cpu + int(rng.integers(50, 150))
        matched_cpu = int(rng.integers(40, 60))
        heavy_total = int(rng.integers(850, 950))
        add_node(f"od-{g}", ON_DEMAND_LABELS, 2000)
        # spot-a (zone za-g): exactly filler-sized slack after its two
        # matched residents; LOW requested -> probed second
        add_node(
            f"spot-a-{g}",
            {**SPOT_LABELS, **pool, ZONE_LABEL: f"za-{g}"},
            filler_cpu + 2 * matched_cpu,
        )
        # spot-b (zone zb-g): filler-sized slack after heavy plain
        # residents; HIGH requested -> probed first, so greedy burns it
        add_node(
            f"spot-b-{g}",
            {**SPOT_LABELS, **pool, ZONE_LABEL: f"zb-{g}"},
            filler_cpu + heavy_total,
        )

        def add_pod(name, node, cpu, labels, spread=()):
            fc.add_pod(PodSpec(
                name=name,
                namespace=ns,
                node_name=node,
                requests={CPU: int(cpu), MEMORY: _mem_for(cpu)},
                labels=dict(labels),
                owner_refs=[OwnerRef("ReplicaSet", f"{name}-rs")],
                node_selector=dict(pool),
                spread_constraints=spread,
            ))

        for j in range(2):  # selector-matched residents: za-g count = 2
            add_pod(f"m{j}-{g}", f"spot-a-{g}", matched_cpu,
                    {"app": f"app-{g}"})
        add_pod(f"h0-{g}", f"spot-b-{g}", heavy_total,
                {"bg": f"bg-{g}"})
        # the movers: filler (bigger, sorts first) + the spread carrier
        add_pod(f"filler-{g}", f"od-{g}", filler_cpu,
                {"bg": f"fill-{g}"})
        add_pod(
            f"carrier-{g}", f"od-{g}", carrier_cpu,
            {"app": f"app-{g}"},
            spread=((ZONE_LABEL, 2, (("app", f"app-{g}"),)),),
        )
    return fc


def generate_quality_cluster(spec, seed: int = 0, **fake_kwargs) -> FakeCluster:
    """Dispatch: SyntheticSpec (balanced random fill), ContendedSpec,
    AffinitySpec, or SpreadQualitySpec."""
    if isinstance(spec, ContendedSpec):
        return generate_contended_cluster(spec, seed, **fake_kwargs)
    if isinstance(spec, AffinitySpec):
        return generate_affinity_cluster(spec, seed, **fake_kwargs)
    if isinstance(spec, SpreadQualitySpec):
        return generate_spread_quality_cluster(spec, seed, **fake_kwargs)
    return generate_cluster(spec, seed, **fake_kwargs)


@dataclasses.dataclass
class ReplayEvent:
    at: float  # seconds from start
    kind: str  # "add_spot" | "remove_spot"
    node: Optional[NodeSpec] = None
    node_name: str = ""


def generate_replay(
    spec: SyntheticSpec, n_events: int = 1000, seed: int = 0
) -> Tuple[FakeCluster, List[ReplayEvent]]:
    """Config 5: a base cluster plus a timed stream of spot add/remove
    events (interruption replay, BASELINE.json config 5)."""
    rng = np.random.default_rng(seed + 1)
    fc = generate_cluster(spec, seed, reschedule_evicted=True)
    events: List[ReplayEvent] = []
    t = 0.0
    extra = 0
    live_spot = [n for n in fc.nodes if n.startswith("spot-")]
    for _ in range(n_events):
        t += float(rng.exponential(7.0))
        if rng.random() < 0.5 and live_spot:
            name = live_spot.pop(int(rng.integers(0, len(live_spot))))
            events.append(ReplayEvent(at=t, kind="remove_spot", node_name=name))
        else:
            cpu, mem, cap, eph = SHAPES[rng.integers(0, len(SHAPES))]
            name = f"spot-new-{extra}"
            labels = dict(SPOT_LABELS)
            if spec.spread:
                # real kubelets label every node; churned-in capacity
                # must be reachable by spread-constrained pods
                labels["kubernetes.io/hostname"] = name
                labels["topology.kubernetes.io/zone"] = f"z{extra % 4}"
            node = NodeSpec(
                name=name,
                labels=labels,
                allocatable={CPU: cpu, MEMORY: mem, PODS: cap, EPHEMERAL: eph},
            )
            extra += 1
            live_spot.append(node.name)
            events.append(ReplayEvent(at=t, kind="add_spot", node=node))
    return fc, events

"""Solution quality: greedy sequential drains against an ILP oracle.

The port of the JAX package's ``bench/quality.py``. BASELINE.md's
quality target: the framework must free at least 95% as many on-demand
nodes as an ILP oracle. The oracle solves the *simultaneous*
drain-selection problem exactly (maximize drained candidates subject to
every moved pod fitting some spot node within capacity), an upper bound
no sequential first-fit controller can beat. The framework's number
comes from ``drain_to_exhaustion``: real housekeeping ticks of the
port's ``Rescheduler`` and ``TorchSolverPlanner`` (cooldown zeroed) until
no further node can be drained, exactly how the live controller
consolidates a cluster over time. The planner runs on ``device``
(``cuda`` unless the caller passes ``cpu``), its greedy passes kernels
B1/B2 on the card.

The ILP and the LP bound are host-side scipy (HiGHS) on the host pack
and only tractable at small scale (the LP bound at config 3/4); they
are the JAX package's, line for line.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
from scipy.optimize import LinearConstraint, milp

from k8s_spot_rescheduler_tpu_torch.models.tensors import PackedCluster


def ilp_max_drains(
    packed: PackedCluster, *, time_limit: float = 120.0
) -> Optional[int]:
    """Max number of candidate nodes drainable *simultaneously*.

    Variables: y_c (drain candidate c), x_{(c,k),s} (slot (c,k) placed on
    spot s, only for statically-admissible pairs). Constraints:
    sum_s x = y_c per valid slot; per-spot resource capacity; per-spot pod
    count; hostname anti-affinity as (a) static exclusion of spots whose
    RESIDENT bits conflict with the slot and (b) pairwise
    ``x_i,s + x_j,s <= 1`` for slot pairs with overlapping affinity
    words. The bit-overlap rule is exact for the self-selecting group
    pattern the quality configs use (each group's pods carry and are
    matched by one distinct selector, so overlap ⇔ a genuine scheduler
    conflict); for arbitrary selector soups the overlap over-approximates
    conflicts (masks.py's safe direction), which would TIGHTEN this
    oracle below the true optimum — keep quality clusters to the
    self-selecting shape. Zone-family bits get the same per-node pair
    rule, which is weaker than the real zone-wide constraint — weaker
    only ever loosens the oracle, so the bound stays valid.

    Hard topologySpreadConstraints (round 5) enter through the SAME
    static admissibility: the packers intern each carrier's
    refused-domain verdict as SpreadBit words in ``slot_tol`` /
    ``spot_taints``, so the taint check above enforces them with no
    extra rows. The verdict is exact — and with it this oracle — when
    one mover per spread identity is in flight and no other pod matched
    by its selector moves (the quality-config scope, same contract as
    the affinity rule; ``SpreadQualitySpec`` is built to it). A config
    with interacting spread movers would have the lane guard TIGHTEN
    the masks below the true optimum — keep quality clusters to the
    single-carrier shape. Returns None if the solver fails.

    One step ahead of the JAX package's construction, with the same
    answer: when every candidate has a valid slot admissible on no spot
    (its slot row ``sum_s x = y_c`` has no x, so y_c = 0), the optimum
    is 0 and HiGHS is not called. The chain-depth analyzer asks this of
    every lane the repair search left unproven, about a second of HiGHS
    each on the constrained replay's C=1 slices.
    """
    C, K, R = packed.slot_req.shape
    S = packed.spot_free.shape[0]

    cands = [c for c in range(C) if packed.cand_valid[c]]
    slots = [(c, k) for c in cands for k in range(K) if packed.slot_valid[c, k]]
    if not cands:
        return 0

    # static admissibility per (slot, spot): taints + node_ok + resident
    # anti-affinity bits
    taint_ok = np.all(
        (packed.spot_taints[None, None] & ~packed.slot_tol[:, :, None]) == 0,
        axis=-1,
    )  # [C,K,S]
    aff_ok = np.all(
        (packed.spot_aff[None, None] & packed.slot_aff[:, :, None]) == 0,
        axis=-1,
    )  # [C,K,S]
    ok_spots = packed.spot_ok[None, None] & taint_ok & aff_ok
    nowhere = np.asarray(packed.slot_valid, bool) & ~ok_spots.any(axis=-1)
    if nowhere[cands].any(axis=-1).all():
        return 0

    # variable layout: y for each cand, then x for admissible pairs
    y_index = {c: i for i, c in enumerate(cands)}
    x_pairs = []
    for (c, k) in slots:
        for s in range(S):
            if ok_spots[c, k, s]:
                x_pairs.append((c, k, s))
    n_y, n_x = len(cands), len(x_pairs)
    n = n_y + n_x

    rows, cols, vals = [], [], []
    lb, ub = [], []
    row = 0

    # per-slot assignment: sum_s x_{cks} - y_c = 0
    slot_rows = {sl: None for sl in slots}
    for i, sl in enumerate(slots):
        slot_rows[sl] = row
        c, _ = sl
        rows.append(row), cols.append(y_index[c]), vals.append(-1.0)
        lb.append(0.0), ub.append(0.0)
        row += 1
    for j, (c, k, s) in enumerate(x_pairs):
        r = slot_rows[(c, k)]
        rows.append(r), cols.append(n_y + j), vals.append(1.0)

    # per-spot capacity per resource
    for s in range(S):
        if not packed.spot_ok[s]:
            continue
        for r_ in range(R):
            rows_before = len(rows)
            for j, (c, k, s2) in enumerate(x_pairs):
                if s2 == s and packed.slot_req[c, k, r_] > 0:
                    rows.append(row), cols.append(n_y + j)
                    vals.append(float(packed.slot_req[c, k, r_]))
            if len(rows) > rows_before:
                lb.append(-np.inf)
                ub.append(float(packed.spot_free[s, r_]))
                row += 1
        # pod-count capacity
        rows_before = len(rows)
        for j, (c, k, s2) in enumerate(x_pairs):
            if s2 == s:
                rows.append(row), cols.append(n_y + j), vals.append(1.0)
        if len(rows) > rows_before:
            lb.append(-np.inf)
            ub.append(float(packed.spot_max_pods[s] - packed.spot_count[s]))
            row += 1

    # pairwise anti-affinity: two moved slots with overlapping affinity
    # words may not share one spot node (same or different lanes)
    x_index = {(c, k, s): j for j, (c, k, s) in enumerate(x_pairs)}
    aff_slots = [sl for sl in slots if packed.slot_aff[sl[0], sl[1]].any()]
    for a in range(len(aff_slots)):
        c1, k1 = aff_slots[a]
        w1 = packed.slot_aff[c1, k1]
        for b in range(a + 1, len(aff_slots)):
            c2, k2 = aff_slots[b]
            if not np.any(w1 & packed.slot_aff[c2, k2]):
                continue
            for s in range(S):
                j1 = x_index.get((c1, k1, s))
                j2 = x_index.get((c2, k2, s))
                if j1 is None or j2 is None:
                    continue
                rows.append(row), cols.append(n_y + j1), vals.append(1.0)
                rows.append(row), cols.append(n_y + j2), vals.append(1.0)
                lb.append(-np.inf), ub.append(1.0)
                row += 1

    A = sp.csr_matrix((vals, (rows, cols)), shape=(row, n))
    c_obj = np.zeros(n)
    c_obj[:n_y] = -1.0  # maximize sum y
    res = milp(
        c=c_obj,
        constraints=LinearConstraint(A, np.array(lb), np.array(ub)),
        integrality=np.ones(n),
        bounds=(0, 1),
        options={"time_limit": time_limit},
    )
    if res.status not in (0, 1) or res.x is None:  # 0=optimal, 1=iter/time
        return None
    return int(round(-res.fun))


def pack_quality(spec, seed: int) -> PackedCluster:
    """Pack a quality-config cluster through the production columnar
    observe path (a host pack: numpy)."""
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
        generate_quality_cluster,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    cfg = ReschedulerConfig(resources=spec.resources)
    client = generate_quality_cluster(spec, seed)
    store = client.columnar_store(
        cfg.resources,
        on_demand_label=cfg.on_demand_node_label,
        spot_label=cfg.spot_node_label,
    )
    packed, _ = store.pack(
        client.list_pdbs(), priority_threshold=cfg.priority_threshold
    )
    return packed


def lp_upper_bound(packed: PackedCluster, *, max_sigs: int = 8) -> Optional[int]:
    """Tractable upper bound on simultaneously-drainable candidates at
    full (config 3/4) scale, where ``ilp_max_drains``'s per-(slot, spot)
    variables are intractable.

    The LP relaxes the exact ILP two ways: drain indicators ``y_c`` become
    fractional, and per-spot-node bins are aggregated into *admissibility
    signature* groups (distinct taint/pseudo-taint word rows over the spot
    pool). Validity is a Hall/transportation condition: any integral drain
    set places each moved pod on a node whose signature the pod tolerates,
    so for EVERY subset T of signatures, the demand of chosen pods
    admissible only within T cannot exceed T's aggregate capacity (each
    resource, plus the pod-count axis). Anti-affinity and per-node
    fragmentation are relaxed away — the bound only ever loosens, so
    achieved/bound understates true quality, never flatters it.

    Signatures beyond ``max_sigs`` are merged into a universally-admissible
    group (again only loosening). Returns None if the LP fails.
    """
    from scipy.optimize import linprog

    C, K, R = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    ok = np.asarray(packed.spot_ok, bool)
    if not ok.any() or not np.asarray(packed.cand_valid).any():
        return 0

    # distinct taint-word signatures over usable spot nodes
    words = np.asarray(packed.spot_taints)[ok]  # [S_ok, W]
    sig_rows, sig_of = np.unique(words, axis=0, return_inverse=True)
    G = sig_rows.shape[0]
    if G > max_sigs:
        # keep the most common signatures; merge the rest into taint-free
        # (admissible to everyone -> capacity over-approximated, bound valid)
        counts = np.bincount(sig_of, minlength=G)
        keep = np.argsort(-counts)[: max_sigs - 1]
        remap = np.full(G, -1)
        for new, old in enumerate(keep):
            remap[old] = new
        merged = max_sigs - 1
        sig_of = np.where(remap[sig_of] >= 0, remap[sig_of], merged)
        new_rows = np.zeros((max_sigs, sig_rows.shape[1]), sig_rows.dtype)
        new_rows[:merged] = sig_rows[keep]
        sig_rows, G = new_rows, max_sigs

    # per-signature aggregate capacity: resources + pod-count axis. An
    # overcommitted node (free < 0) must contribute 0, not subtract from
    # its group — the bound must only ever loosen vs the per-bin truth.
    cap_sig = np.zeros((G, R + 1))
    free_ok = np.asarray(packed.spot_free, float)[ok].clip(min=0.0)
    count_room = (
        np.asarray(packed.spot_max_pods, float) - np.asarray(packed.spot_count, float)
    )[ok].clip(min=0.0)
    for g in range(G):
        rows = sig_of == g
        cap_sig[g, :R] = free_ok[rows].sum(axis=0)
        cap_sig[g, R] = count_room[rows].sum()

    # admissible-signature bitmask per valid slot: tol covers sig's taints
    tol = np.asarray(packed.slot_tol)  # [C, K, W]
    admissible = np.all(
        (sig_rows[None, None] & ~tol[:, :, None]) == 0, axis=-1
    )  # [C, K, G]
    slot_valid = np.asarray(packed.slot_valid, bool)
    cand_valid = np.asarray(packed.cand_valid, bool).copy()
    # a valid slot admissible nowhere pins its candidate to y=0
    nowhere = slot_valid & ~admissible.any(axis=-1)
    cand_valid &= ~nowhere.any(axis=-1)

    masks = admissible.astype(np.int64) @ (1 << np.arange(G))  # [C, K]
    req = np.asarray(packed.slot_req, float)  # [C, K, R]
    demand = np.concatenate([req, np.ones((C, K, 1))], axis=-1)  # [C,K,R+1]
    demand = np.where(slot_valid[:, :, None], demand, 0.0)

    # bucket demand by exact mask, then subset-sum (zeta transform)
    n_masks = 1 << G
    bucket = np.zeros((C, n_masks, R + 1))
    for c in np.flatnonzero(cand_valid):
        np.add.at(bucket[c], masks[c][slot_valid[c]], demand[c][slot_valid[c]])
    zeta = bucket
    for b in range(G):
        bit = 1 << b
        has = (np.arange(n_masks) & bit) != 0
        zeta[:, has] += zeta[:, ~has]

    # constraint rows: for every non-empty signature subset T and axis r:
    #   sum_c y_c * zeta[c, T, r] <= cap(T, r)
    T_idx = np.arange(1, n_masks)
    sig_in_T = (T_idx[:, None] >> np.arange(G)) & 1  # [T, G]
    cap_T = sig_in_T @ cap_sig  # [T, R+1]
    A_ub = zeta[:, T_idx].reshape(C, -1).T  # [(T*(R+1)), C]
    b_ub = cap_T.reshape(-1)
    # drop trivial all-zero rows
    live = A_ub.any(axis=1)
    A_ub, b_ub = A_ub[live], b_ub[live]

    c_obj = -cand_valid.astype(float)
    bounds = [(0.0, 1.0 if v else 0.0) for v in cand_valid]
    res = linprog(c_obj, A_ub=A_ub, b_ub=b_ub, bounds=bounds, method="highs")
    if not res.success:
        return None
    return int(np.floor(-res.fun + 1e-6))


class _HintingPlanner:
    """Delegates to TorchSolverPlanner, recording each approved plan's proven
    placements as the fake scheduler's routing hints (DrainPlan carries
    ``assignments`` for exactly this). The quality number then measures
    *planner* quality — not the toy first-fit scheduler's — in the tight
    regimes where arbitrary re-placement would strand a proven-placeable
    pod."""

    def __init__(self, inner, client):
        self.inner = inner
        self.client = client

    def __getattr__(self, name):
        # transparent wrapper: the control loop probes planner traits
        # (notably accepts_columnar — losing it would silently drop the
        # columnar observe fast path for every quality benchmark)
        return getattr(self.inner, name)

    def _record(self, report):
        hints = getattr(self.client, "placement_hints", None)
        if hints is not None and report.plan is not None:
            hints.clear()
            hints.update(report.plan.assignments)
        return report

    def plan(self, node_map, pdbs):
        return self._record(self.inner.plan(node_map, pdbs))

    def plan_async(self, node_map, pdbs):
        # the control loop prefers the pipelined entry point, and
        # __getattr__ would hand it the INNER planner's — which skips the
        # hint recording — so it must be wrapped explicitly
        finish = self.inner.plan_async(node_map, pdbs)
        return lambda: self._record(finish())

    def plan_schedule(self, node_map, pdbs):
        # same lesson as plan_async: __getattr__ would hand the loop
        # the inner planner's plan_schedule, whose served steps would
        # skip hint recording — the handle's on_step hook exists for
        # exactly this (each executed step's proven placements become
        # the fake scheduler's routing hints before its drain runs)
        plan_schedule = getattr(self.inner, "plan_schedule", None)
        if plan_schedule is None:
            return None
        handle = plan_schedule(node_map, pdbs)
        if handle is not None:
            handle.on_step = self._record
        return handle


def drain_to_exhaustion(
    client, config, *, max_ticks: int = 10_000, on_packed=None,
    planner_stats=None, device=None,
) -> int:
    """Run the real control loop (zero cooldown) until no drain happens;
    returns the number of nodes drained, the framework's quality
    number. The planner is a ``TorchSolverPlanner`` on ``device``
    (``cuda`` by default; a fault of the card's kernels ends the run, as
    in the controller). ``on_packed`` (optional) receives each tick's
    host pack after planning, the chain-depth analyzer's tap
    (bench/chain_depth.py; it id-deduplicates skipped ticks).
    ``planner_stats`` (optional dict) is filled with the planner's fetch
    accounting, ``fetches_total`` and per-cut ``schedule_lens``: the
    measured artifact behind the O(1)-fetch claim when
    ``plan_schedule_enabled`` is on."""
    import dataclasses

    from k8s_spot_rescheduler_tpu_torch.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )

    config = dataclasses.replace(config, node_drain_delay=0.0)
    inner = TorchSolverPlanner(config, device=device)
    r = Rescheduler(
        client,
        _HintingPlanner(inner, client),
        config,
        clock=client.clock,
        recorder=client,
    )
    freed = 0
    stuck = 0
    for _ in range(max_ticks):
        client.clock.advance(config.housekeeping_interval)
        result = r.tick()
        if on_packed is not None:
            on_packed(getattr(inner, "last_packed", None))
        if result.skipped == "unschedulable":
            # let evicted pods land; a permanently-pending pod ends the run
            stuck += 1
            if stuck > 50:
                break
            continue
        stuck = 0
        if not result.drained and not result.drain_failed:
            break
        freed += len(result.drained)
    if planner_stats is not None:
        planner_stats["fetches_total"] = inner.fetches_total
        planner_stats["schedule_lens"] = list(inner.schedule_lens)
    return freed

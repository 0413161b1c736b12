"""The plain reference: the drain plan of a cluster, worked out from the
generator's records alone by the rules the configuration states.

It imports nothing of the program. It classifies and orders the nodes,
picks each candidate's evictable pods, derives every predicate from the
records, and runs the plan's search, each written here from the stated
rules:

- **Classes and order.** A node carrying the spot label is spot, else one
  carrying the on-demand label is a candidate. A node's pods are in
  biggest-CPU-request-first order; candidates are drained least-requested
  CPU first, spot nodes probed most-requested CPU first; ties keep the
  cluster's order (a stable sort).
- **Evictable pods.** A DaemonSet pod stays; a pod with no controller, or
  one selected by a PDB with no disruption left, blocks its node. A node
  with no pod to move is not a candidate.
- **Units.** cpu in millicores; memory and ephemeral storage in MiB, a
  request rounded up and allocatable down; every pod counts 1 of the
  node's pod cap (110 where the node gives none).
- **Admission** of a pod to a spot node: every NoSchedule or NoExecute
  taint tolerated; for each hard spread constraint, the node has the
  topology key and its domain is not refused; the pod is not struck by
  the lane guard (below).
- **Spread.** For a moving pod that carries (key, maxSkew, selector), the
  count of a domain is the pods of the carrier's namespace that match the
  selector on nodes with that domain; if the carrier matches its own
  selector it leaves its own domain first. A domain is refused when its
  count exceeds the least count plus maxSkew, less one when the carrier
  matches (its arrival counts). Lane guard: where two or more pods of one
  lane are involved with one spread identity (namespace, selector) by
  carrying it or matching it, each of them is placeable nowhere.
- **Anti-affinity** on one node, in 64 bits: a group's bit, a carried
  term's bit and the bit of every term (of any counted pod) that matches
  the pod, each the blake2b-64 hash of the group's name or of the term's
  key modulo 64. A pod may not join a node or a fellow mover with which
  it shares a bit (a shared bit only ever forbids).
- **The search a lane** (each lane forks the same spot pool): first-fit
  in probe order; where that fails, best-fit (the least cpu slack, ties
  to probe order); where both fail, repair: a best-fit pass that leaves
  gaps, then rounds that free room for the first unplaced pod by moving
  one placed pod (or two, chained), rotating through the candidates for
  the move, and a check of the result from scratch against the pool.
- **A cut**: take the first feasible lane, commit its placements to the
  pool, retire it, and solve again, up to the horizon.

Lanes are independent, so each pass runs over a batch of lanes as plain
torch tensors, on the card after the window or on the CPU in tests.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

MIB = 1 << 20
UNIT = {"cpu": 1, "memory": MIB, "ephemeral-storage": MIB, "pods": 1}
DEFAULT_POD_CAP = 110
HARD = ("NoSchedule", "NoExecute")
NO_SLOT = 1 << 40  # beyond every index and every slack


# ---------------------------------------------------------------------------
# labels, selectors, taints, bits


def _has_label(labels: dict, selector: str) -> bool:
    key, value = selector.split("=", 1)
    return labels.get(key) == value


def _req_matches(req: tuple, labels: dict) -> bool:
    key, op, values = req if len(req) == 3 else (req[0], "In", (req[1],))
    v = labels.get(key)
    if op == "In":
        return v is not None and v in values
    if op == "NotIn":
        return v is None or v not in values
    if op == "Exists":
        return v is not None
    if op == "DoesNotExist":
        return v is None
    raise ValueError(f"selector operator {op!r}")


def _selects(selector, labels: dict) -> bool:
    return all(_req_matches(r, labels) for r in selector)


def _canon(selector) -> tuple:
    """A selector's requirements as sorted (key, op, values) triples."""
    return tuple(sorted(r if len(r) == 3 else (r[0], "In", (r[1],))
                        for r in selector))


def _tolerates(tolerations, taint) -> bool:
    key, value, effect = taint
    for t_key, t_value, op, t_effect in tolerations:
        if t_effect and t_effect != effect:
            continue
        if op == "Exists" and (t_key == "" or t_key == key):
            return True
        if op == "Equal" and t_key == key and t_value == value:
            return True
    return False


def _bit(key: str) -> int:
    """The pod's anti-affinity bit of ``key``, as a signed 64-bit word."""
    h = int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8).digest(),
                       "little") % 64
    return -(1 << 63) if h == 63 else 1 << h


def _term_key(term) -> str:
    namespaces, selector = term
    return "\x1c".join(namespaces) + "\x1d" + "\x1e".join(
        f"{k}\x1f{op}\x1f" + "\x1c".join(vals) for k, op, vals in selector)


def _term_hits(term, pod: dict) -> bool:
    namespaces, selector = term
    return pod["namespace"] in namespaces and _selects(selector, pod["labels"])


# ---------------------------------------------------------------------------
# the problem, from the records


class Problem(NamedTuple):
    """One cluster as the reference solves it (no padding): C candidate
    lanes of at most K pods, S spot nodes, R resources; admission by
    class (``admit[cls[c, k]]`` is slot (c, k)'s row over the spots)."""

    cand_names: List[str]
    cand_pods: List[List[str]]
    spot_names: List[str]
    cand_ok: torch.Tensor  # bool [C]
    valid: torch.Tensor  # bool [C, K]
    req: torch.Tensor  # int64 [C, K, R]
    cls: torch.Tensor  # int64 [C, K]
    bits: torch.Tensor  # int64 [C, K]
    admit: torch.Tensor  # bool [U, S]
    free: torch.Tensor  # int64 [S, R]
    count: torch.Tensor  # int64 [S]
    cap: torch.Tensor  # int64 [S]
    node_bits: torch.Tensor  # int64 [S]


KNOWN_POD_KEYS = {"name", "namespace", "node", "requests", "labels", "owner",
                  "tolerations", "anti_affinity_group", "anti_affinity_match",
                  "spread_constraints"}


def build(cluster, dep: dict, ctl: dict, device, *,
          drop_taints: bool = False) -> Problem:
    """The problem of ``cluster`` (``generator.Cluster``) under
    deployment ``dep`` and controller settings ``ctl``. ``drop_taints``
    admits every pod past every taint: the control's broken guarantee."""
    resources = list(dep["resources"])
    threshold = ctl["priority_threshold"]

    od, spot = [], []
    for name, node in cluster.nodes.items():
        is_spot = _has_label(node["labels"], dep["spot_label"])
        if not is_spot and not _has_label(node["labels"], dep["on_demand_label"]):
            raise ValueError(f"node {name} is of neither class")
        pods = [p for p in cluster.by_node[name].values()
                if not (is_spot and p.get("priority", 0) < threshold)]
        for p in pods:
            if set(p) - KNOWN_POD_KEYS - {"priority"}:
                raise ValueError(f"pod {p['name']}: a predicate the "
                                 f"reference does not know: {set(p) - KNOWN_POD_KEYS}")
        pods.sort(key=lambda p: -p["requests"]["cpu"])
        entry = (node, pods, sum(p["requests"]["cpu"] for p in pods))
        (spot if is_spot else od).append(entry)
    od.sort(key=lambda e: e[2])
    spot.sort(key=lambda e: -e[2])

    def req_row(pod):
        return [1 if r == "pods" else -(-pod["requests"].get(r, 0) // UNIT[r])
                for r in resources]

    # evictable pods a candidate
    cand_pods, cand_ok = [], []
    for node, pods, _ in od:
        moving, blocked = [], False
        for p in pods:
            kind = p["owner"][0] if p["owner"] else None
            if kind == "DaemonSet":
                continue
            if kind is None and not ctl["delete_non_replicated_pods"]:
                blocked = True
                break
            if any(b["namespace"] == p["namespace"]
                   and all(p["labels"].get(k) == v
                           for k, v in b["match_labels"].items())
                   and b["disruptions_allowed"] < 1 for b in cluster.pdbs):
                blocked = True
                break
            moving.append(p)
        cand_pods.append([] if blocked else moving)
        cand_ok.append(not blocked and len(moving) > 0)

    # anti-affinity: the terms of every counted pod
    counted = [p for _, pods, _ in od + spot for p in pods]
    universe = sorted({tuple(t) for p in counted
                       for t in p["anti_affinity_match"]})
    bit_cache: Dict[tuple, int] = {}

    def pod_bits(p) -> int:
        key = (p["anti_affinity_group"], p["namespace"],
               tuple(p["anti_affinity_match"]),
               tuple(sorted(p["labels"].items())))
        got = bit_cache.get(key)
        if got is None:
            got = _bit(p["anti_affinity_group"]) if p["anti_affinity_group"] else 0
            for t in p["anti_affinity_match"]:
                got |= _bit(_term_key(t))
            for t in universe:
                if _term_hits(t, p):
                    got |= _bit(_term_key(t))
            bit_cache[key] = got
        return got

    # spread: domains and per-domain counts over every node
    all_nodes = [(node, pods) for node, pods, _ in od + spot]
    domains: Dict[str, List[str]] = {}
    tallies: Dict[tuple, Dict[str, int]] = {}

    def domains_of(key):
        if key not in domains:
            domains[key] = sorted({n["labels"][key] for n, _ in all_nodes
                                   if key in n["labels"]})
        return domains[key]

    def tally(ns, key, selector):
        k = (ns, key, selector)
        if k not in tallies:
            out: Dict[str, int] = {}
            for n, pods in all_nodes:
                d = n["labels"].get(key)
                if d is None:
                    continue
                for p in pods:
                    if p["namespace"] == ns and _selects(selector, p["labels"]):
                        out[d] = out.get(d, 0) + 1
            tallies[k] = out
        return tallies[k]

    def refused(p, own_node, key, skew, selector) -> tuple:
        selfm = _selects(selector, p["labels"])
        full = {d: tally(p["namespace"], key, selector).get(d, 0)
                for d in domains_of(key)}
        own = own_node["labels"].get(key)
        if selfm and own in full:
            full[own] -= 1
        if not full:
            return ()
        limit = min(full.values()) + skew - (1 if selfm else 0)
        return tuple(sorted(d for d, v in full.items() if v > limit))

    def guarded(pods) -> set:
        carried: Dict[tuple, set] = {}
        for i, p in enumerate(pods):
            for _, _, sel in p["spread_constraints"]:
                carried.setdefault((p["namespace"], _canon(sel)), set()).add(i)
        out: set = set()
        for (ns, sel), involved in carried.items():
            involved = set(involved) | {
                i for i, p in enumerate(pods)
                if p["namespace"] == ns and _selects(sel, p["labels"])}
            if len(involved) >= 2:
                out |= involved
        return out

    # admission classes: (tolerations, spread verdicts, guarded)
    spot_nodes = [n for n, _, _ in spot]
    classes: Dict[tuple, int] = {}
    rows: List[np.ndarray] = []

    def admission(tolerations, verdicts, struck) -> int:
        key = (tolerations, verdicts, struck)
        got = classes.get(key)
        if got is None:
            row = np.zeros(len(spot_nodes), bool)
            if not struck:
                for s, n in enumerate(spot_nodes):
                    ok = drop_taints or all(
                        _tolerates(tolerations, t) for t in n["taints"]
                        if t[2] in HARD)
                    for key_, refused_ in verdicts:
                        d = n["labels"].get(key_)
                        ok = ok and d is not None and d not in refused_
                    row[s] = ok
            got = classes[key] = len(rows)
            rows.append(row)
        return got

    C, S, R = len(od), len(spot), len(resources)
    K = max([len(p) for p in cand_pods] + [1])
    valid = np.zeros((C, K), bool)
    req = np.zeros((C, K, R), np.int64)
    cls = np.zeros((C, K), np.int64)
    bits = np.zeros((C, K), np.int64)
    for c, ((node, _, _), pods) in enumerate(zip(od, cand_pods)):
        struck = guarded(pods)
        for k, p in enumerate(pods):
            valid[c, k] = True
            req[c, k] = req_row(p)
            verdicts = tuple(sorted(
                (key, refused(p, node, key, skew, _canon(sel)))
                for key, skew, sel in p["spread_constraints"]))
            cls[c, k] = admission(tuple(tuple(t) for t in p["tolerations"]),
                                  verdicts, k in struck)
            bits[c, k] = pod_bits(p)

    free = np.zeros((S, R), np.int64)
    count = np.zeros(S, np.int64)
    cap = np.zeros(S, np.int64)
    node_bits = np.zeros(S, np.int64)
    for s, (node, pods, _) in enumerate(spot):
        alloc = node["allocatable"]
        for j, r in enumerate(resources):
            have = alloc.get(r, DEFAULT_POD_CAP if r == "pods" else 0) // UNIT[r]
            free[s, j] = have - sum(req_row(p)[j] for p in pods)
        count[s] = len(pods)
        cap[s] = alloc.get("pods", DEFAULT_POD_CAP)
        acc = 0
        for p in pods:
            acc |= pod_bits(p)
        node_bits[s] = acc
    if not rows:
        rows.append(np.zeros(S, bool))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Problem(
        cand_names=[n["name"] for n, _, _ in od],
        cand_pods=[[f"{p['namespace']}/{p['name']}" for p in pods]
                   for pods in cand_pods],
        spot_names=[n["name"] for n in spot_nodes],
        cand_ok=t(np.array(cand_ok, bool)), valid=t(valid), req=t(req),
        cls=t(cls), bits=t(bits), admit=t(np.stack(rows)), free=t(free),
        count=t(count), cap=t(cap), node_bits=t(node_bits))


# ---------------------------------------------------------------------------
# the search, over a batch of lanes


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (its length where none)."""
    n = mask.shape[-1]
    iota = torch.arange(n, device=mask.device)
    return torch.where(mask, iota, n).min(dim=-1).values


def _nth(mask: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Index of the ``n``-th True (from 0) along the last axis."""
    rank = mask.long().cumsum(-1) - 1
    return _first(mask & (rank == n[:, None]))


class Pool(NamedTuple):
    """The spot pool as a lane sees it: [S] shared or [L, S] forked."""

    free: torch.Tensor
    count: torch.Tensor
    bits: torch.Tensor


def _fits(pool: Pool, cap, req, adm, bits) -> torch.Tensor:
    """bool [L, S]: where each lane's pod (req [L, R], admission [L, S],
    bits [L]) may go on its lane's pool ([L, S, ...])."""
    return ((pool.free >= req[:, None, :]).all(-1) & (pool.count < cap)
            & adm & ((pool.bits & bits[:, None]) == 0))


def _fork(pool: Pool, L: int) -> Pool:
    return Pool(*(x.unsqueeze(0).expand(L, *x.shape).clone() for x in pool))


def _place(pool: Pool, lanes_put, s, req, bits) -> None:
    """Commit pod (req [L, R], bits [L]) at spot ``s`` [L] on the lanes of
    ``lanes_put`` (bool [L]), in place."""
    L = s.shape[0]
    ar = torch.arange(L, device=s.device)
    sc = s.clamp(0, pool.count.shape[1] - 1)
    put = lanes_put.long()
    pool.free[ar, sc] -= req * put[:, None]
    pool.count[ar, sc] += put
    pool.bits[ar, sc] |= torch.where(lanes_put, bits, 0)


def greedy(P: Problem, pool: Pool, lanes: torch.Tensor, best: bool,
           gaps: bool = False):
    """First-fit (``best`` False) or best-fit over ``lanes`` (int [L]):
    (proven bool [L], placement int64 [L, K], -1 unplaced, and the lanes'
    pools after). ``gaps``: a pod with no room is left unplaced and the
    lane goes on (repair's first pass)."""
    L, K = lanes.shape[0], P.valid.shape[1]
    dev = P.valid.device
    forked = _fork(pool, L)
    ok = P.cand_ok[lanes].clone()
    assign = torch.full((L, K), -1, dtype=torch.long, device=dev)
    S = P.free.shape[0]
    iota = torch.arange(S, device=dev)
    for k in range(K):
        v = P.valid[lanes, k] & (ok | gaps)
        req = P.req[lanes, k]
        bits = P.bits[lanes, k]
        m = _fits(forked, P.cap, req, P.admit[P.cls[lanes, k]], bits)
        has = m.any(-1)
        if best:
            slack = forked.free[:, :, 0] - req[:, :1]
            key = torch.where(m, slack * S + iota, NO_SLOT)
            s = key.min(-1).values % S
        else:
            s = _first(m)
        if not gaps:
            ok &= ~v | has
        put = v & has
        _place(forked, put, s, req, bits)
        assign[:, k] = torch.where(put, s, -1)
    if not gaps:
        assign = torch.where(ok[:, None], assign, -1)
    return ok, assign, forked


def _or_over(words: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(words[..., 0])
    for k in range(words.shape[-1]):
        out |= words[..., k]
    return out


def repair(P: Problem, pool: Pool, lanes: torch.Tensor, rounds: int):
    """Repair over ``lanes``: (proven bool [L], placement [L, K])."""
    L, K = lanes.shape[0], P.valid.shape[1]
    dev = P.valid.device
    ar = torch.arange(L, device=dev)
    iota_k = torch.arange(K, device=dev)
    valid, req, bits = P.valid[lanes], P.req[lanes], P.bits[lanes]
    cls = P.cls[lanes]
    _, assign, mine = greedy(P, pool, lanes, best=True, gaps=True)

    def slot(x, k):
        return x[ar, k.clamp(0, K - 1)]

    for rnd in range(rounds):
        placed = assign >= 0
        at = assign.clamp(min=0)
        free_at = mine.free[ar[:, None], at]  # [L, K, R]
        unplaced = valid & ~placed
        act = unplaced.any(-1)
        p = _first(unplaced)
        req_p, bits_p = slot(req, p), slot(bits, p)
        adm_p = P.admit[slot(cls, p)]
        unlock = placed & adm_p.gather(1, at) & (
            free_at + req - req_p[:, None, :] >= 0).all(-1)
        n_unlock = unlock.sum(-1)
        act &= n_unlock > 0
        q = _nth(unlock, rnd % n_unlock.clamp(min=1))
        sq = slot(assign, q).clamp(min=0)
        others = (assign == sq[:, None]) & (iota_k != q[:, None])
        ej = pool.bits[sq] | _or_over(torch.where(others, bits, 0))
        act &= (bits_p & ej) == 0
        req_q, bits_q = slot(req, q), slot(bits, q)
        adm_q = P.admit[slot(cls, q)]
        fq = _fits(mine, P.cap, req_q, adm_q, bits_q)
        fq[ar, sq] = False
        one = act & fq.any(-1)
        s2 = _first(fq)
        # a chain where q cannot move directly: q onto r's node, r on
        eligible = placed & (at != sq[:, None]) & adm_q.gather(1, at) & (
            free_at + req - req_q[:, None, :] >= 0).all(-1)
        n_r = eligible.sum(-1)
        two = act & ~fq.any(-1) & (n_r > 0)
        r = _nth(eligible, (rnd // n_unlock.clamp(min=1)) % n_r.clamp(min=1))
        sr = slot(assign, r).clamp(min=0)
        req_r, bits_r = slot(req, r), slot(bits, r)
        fr = _fits(mine, P.cap, req_r, P.admit[slot(cls, r)], bits_r)
        fr[ar, sr] = False
        fr[ar, sq] = False
        two &= fr.any(-1)
        s3 = _first(fr)
        others_r = (assign == sr[:, None]) & (iota_k != r[:, None])
        ej_r = pool.bits[sr] | _or_over(torch.where(others_r, bits, 0))
        two &= (bits_q & ej_r) == 0

        def move(mask, k, s):
            kc = k.clamp(0, K - 1)
            assign[ar, kc] = torch.where(mask, s, assign[ar, kc])

        def add(mask, s, delta):
            sc = s.clamp(0, mine.count.shape[1] - 1)
            mine.free[ar, sc] += delta * mask.long()[:, None]

        def set_bits(mask, s, value):
            sc = s.clamp(0, mine.count.shape[1] - 1)
            mine.bits[ar, sc] = torch.where(mask, value, mine.bits[ar, sc])

        # direct: p onto q's node, q to s2
        move(one, p, sq)
        move(one, q, s2)
        add(one, sq, req_q - req_p)
        add(one, s2, -req_q)
        mine.count[ar, s2.clamp(0, mine.count.shape[1] - 1)] += one.long()
        set_bits(one, s2, mine.bits[ar, s2.clamp(0, mine.count.shape[1] - 1)] | bits_q)
        set_bits(one, sq, ej | bits_p)
        # chained: p onto q's node, q onto r's, r to s3
        move(two, p, sq)
        move(two, q, sr)
        move(two, r, s3)
        add(two, sq, req_q - req_p)
        add(two, sr, req_r - req_q)
        add(two, s3, -req_r)
        mine.count[ar, s3.clamp(0, mine.count.shape[1] - 1)] += two.long()
        set_bits(two, sq, ej | bits_p)
        set_bits(two, sr, ej_r | bits_q)
        set_bits(two, s3, mine.bits[ar, s3.clamp(0, mine.count.shape[1] - 1)] | bits_r)

    ok = check(P, pool, lanes, assign)
    return ok, torch.where(ok[:, None], assign, -1)


def check(P: Problem, pool: Pool, lanes: torch.Tensor, assign) -> torch.Tensor:
    """bool [L]: each lane's placement, checked from scratch against
    ``pool``: every pod placed, within capacity and pod cap on every node
    that receives one, admitted, and sharing no bit with its node or
    with a fellow mover on it."""
    L, K = assign.shape
    S, R = pool.free.shape
    dev = assign.device
    valid, req, bits = P.valid[lanes], P.req[lanes], P.bits[lanes]
    placed = assign >= 0
    live = placed & valid
    at = assign.clamp(0, S - 1)
    complete = (placed == valid).all(-1) & (assign < S).all(-1)
    flat = (torch.arange(L, device=dev)[:, None] * S + at).reshape(-1)
    load = torch.zeros(L * S, R, dtype=torch.long, device=dev)
    load.index_add_(0, flat, (req * live[..., None]).reshape(-1, R))
    n_on = torch.zeros(L * S, dtype=torch.long, device=dev)
    n_on.index_add_(0, flat, live.reshape(-1).long())
    load, n_on = load.view(L, S, R), n_on.view(L, S)
    used = n_on > 0
    room = ((pool.free[None] - load >= 0).all(-1) | ~used).all(-1)
    capped = ((pool.count[None] + n_on <= P.cap[None]) | ~used).all(-1)
    admitted = (P.admit[P.cls[lanes], :].gather(2, at[..., None])[..., 0]
                | ~live).all(-1)
    together = (at[:, :, None] == at[:, None, :]) & live[:, :, None] & live[:, None, :]
    together &= ~torch.eye(K, dtype=torch.bool, device=dev)
    clash = ((bits[:, :, None] & bits[:, None, :]) != 0) & together
    on_node = ((pool.bits[at] & bits) != 0) & live
    return (P.cand_ok[lanes] & complete & room & capped & admitted
            & ~clash.flatten(1).any(-1) & ~on_node.any(-1))


def union(P: Problem, pool: Pool, cand_ok: torch.Tensor, rounds: int,
          best_fit: bool):
    """(feasible bool [C], placement [C, K]) of every lane still a
    candidate: first-fit, else best-fit, else repair."""
    C = cand_ok.shape[0]
    P = P._replace(cand_ok=cand_ok)
    lanes = torch.arange(C, device=cand_ok.device)
    ok, assign, _ = greedy(P, pool, lanes, best=False)
    if best_fit:
        need = torch.nonzero(cand_ok & ~ok).flatten()
        if need.numel():
            b_ok, b_assign, _ = greedy(P, pool, need, best=True)
            ok[need] = b_ok
            assign[need] = b_assign
        need = torch.nonzero(cand_ok & ~ok).flatten()
        if rounds > 0 and need.numel():
            r_ok, r_assign = repair(P, pool, need, rounds)
            ok[need] = r_ok
            assign[need] = r_assign
    return ok & cand_ok, assign


class Step(NamedTuple):
    node: str
    n_feasible: int
    targets: Dict[str, str]  # pod uid -> spot node


def schedule(P: Problem, ctl: dict) -> List[Step]:
    """The cut: up to ``schedule_horizon`` drains, each the first feasible
    lane on the pool the drains before it left."""
    rounds = ctl["repair_rounds"] if ctl["fallback_best_fit"] else 0
    pool = Pool(P.free.clone(), P.count.clone(), P.node_bits.clone())
    cand_ok = P.cand_ok.clone()
    steps: List[Step] = []
    for _ in range(max(1, ctl["schedule_horizon"])):
        feasible, assign = union(P, pool, cand_ok, rounds,
                                 ctl["fallback_best_fit"])
        n = int(feasible.sum())
        if n == 0:
            break
        c = int(_first(feasible))
        row = assign[c]
        live = (row >= 0) & P.valid[c]
        for k in torch.nonzero(live).flatten().tolist():
            s = int(row[k])
            pool.free[s] -= P.req[c, k]
            pool.count[s] += 1
            pool.bits[s] |= P.bits[c, k]
        cand_ok[c] = False
        rows = row.tolist()
        steps.append(Step(P.cand_names[c], n, {
            uid: P.spot_names[rows[k]] for k, uid in enumerate(P.cand_pods[c])}))
    return steps


def solve_cut(cluster, dep: dict, ctl: dict, device, *,
              drop_taints: bool = False) -> Tuple[Problem, List[Step]]:
    P = build(cluster, dep, ctl, device, drop_taints=drop_taints)
    return P, schedule(P, ctl)

"""Canonical label-selector requirements — the widened selector algebra.

Round 5 widens every pod-affinity/spread selector from the matchLabels
dict shape to the full k8s ``LabelSelector`` operator surface
(In / NotIn / Exists / DoesNotExist, multi-value In) plus explicit
cross-namespace ``namespaces`` lists and any number of required terms
per topology family. The reference gets all of these free through the
real scheduler's InterPodAffinity / PodTopologySpread predicates
(reference rescheduler.go:344; predicate list README.md:103-114); here
they become data every decode path (io/kube.py, io/watch.py via
decode_pod, native/ingest.cc via io/native_ingest.py) must canonicalize
*identically*, so the packers intern equal constraints to equal bits.

Canonical forms (plain tuples — hashable, orderable, blob-free):

- **requirement** ``(key, op, values)`` with ``op`` one of
  In/NotIn/Exists/DoesNotExist and ``values`` a sorted, deduplicated
  tuple (empty for Exists/DoesNotExist — k8s validation rejects values
  there, and decode treats violations as unmodeled);
- **selector** — sorted tuple of requirements; matchLabels pairs enter
  as single-value In requirements. Two semantically equal selectors
  written differently may intern to two bits — harmless, both verdicts
  are computed correctly; equality is only an interning optimization;
- **term** ``(namespaces, selector)`` with ``namespaces`` a sorted
  non-empty tuple of namespace names. An absent/empty ``namespaces``
  field resolves to the pod's own namespace at decode time, so the
  implicit form and an explicit own-namespace list are one identity.

Matching semantics follow k8s.io/apimachinery ``labels.Requirement``:
NotIn and DoesNotExist match when the key is absent.
"""

from __future__ import annotations

from typing import Dict, Tuple

# Operator vocabulary for pod-label selectors (LabelSelectorOperator).
# Node-affinity expressions additionally use Gt/Lt/FieldIn/FieldNotIn —
# those stay in predicates/masks.match_expr and never appear here.
SELECTOR_OPS = ("In", "NotIn", "Exists", "DoesNotExist")

Req = Tuple[str, str, Tuple[str, ...]]
Selector = Tuple[Req, ...]
Term = Tuple[Tuple[str, ...], Selector]


def canon_labels(match: Dict[str, str]) -> Selector:
    """matchLabels dict -> canonical selector (each pair a single-value
    In requirement)."""
    return tuple(sorted((k, "In", (v,)) for k, v in match.items()))


def canon_selector(reqs) -> Selector:
    """Sort + dedupe a requirement iterable into canonical form; value
    lists are assumed already sorted/deduped by the decoder."""
    return tuple(sorted(set(reqs)))


def req_matches(req: Req, labels) -> bool:
    """One requirement against a pod's labels (k8s labels.Requirement
    semantics: NotIn/DoesNotExist match when the key is absent)."""
    key, op, values = req
    v = labels.get(key)
    if op == "In":
        return v is not None and v in values
    if op == "NotIn":
        return v is None or v not in values
    if op == "Exists":
        return v is not None
    return v is None  # DoesNotExist


# A canonical selector that can match NO pod (the "" key must both
# exist and not exist): the exact encoding of k8s's nil-selector
# semantics (labels.Nothing()) — decode_pdb uses it for PDBs created
# without a spec.selector, which select zero pods.
MATCH_NOTHING: Selector = (("", "DoesNotExist", ()), ("", "Exists", ()))


def selector_matches(sel: Selector, labels) -> bool:
    """AND over the selector's requirements. The EMPTY selector matches
    everything (k8s: an empty LabelSelector selects all objects) — the
    affinity decoders never produce one (empty selectors stay
    unmodeled), but ``decode_pdb`` deliberately does: a PDB's ``{}``
    selector selects every pod in its namespace, and the empty selector
    is also its conservative fallback for unparseable shapes. A nil
    PDB selector is ``MATCH_NOTHING`` instead."""
    return all(req_matches(r, labels) for r in sel)


# The all-namespaces scope (a term with ``namespaceSelector: {}``,
# which k8s defines as selecting every namespace). Namespace names are
# DNS-1123 labels, so a literal "*" namespace cannot exist — the
# sentinel is collision-free.
ALL_NAMESPACES = ("*",)


def term_matches(term: Term, pod_namespace: str, labels) -> bool:
    """Does a pod (namespace + labels) fall in the term's scope and
    match its selector? This is both the presence direction (which pods
    set a universe term's bit) and the node-side resident check."""
    namespaces, sel = term
    return (
        namespaces == ALL_NAMESPACES or pod_namespace in namespaces
    ) and selector_matches(sel, labels)


def selector_matches_nothing(sel: Selector) -> bool:
    """True iff NO label assignment can satisfy the selector — exact,
    by per-key analysis (keys are independent):

    - DoesNotExist together with In/Exists on one key is impossible;
    - the intersection of a key's In sets minus its NotIn values being
      empty is impossible;
    - NotIn/Exists alone are always satisfiable (the value domain is
      unbounded from the selector's point of view).

    Anti-affinity terms whose selector matches nothing constrain
    nothing and are dropped exactly; positive-affinity terms keep the
    term (no resident can ever match -> every node repels the carrier,
    which is the scheduler's exact verdict)."""
    by_key: Dict[str, list] = {}
    for req in sel:
        by_key.setdefault(req[0], []).append(req)
    for reqs in by_key.values():
        has_dne = any(op == "DoesNotExist" for _, op, _ in reqs)
        needs_value = any(op in ("In", "Exists") for _, op, _ in reqs)
        if has_dne:
            if needs_value:
                return True
            continue  # satisfiable by absence (NotIn matches absent too)
        in_sets = [set(v) for _, op, v in reqs if op == "In"]
        if in_sets:
            not_in = set()
            for _, op, v in reqs:
                if op == "NotIn":
                    not_in.update(v)
            if not (set.intersection(*in_sets) - not_in):
                return True
        # NotIn/Exists only: always satisfiable
    return False


def term_key(term: Term) -> str:
    """Deterministic hash key for a term (predicates/masks.affinity_bits
    group hashing). Decode guarantees namespaces, keys, operators and
    values are free of the \\x1c-\\x1f separator bytes, so the encoding
    is collision-free across distinct canonical terms."""
    namespaces, sel = term
    return "\x1c".join(namespaces) + "\x1d" + "\x1e".join(
        f"{k}\x1f{op}\x1f" + "\x1c".join(vals) for k, op, vals in sel
    )


def canon_match_terms(value, own_namespace: str) -> Tuple[Term, ...]:
    """Normalize a PodSpec affinity field to canonical terms.

    Accepts the legacy matchLabels dict shorthand (own-namespace, one
    term — what synthetic generators and tests construct), an already-
    canonical tuple of terms, or ()/None. The shorthand keeps every
    existing call site valid while the decode paths emit full terms."""
    if not value:
        return ()
    if isinstance(value, dict):
        return (((own_namespace,), canon_labels(value)),)
    return tuple(sorted(set(value)))


def canon_spread_entries(value) -> Tuple:
    """Normalize spread_constraints entries: legacy (topo, skew,
    ((key, value), ...)) items become (topo, skew, selector) with
    single-value In requirements; canonical entries pass through."""
    if not value:
        return ()
    out = []
    for topo, skew, items in value:
        reqs = tuple(
            sorted(
                item if len(item) == 3 else (item[0], "In", (item[1],))
                for item in items
            )
        )
        out.append((topo, int(skew), reqs))
    return tuple(sorted(set(out)))

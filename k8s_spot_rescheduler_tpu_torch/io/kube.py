"""Real-cluster client: the Kubernetes apiserver behind ClusterClient.

The reference talks to the apiserver through client-go — watch-backed
listers (reference rescheduler.go:154-156), per-node pod LISTs with a
``spec.nodeName`` field selector (nodes/nodes.go:129-145), the eviction
subresource (scaler/scaler.go:58), ToBeDeleted taint updates
(scaler/scaler.go:77, 140 via CA ``deletetaint``) and an event sink
(rescheduler.go:327-332). This module is that surface over plain HTTPS
(stdlib urllib — no client library), decoding API objects into the
framework's PodSpec/NodeSpec/PDBSpec.

Config resolution mirrors ``createKubeClient`` (rescheduler.go:304-324):
in-cluster service-account credentials when ``running_in_cluster`` is
set, else a kubeconfig file (current-context, token or client-cert auth).

The read path is polling LISTs rather than watch caches: one LIST of all
pods per tick (partitioned by node client-side) replaces the reference's
N per-node LISTs — fewer round trips at 5k-node scale, same data.

The port of the JAX package's ``io/kube.py``. Node and pod LISTs decode
in one native pass (``io/native_ingest``, into lazy views) while
``use_native_ingest`` is set and the library is available; else, and
for every other read, through the Python decoders below, which stay the
semantic reference. Each read is one ``kube.get`` span of
``utils/tracing``.
"""

from __future__ import annotations

import base64
import json
import os
import random
import ssl
import tempfile
import time as _time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from k8s_spot_rescheduler_tpu_torch.io.cluster import EvictionError
from k8s_spot_rescheduler_tpu_torch.models.cluster import (
    NodeSpec,
    OwnerRef,
    PDBSpec,
    PodSpec,
    Taint,
    Toleration,
)
from k8s_spot_rescheduler_tpu_torch.utils.quantity import parse_cpu_millis, parse_quantity
from k8s_spot_rescheduler_tpu_torch.utils import logging as log
from k8s_spot_rescheduler_tpu_torch.utils import tracing

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# Longest server-sent Retry-After the read-retry loop will honor: flow
# control deserves deference, but a single read must never absorb an
# hour-long header — the control loop's skip-tick/breaker path owns
# outages longer than this.
RETRY_AFTER_CAP = 30.0


def transient_http_error(err: Exception):
    """(retryable, retry_after_s) classification of a request failure.

    Transient — worth a backed-off retry: HTTP 429 (apiserver flow
    control; carries Retry-After) and any 5xx, plus every
    connection-level failure (reset, refused, timeout, TLS handshake
    flake — ``URLError`` and the rest of the ``OSError`` family).
    EXCEPT certificate-verification failures: a misconfigured CA bundle
    or hostname can never succeed on retry, so it surfaces immediately
    instead of burning the full backoff budget on every read.
    Everything else (401/403/404/409, malformed JSON, ...) is a real
    answer, not a flake, and surfaces immediately — retrying a 404
    would only delay the caller's own handling of it."""
    if isinstance(err, urllib.error.HTTPError):
        if err.code == 429 or 500 <= err.code < 600:
            retry_after = None
            try:
                value = err.headers.get("Retry-After") if err.headers else None
                if value is not None:
                    retry_after = float(value)
            except (TypeError, ValueError):
                retry_after = None
            return True, retry_after
        return False, None
    if isinstance(err, ssl.SSLCertVerificationError):
        return False, None
    if isinstance(err, urllib.error.URLError) and isinstance(
        getattr(err, "reason", None), ssl.SSLCertVerificationError
    ):
        return False, None
    if isinstance(err, (urllib.error.URLError, OSError)):
        return True, None
    return False, None


def _decode_quantity(name: str, value) -> int:
    if name == "cpu":
        return parse_cpu_millis(value)
    q = parse_quantity(value)
    return int(q.numerator // q.denominator)


def decode_pod(obj: dict) -> PodSpec:
    meta = obj.get("metadata", {})
    spec = obj.get("spec", {})
    requests: Dict[str, int] = {}
    for container in spec.get("containers", []) or []:
        for name, value in (
            container.get("resources", {}).get("requests", {}) or {}
        ).items():
            requests[name] = requests.get(name, 0) + _decode_quantity(name, value)
    owner_refs = [
        OwnerRef(
            kind=ref.get("kind", ""),
            name=ref.get("name", ""),
            controller=bool(ref.get("controller", False)),
        )
        for ref in meta.get("ownerReferences", []) or []
    ]
    tolerations = [
        Toleration(
            key=t.get("key", ""),
            value=t.get("value", ""),
            operator=t.get("operator", "Equal"),
            effect=t.get("effect", ""),
        )
        for t in spec.get("tolerations", []) or []
    ]
    # constraints beyond the modeled predicate set (PVC/volume topology,
    # affinity shapes outside the canonical forms below) mark the pod
    # conservatively unplaceable — its node can never be proven
    # drainable, never stranded. Modeled, interned as pseudo-taint bits
    # replacing the reference's delegation to the real scheduler
    # (rescheduler.go:344; README.md:103-114): required node-affinity
    # matchExpressions and metadata.name matchFields
    # (masks.NodeAffinityBit), hostname anti-affinity (selector groups),
    # and required positive hostname pod-affinity (masks.PodAffinityBit:
    # only nodes already hosting a match admit the pod).
    affinity = spec.get("affinity") or {}
    node_affinity, naff_unmodeled = decode_node_affinity(
        affinity.get("nodeAffinity") or {}
    )
    # `or "default"` (not a dict default): the native engine normalizes
    # null/empty namespace to "default" too — lockstep for the
    # own-namespace `namespaces` verdict below
    pod_ns = meta.get("namespace") or "default"
    anti_affinity_match, anti_zone_match, anti_unmodeled = decode_anti_affinity(
        affinity.get("podAntiAffinity") or {}, pod_ns
    )
    pod_affinity_match, pod_affinity_zone, paff_unmodeled = decode_pod_affinity(
        affinity.get("podAffinity") or {}, pod_ns
    )
    required_affinity = naff_unmodeled or anti_unmodeled or paff_unmodeled
    # PVC-backed volumes: conservatively unplaceable at decode; the
    # volume-affinity resolver (models/volumes.py) lifts this when every
    # claim proves Bound to a modelable PV. Claims whose names are
    # malformed keep has_pvc set with no resolvable names — never lifted.
    pvc_names = []
    has_pvc = False
    for vol in spec.get("volumes", []) or []:
        if isinstance(vol, dict) and "persistentVolumeClaim" in vol:
            # key presence on a dict volume, like ingest.cc's Obj get
            has_pvc = True
            claim = vol.get("persistentVolumeClaim")
            name = claim.get("claimName") if isinstance(claim, dict) else None
            # sep-byte guard keeps the native blob framing safe, in
            # lockstep with ingest.cc (malformed -> never resolvable)
            if isinstance(name, str) and name and not _has_sep_bytes(name):
                pvc_names.append(name)
            else:
                pvc_names = []
                break
    # Hard topology-spread constraints are scheduling predicates the
    # reference's CheckPredicates enforces (PodTopologySpread plugin,
    # README.md:103-114). The canonical shape is modeled
    # (decode_topology_spread → SpreadBit pseudo-taints in the packers);
    # anything beyond it stays conservatively unplaceable — ignoring a
    # hard constraint would approve drains the real scheduler then
    # refuses, the unsafe direction.
    spread_constraints, hard_spread = decode_topology_spread(
        spec.get("topologySpreadConstraints")
    )
    return PodSpec(
        name=meta.get("name", ""),
        namespace=pod_ns,
        node_name=spec.get("nodeName", "") or "",
        requests=requests,
        priority=int(spec.get("priority", 0) or 0),
        labels=meta.get("labels", {}) or {},
        annotations=meta.get("annotations", {}) or {},
        owner_refs=owner_refs,
        tolerations=tolerations,
        phase=obj.get("status", {}).get("phase", "Running"),
        node_selector=spec.get("nodeSelector", {}) or {},
        anti_affinity_match=anti_affinity_match,
        anti_affinity_zone_match=anti_zone_match,
        pod_affinity_match=pod_affinity_match,
        pod_affinity_zone_match=pod_affinity_zone,
        node_affinity=node_affinity,
        spread_constraints=spread_constraints,
        pvc_names=tuple(pvc_names),
        pvc_resolvable=bool(
            has_pvc and pvc_names and not (required_affinity or hard_spread)
        ),
        unmodeled_constraints=bool(required_affinity or has_pvc or hard_spread),
    )


_NODE_AFFINITY_OPS = ("In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt")

# NodeSelectorRequirement.values are NOT apiserver-validated as label
# values — they may contain the native blob's separator bytes
# (\x1c-\x1f). Such requirements are conservatively unmodeled, in exact
# lockstep with native/ingest.cc has_sep_bytes, so the two decode paths
# can never diverge on them.
_SEP_BYTES = ("\x1c", "\x1d", "\x1e", "\x1f")


def _has_sep_bytes(s: str) -> bool:
    return any(ch in s for ch in _SEP_BYTES)


def decode_node_affinity(node_aff: dict) -> tuple:
    """(canonical terms, unmodeled) for a nodeAffinity object.

    The modeled shape is requiredDuringSchedulingIgnoredDuringExecution
    .nodeSelectorTerms where every term uses matchExpressions with the
    six NodeSelectorOperator values and/or matchFields on
    ``metadata.name`` with In/NotIn (the only field selector k8s
    defines; apiserver validation rejects everything else). Field
    expressions canonicalize with reserved operators FieldIn/FieldNotIn
    so a node LABEL literally named "metadata.name" can never collide
    with the field. Canonical form: terms and the expressions within
    each term sorted, In/NotIn value lists sorted+deduped — so equal
    requirements intern to one pseudo-taint bit. Terms that match
    nothing (empty) are dropped (k8s: a nil/empty term selects no
    objects); if every term drops, the requirement matches no node —
    conservatively unmodeled (same unplaceable effect)."""
    req = node_aff.get("requiredDuringSchedulingIgnoredDuringExecution")
    if not req:
        return (), False
    if not isinstance(req, dict):
        return (), True
    term_list = req.get("nodeSelectorTerms")
    if not isinstance(term_list, list) or not term_list:
        return (), True
    terms = []
    for term in term_list:
        if not isinstance(term, dict):
            return (), True
        exprs_in = term.get("matchExpressions") or []
        fields_in = term.get("matchFields") or []
        if not isinstance(exprs_in, list) or not isinstance(fields_in, list):
            return (), True
        exprs = []
        for e in exprs_in:
            if not isinstance(e, dict):
                return (), True
            key, op = e.get("key"), e.get("operator")
            if not isinstance(key, str) or op not in _NODE_AFFINITY_OPS:
                return (), True
            if _has_sep_bytes(key):
                return (), True
            values = e.get("values") or []
            if not isinstance(values, list) or not all(
                isinstance(v, str) and not _has_sep_bytes(v) for v in values
            ):
                return (), True
            if op in ("Exists", "DoesNotExist"):
                values = ()
            elif op in ("Gt", "Lt"):
                if len(values) != 1:
                    return (), True
                values = tuple(values)
            else:  # In / NotIn with at least one value (k8s validation)
                if not values:
                    return (), True
                values = tuple(sorted(set(values)))
            exprs.append((key, op, values))
        for e in fields_in:
            if not isinstance(e, dict):
                return (), True
            key, op = e.get("key"), e.get("operator")
            # metadata.name is the only node field selector k8s defines
            if key != "metadata.name" or op not in ("In", "NotIn"):
                return (), True
            values = e.get("values") or []
            if not isinstance(values, list) or not values or not all(
                isinstance(v, str) and not _has_sep_bytes(v) for v in values
            ):
                return (), True
            exprs.append(
                (key, "FieldIn" if op == "In" else "FieldNotIn",
                 tuple(sorted(set(values))))
            )
        if exprs:
            terms.append(tuple(sorted(exprs)))
    if not terms:
        return (), True  # all terms match nothing: unplaceable
    return tuple(sorted(set(terms))), False


from k8s_spot_rescheduler_tpu_torch.predicates.masks import (
    ZONE_LABEL as ZONE_TOPOLOGY_KEY,
)


from k8s_spot_rescheduler_tpu_torch.predicates.selectors import (
    ALL_NAMESPACES,
    SELECTOR_OPS as _SELECTOR_OPS,
    canon_selector,
    selector_matches_nothing,
)


def _decode_term(term: dict, namespace: str):
    """One required pod-affinity term, canonicalized to the round-5
    widened shape (predicates/selectors.py): a ``(namespaces, selector)``
    term with the full LabelSelector operator surface. Exact native
    lockstep (native/ingest.cc ``term_selector_blob``):

    - ``namespaces`` absent/empty resolves to the pod's own namespace;
      an explicit list of namespace names (cross-namespace included) is
      modeled as the term's scope — k8s semantics: the list REPLACES
      the own-namespace default, it does not extend it;
    - ``namespaceSelector: {}`` selects EVERY namespace (k8s) and is
      modeled as the wildcard scope (selectors.ALL_NAMESPACES — it
      subsumes any ``namespaces`` list, whose union with all-namespaces
      is all-namespaces); a NON-empty namespaceSelector matches
      namespace LABELS, which this framework does not observe, and
      stays unmodeled;
    - ``matchLabels`` pairs become single-value In requirements;
    - ``matchExpressions`` entries model In / NotIn / Exists /
      DoesNotExist with multi-value lists; In/NotIn need >=1 value and
      Exists/DoesNotExist must carry none (k8s validation);
    - an empty selector stays unmodeled; separator bytes anywhere stay
      unmodeled (native blob framing, has_sep_bytes lockstep).

    Returns (term | None, matches_nothing, unmodeled)."""
    ns_list = term.get("namespaces")
    if ns_list:
        # "*" is reserved as the all-namespaces sentinel (DNS labels
        # cannot contain it); a literal "*" entry is malformed and must
        # not silently widen the scope
        if not isinstance(ns_list, list) or not all(
            isinstance(x, str) and x and x != "*" and not _has_sep_bytes(x)
            for x in ns_list
        ):
            return None, False, True
        namespaces = tuple(sorted(set(ns_list)))
    else:
        namespaces = (namespace,)
    if "namespaceSelector" in term:
        ns_sel = term["namespaceSelector"]
        if ns_sel == {}:
            # k8s: an empty namespaceSelector selects EVERY namespace;
            # the union with any `namespaces` list is still everything
            namespaces = ALL_NAMESPACES
        elif ns_sel is not None:
            # non-empty selectors match namespace LABELS, which this
            # framework does not observe — conservatively unmodeled.
            # null is the API's explicit "no selector" (≡ absent).
            return None, False, True
    sel = term.get("labelSelector")
    if not isinstance(sel, dict):
        return None, False, True
    match = sel.get("matchLabels")
    if match is None:
        match = {}
    if not isinstance(match, dict):
        return None, False, True
    if any(
        not isinstance(k, str) or not isinstance(v, str)
        or _has_sep_bytes(k) or _has_sep_bytes(v)
        for k, v in match.items()
    ):
        return None, False, True
    reqs = [(k, "In", (v,)) for k, v in match.items()]
    exprs = sel.get("matchExpressions")
    if exprs:
        if not isinstance(exprs, list):
            return None, False, True
        for e in exprs:
            if not isinstance(e, dict):
                return None, False, True
            key, op = e.get("key"), e.get("operator")
            if (
                not isinstance(key, str)
                or _has_sep_bytes(key)
                or op not in _SELECTOR_OPS
            ):
                return None, False, True
            values = e.get("values")
            if op in ("Exists", "DoesNotExist"):
                if values:  # k8s validation: no values for these ops
                    return None, False, True
                reqs.append((key, op, ()))
                continue
            if not isinstance(values, list) or not values or not all(
                isinstance(v, str) and not _has_sep_bytes(v) for v in values
            ):
                return None, False, True
            reqs.append((key, op, tuple(sorted(set(values)))))
    if not reqs:
        return None, False, True  # empty selector: not modeled
    selector = canon_selector(reqs)
    return (namespaces, selector), selector_matches_nothing(selector), False


def decode_anti_affinity(anti: dict, namespace: str = "default") -> tuple:
    """(hostname terms, zone terms, unmodeled) for a podAntiAffinity
    object — round-5 widened canonical shape, in exact lockstep with
    native/ingest.cc ``extract_anti_affinity``: ANY number of required
    terms, each hostname or zone topology, each with the widened
    ``_decode_term`` selector (full operator surface + cross-namespace
    scopes). A term whose selector matches nothing constrains nothing
    and is dropped exactly; any other topology key stays unmodeled."""
    req = anti.get("requiredDuringSchedulingIgnoredDuringExecution")
    if not req:
        return (), (), False
    if not isinstance(req, list):
        return (), (), True
    host: list = []
    zone: list = []
    for term in req:
        if not isinstance(term, dict):
            return (), (), True
        topo = term.get("topologyKey")
        if topo == "kubernetes.io/hostname":
            out = host
        elif topo == ZONE_TOPOLOGY_KEY:
            out = zone
        else:
            return (), (), True
        decoded, nothing, unmodeled = _decode_term(term, namespace)
        if unmodeled:
            return (), (), True
        if nothing:
            continue  # constrains nothing — exact to drop
        out.append(decoded)
    return tuple(sorted(set(host))), tuple(sorted(set(zone))), False


def decode_pod_affinity(paff: dict, namespace: str = "default") -> tuple:
    """(hostname terms, zone terms, unmodeled) for a required POSITIVE
    podAffinity object — round 5: ANY number of required terms, each
    hostname or zone topology, each with the widened selector; every
    term must hold. Hostname: the pod may only join a node already
    hosting a match (masks.PodAffinityBit); zone: a ZONE already
    hosting a match (masks.ZonePodAffinityBit). A never-matching
    selector is KEPT as a term: no resident can ever match it, so every
    node refuses the carrier — exactly the scheduler's verdict for an
    unsatisfiable positive requirement."""
    req = paff.get("requiredDuringSchedulingIgnoredDuringExecution")
    if not req:
        return (), (), False
    if not isinstance(req, list):
        return (), (), True
    host: list = []
    zone: list = []
    for term in req:
        if not isinstance(term, dict):
            return (), (), True
        topo = term.get("topologyKey")
        if topo == "kubernetes.io/hostname":
            out = host
        elif topo == ZONE_TOPOLOGY_KEY:
            out = zone
        else:
            return (), (), True
        decoded, _nothing, unmodeled = _decode_term(term, namespace)
        if unmodeled:
            return (), (), True
        out.append(decoded)
    return tuple(sorted(set(host))), tuple(sorted(set(zone))), False


# Fields whose NON-DEFAULT values change PodTopologySpread counting
# semantics in ways this model does not reproduce. Round 5: an explicit
# DEFAULT value is semantically identical to the field being absent and
# is accepted (common in manifests that spell out defaults) — the
# model's existing conservatism analysis already covers the default
# semantics: nodeTaintsPolicy=Ignore IS how the counts are computed
# (dead/tainted nodes' domains and pods counted), and
# nodeAffinityPolicy=Honor is deliberately over-approximated (ignoring
# the affinity filter only ever lowers the domain min — stricter, the
# safe direction). minDomains=null and matchLabelKeys=[] are the
# absent-equivalent encodings of their fields. Anything else stays
# conservatively unmodeled.
def _spread_modifiers_default(c: dict) -> bool:
    """True iff every present counting-modifier field carries its
    default-equivalent value (exact lockstep with native/ingest.cc
    ``spread_modifier_is_default``): minDomains null / integer 1 (nil
    behaves as 1 per KEP-3022 — a non-int 1.0 is rejected, matching
    the native text comparison), matchLabelKeys null / [],
    nodeAffinityPolicy null / "Honor", nodeTaintsPolicy null /
    "Ignore"."""
    if "minDomains" in c:
        v = c["minDomains"]
        if v is not None and not (
            isinstance(v, int) and not isinstance(v, bool) and v == 1
        ):
            return False
    if "matchLabelKeys" in c:
        v = c["matchLabelKeys"]
        if v is not None and v != []:
            return False
    if "nodeAffinityPolicy" in c:
        v = c["nodeAffinityPolicy"]
        if v is not None and v != "Honor":
            return False
    if "nodeTaintsPolicy" in c:
        v = c["nodeTaintsPolicy"]
        if v is not None and v != "Ignore":
            return False
    return True
# Spread topology is generic: the verdict machinery keys counts and
# domains by the constraint's OWN topology key (masks.SpreadBit /
# compute_spread_bit read node.labels[topology_key] directly), so ANY
# label key works — unlike zone anti-affinity, whose zone-salted
# machinery is specific to the standard zone label. Round 5 lifts the
# hostname/zone-only restriction; the key only needs to be a non-empty
# sep-byte-free string (native blob framing).


def decode_topology_spread(spread) -> tuple:
    """(canonical hard constraints, unmodeled) for a pod's
    topologySpreadConstraints list.

    Modeled (in exact lockstep with native/ingest.cc): each HARD entry
    (whenUnsatisfiable absent or DoNotSchedule — the k8s default) with
    ANY non-empty sep-free topologyKey (round 5 — the SpreadBit
    machinery is generic over the key), integer maxSkew >= 1, a non-empty
    selector in the round-5 widened operator form (matchLabels and/or
    matchExpressions with In/NotIn/Exists/DoesNotExist; spread is
    always own-namespace per the k8s API), and counting-semantics
    modifier fields only at their default-equivalent values
    (``_spread_modifiers_default``). Explicit ScheduleAnyway
    entries are soft — advisory to the real scheduler — and dropped.
    Any hard entry beyond the canonical shape marks the whole pod
    unmodeled (conservatively unplaceable). Canonical form:
    (topology_key, max_skew, selector requirements), entry list
    sorted+deduped. A never-matching selector needs no special case:
    its domain counts are all zero, so its verdict refuses nothing —
    exactly the scheduler's behavior."""
    if not spread:
        return (), False
    if not isinstance(spread, list):
        return (), True
    out = []
    for c in spread:
        if not isinstance(c, dict):
            return (), True
        if c.get("whenUnsatisfiable", "DoNotSchedule") == "ScheduleAnyway":
            continue  # soft: the scheduler only prefers, never refuses
        if not _spread_modifiers_default(c):
            return (), True
        topo = c.get("topologyKey")
        if not isinstance(topo, str) or not topo or _has_sep_bytes(topo):
            return (), True
        skew = c.get("maxSkew")
        if not isinstance(skew, int) or isinstance(skew, bool) or skew < 1:
            return (), True
        decoded, _nothing, unmodeled = _decode_term(
            {"labelSelector": c.get("labelSelector")}, "default"
        )
        if unmodeled:
            return (), True
        out.append((topo, skew, decoded[1]))
    return tuple(sorted(set(out))), False


def decode_volume_snapshots(pvc_items, pv_items) -> tuple:
    """(pvc-by-uid, pv-by-name) maps from decoded LIST items — THE
    keying convention ``models/volumes.resolve_volume_affinity`` reads;
    shared by the polling client and the planner sidecar so the two
    can never drift."""
    pvcs = {(c := decode_pvc(o)).uid: c for o in pvc_items}
    pvs = {(v := decode_pv(o)).name: v for o in pv_items}
    return pvcs, pvs


def decode_pvc(obj: dict) -> "PVCSpec":
    from k8s_spot_rescheduler_tpu_torch.models.cluster import PVCSpec

    meta = obj.get("metadata", {})
    return PVCSpec(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        volume_name=(obj.get("spec", {}) or {}).get("volumeName", "") or "",
        phase=(obj.get("status", {}) or {}).get("phase", "") or "",
    )


def decode_pv(obj: dict) -> "PVSpec":
    """PV node-affinity (spec.nodeAffinity.required is a plain
    NodeSelector) reuses the pod-side canonicalizer by wrapping it in the
    requiredDuringScheduling envelope — identical modeled/unmodeled
    rules, so PV terms can merge straight into pod terms."""
    from k8s_spot_rescheduler_tpu_torch.models.cluster import PVSpec

    meta = obj.get("metadata", {})
    naff = (obj.get("spec", {}) or {}).get("nodeAffinity")
    terms: tuple = ()
    unmodeled = False
    if naff is not None:
        if not isinstance(naff, dict):
            unmodeled = True
        else:
            required = naff.get("required")
            if required is not None:
                if not required:
                    # present-but-empty NodeSelector: the scheduler's
                    # matcher treats non-nil empty terms as matching NO
                    # node — resolving it as "no constraint" would be
                    # the unsafe direction, so: unmodeled
                    unmodeled = True
                else:
                    terms, unmodeled = decode_node_affinity(
                        {"requiredDuringSchedulingIgnoredDuringExecution":
                             required}
                    )
    return PVSpec(
        name=meta.get("name", ""),
        node_affinity=terms,
        unmodeled=unmodeled,
    )


def decode_node(obj: dict) -> NodeSpec:
    meta = obj.get("metadata", {})
    spec = obj.get("spec", {})
    status = obj.get("status", {})
    allocatable = {
        name: _decode_quantity(name, value)
        for name, value in (status.get("allocatable", {}) or {}).items()
    }
    taints = [
        Taint(t.get("key", ""), t.get("value", ""), t.get("effect", "NoSchedule"))
        for t in spec.get("taints", []) or []
    ]
    ready = any(
        c.get("type") == "Ready" and c.get("status") == "True"
        for c in status.get("conditions", []) or []
    )
    return NodeSpec(
        name=meta.get("name", ""),
        labels=meta.get("labels", {}) or {},
        allocatable=allocatable,
        taints=taints,
        ready=ready,
        unschedulable=bool(spec.get("unschedulable", False)),
    )


def decode_pdb(obj: dict) -> PDBSpec:
    """Round 5: the PDB selector parses the full
    matchLabels/matchExpressions surface via the shared term decoder.
    Shapes beyond it fall back to the EMPTY selector — which for a PDB
    means "every pod in the namespace", the conservative direction (an
    unparseable PDB must block drains, never under-protect; the
    apiserver additionally enforces PDBs on the eviction subresource,
    so this conservatism costs drains, not safety)."""
    from k8s_spot_rescheduler_tpu_torch.predicates.selectors import MATCH_NOTHING

    meta = obj.get("metadata", {})
    sel = (obj.get("spec", {}) or {}).get("selector")
    if sel is None:
        # policy/v1: a NIL selector selects zero pods
        # (labels.Nothing()) — distinct from {} which selects all
        reqs: tuple = MATCH_NOTHING
    else:
        decoded, _nothing, unmodeled = _decode_term(
            {"labelSelector": sel if isinstance(sel, dict) else {}},
            "default",
        )
        if unmodeled:
            # empty selector ({} -> select-all) is also routed here by
            # the term decoder (it refuses empty selectors); both land
            # on the conservative select-all shape a PDB defines for {}
            reqs = ()
        else:
            reqs = decoded[1]
    return PDBSpec(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        match_labels=reqs,
        disruptions_allowed=int(
            obj.get("status", {}).get("disruptionsAllowed", 0) or 0
        ),
    )


class KubeClusterClient:
    """ClusterClient + EventSink over the apiserver REST API."""

    def __init__(
        self,
        base_url: str,
        *,
        token: str = "",
        token_file: str = "",
        ca_file: str = "",
        client_cert: str = "",
        client_key: str = "",
        insecure: bool = False,
        retry_max: int = 4,
        retry_base: float = 0.25,
        retry_sleep=None,
    ):
        self.base_url = base_url.rstrip("/")
        self.token = token
        # Transient-failure retry policy for READ verbs (GET): up to
        # retry_max additional attempts with jittered exponential backoff
        # from retry_base seconds, honoring Retry-After. Writes (evict /
        # taint / events) stay single-attempt: the actuator owns their
        # retry cadence (scaler.go:47-62), and a blind HTTP-level re-send
        # could double-apply a non-idempotent mutation.
        self.retry_max = int(retry_max)
        self.retry_base = float(retry_base)
        self._retry_sleep = retry_sleep or _time.sleep
        # private urandom-seeded instance: jitter must decorrelate
        # replicas/restarts (a fixed seed would synchronize the herd it
        # exists to spread) without perturbing global random state
        self._retry_rng = random.Random()
        # projected SA tokens rotate on disk (~1h TTL); when reading from a
        # file, re-read per request like client-go does
        self.token_file = token_file
        ctx = ssl.create_default_context(
            cafile=ca_file if ca_file else None
        )
        if client_cert:
            ctx.load_cert_chain(client_cert, client_key or None)
        if insecure:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        self._ctx = ctx
        # one LIST of all pods per tick, partitioned client-side
        self._pods_cache: Optional[Dict[str, List[PodSpec]]] = None
        # one LIST of all nodes per tick, split by readiness: the ready
        # and unready views MUST come from one snapshot — two separate
        # LISTs could miss a node flipping unready->ready between them,
        # silently dropping its pods from spread/zone presence (the
        # permissive direction; advisor r4)
        self._nodes_cache: Optional[tuple] = None
        # native LIST decoding (io/native_ingest.py); the CLI clears this
        # when the configured resources exceed the native schema
        self.use_native_ingest = True

    # --- plumbing ---

    def _open(self, method: str, path: str, body: Optional[dict],
              timeout: float):
        """Authorized HTTP round trip; returns the open response."""
        url = self.base_url + path
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if body is not None:
            # merge-patch replaces lists wholesale — required for taint
            # removal (strategic merge keeps omitted keyed list entries)
            content_type = (
                "application/merge-patch+json"
                if method == "PATCH"
                else "application/json"
            )
            req.add_header("Content-Type", content_type)
        token = self.token
        if self.token_file:
            with open(self.token_file) as fh:
                token = fh.read().strip()
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        ctx = self._ctx if url.startswith("https") else None
        return urllib.request.urlopen(req, context=ctx, timeout=timeout)

    def _read_retrying(self, method: str, path: str, timeout: float) -> bytes:
        """One read request (open + body), retried with jittered
        exponential backoff on transient failures (429/5xx/connection —
        ``transient_http_error``). Honors Retry-After when the server
        sends one (the backoff never undercuts it). Each retry bumps
        ``kube_request_retries_total``; exhausting the budget bumps
        ``kube_request_failures_total`` and re-raises, at which point the
        control loop's observe-error policy skips the tick."""
        from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics

        attempt = 0
        # one span per kube READ, retries included (attempts attr):
        # the tick trace shows which apiserver call a slow observe
        # actually waited on. The path attr is redacted at dump time
        # (it can carry namespaces/pod names).
        with tracing.span("kube.get", path=path) as sp:
            while True:
                try:
                    with self._open(
                        method, path, None, timeout=timeout
                    ) as resp:
                        body = resp.read()
                    if sp is not None and attempt:
                        sp.attrs["attempts"] = attempt + 1
                    return body
                except Exception as err:  # noqa: BLE001 — classified below
                    retryable, retry_after = transient_http_error(err)
                    if not retryable:
                        raise
                    if attempt >= self.retry_max:
                        metrics.update_kube_request_failure()
                        raise
                    # full jitter around the exponential midpoint: delay
                    # in [0.5, 1.5) x base x 2^attempt, floored by
                    # Retry-After — capped: one bad header (a degraded
                    # LB answering "Retry-After: 3600") must not stall
                    # the tick for hours inside a single read; past the
                    # cap the error surfaces through the
                    # observe-skip/breaker machinery instead
                    delay = self.retry_base * (2.0 ** attempt)
                    delay *= 0.5 + self._retry_rng.random()
                    if retry_after is not None:
                        delay = max(delay, min(retry_after, RETRY_AFTER_CAP))
                    metrics.update_kube_request_retry()
                    log.vlog(
                        2,
                        "kube %s %s failed transiently (%s); "
                        "retry %d/%d in %.2fs",
                        method, path, err, attempt + 1, self.retry_max,
                        delay,
                    )
                    self._retry_sleep(delay)
                    attempt += 1

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        *,
        retries: bool = True,
    ):
        """``retries=False`` opts a READ out of the backoff loop —
        deadline-bound callers (the lease elector, whose renew cadence
        IS its retry policy and whose lease must not absorb backoff
        sleeps) handle transient failures themselves."""
        if retries and method == "GET" and body is None:
            payload = self._read_retrying("GET", path, timeout=30)
        else:
            # write verbs: single attempt (see __init__ on retry policy)
            with self._open(method, path, body, timeout=30) as resp:
                payload = resp.read()
        return json.loads(payload) if payload else {}

    def _request_raw(self, method: str, path: str) -> bytes:
        """Raw response bytes — the native ingest engine parses LIST
        bodies itself (io/native_ingest.py). Reads only: the retrying
        path must never carry a write verb (a retried write double-fires
        its side effect on a timeout whose request actually landed)."""
        if method != "GET":
            raise ValueError(
                f"_request_raw is read-only; {method} must go through "
                "_request"
            )
        return self._read_retrying("GET", path, timeout=60)

    def _stream(self, path: str, read_timeout: float = 330.0):
        """Yield newline-delimited JSON objects from a watch endpoint.

        The timeout exceeds the watch's own ``timeoutSeconds`` so an idle
        but healthy stream is closed by the server, not by us; the caller
        (io/watch.py) reconnects from the last resourceVersion either way.
        """
        with self._open("GET", path, None, timeout=read_timeout) as resp:
            for line in resp:
                line = line.strip()
                if line:
                    yield json.loads(line)

    # --- read path ---

    def refresh(self) -> None:
        """Invalidate the per-tick pod/node caches. The control loop's
        first read each tick is ``list_unschedulable_pods`` (the safety
        gate), which refreshes — so every tick sees one consistent pod
        LIST and one consistent node LIST."""
        self._pods_cache = None
        self._nodes_cache = None

    def _all_nodes(self) -> tuple:
        """(ready, unready) node views from ONE GET /api/v1/nodes per
        tick — a single snapshot split by readiness, so a node flipping
        between the two reads can never vanish from both views (and the
        heaviest LIST is paid once, not twice)."""
        if self._nodes_cache is None:
            from k8s_spot_rescheduler_tpu_torch.io import native_ingest

            nodes = None
            if self.use_native_ingest and native_ingest.available():
                batch = native_ingest.parse_node_list(
                    self._request_raw("GET", "/api/v1/nodes")
                )
                if batch is not None:
                    nodes = batch.views()
            if nodes is None:
                items = self._request("GET", "/api/v1/nodes").get("items", [])
                nodes = [decode_node(o) for o in items]
            self._nodes_cache = (
                [n for n in nodes if n.ready],
                [n for n in nodes if not n.ready],
            )
        return self._nodes_cache

    def list_ready_nodes(self) -> List[NodeSpec]:
        # the reference's ReadyNodeLister surfaces only ready nodes
        return list(self._all_nodes()[0])

    def list_unready_nodes(self) -> List[NodeSpec]:
        """Presence-only node view (NodeMap.unready): zone/spread counts
        must span not-ready nodes' pods (they still exist to the real
        scheduler; PodTopologySpread's default nodeTaintsPolicy=Ignore
        counts their domains)."""
        return list(self._all_nodes()[1])

    def _all_pods(self) -> Dict[str, List[PodSpec]]:
        if self._pods_cache is None:
            from k8s_spot_rescheduler_tpu_torch.io import native_ingest

            pods = None
            pvc_hint = None
            if self.use_native_ingest and native_ingest.available():
                batch = native_ingest.parse_pod_list(
                    self._request_raw("GET", "/api/v1/pods")
                )
                if batch is not None:
                    pods = batch.views()
                    # exact vectorized "any pod is resolvable" — not just
                    # "any pod has a PVC", which would send every tick of
                    # a PVC-carrying cluster through a 50k-view Python
                    # scan below
                    pvc_hint = batch.any_pvc_resolvable()
            if pods is None:
                items = self._request("GET", "/api/v1/pods").get("items", [])
                pods = [decode_pod(obj) for obj in items]
            pods = self._resolve_volumes(pods, pvc_hint)
            cache: Dict[str, List[PodSpec]] = {}
            for pod in pods:
                cache.setdefault(pod.node_name, []).append(pod)
            self._pods_cache = cache
        return self._pods_cache

    def list_volume_snapshots(self):
        """(pvc-by-uid, pv-by-name) decoded from cluster-wide LISTs —
        shared by this client's polling path and the watch-mode client's
        per-tick retry. Raises on HTTP/decode failure; callers stay
        conservative."""
        return decode_volume_snapshots(
            self._request(
                "GET", "/api/v1/persistentvolumeclaims"
            ).get("items", []),
            self._request(
                "GET", "/api/v1/persistentvolumes"
            ).get("items", []),
        )

    def _resolve_volumes(self, pods, pvc_hint=None):
        """Lift PVC-pod conservatism where provable: fetch same-tick
        PVC/PV LISTs (only when some pod actually carries resolvable
        claims) and fold bound PVs' nodeAffinity into the pods
        (models/volumes.py). Any fetch/decode failure leaves the pods as
        decoded — placeable nowhere, the safe direction. ``pvc_hint``
        (the native batch path precomputes it vectorized, exactly the
        PodView.pvc_resolvable predicate) is authoritative in BOTH
        directions: False skips the per-pod scan entirely, True skips
        the redundant re-check — 50k lazy property reads per tick would
        cost real time on the hot path."""
        if pvc_hint is False:
            return pods
        if pvc_hint is None and not any(
            getattr(p, "pvc_resolvable", False) for p in pods
        ):
            return pods
        from k8s_spot_rescheduler_tpu_torch.models.volumes import (
            maybe_resolve_view,
            resolve_volume_affinity,
        )

        try:
            pvcs, pvs = self.list_volume_snapshots()
        except Exception as err:  # noqa: BLE001, exception-discipline — stay conservative: the pods remain unmodeled (the SAFE direction, blocked_candidates 'unmodeled' surfaces it) and the retry layer already counted the read failure
            log.error("PVC/PV list failed; volume pods stay unmodeled: %s", err)
            return pods
        out = []
        for pod in pods:
            if isinstance(pod, PodSpec):
                out.append(resolve_volume_affinity(pod, pvcs, pvs))
            else:  # lazy native view: materialize only if it resolves
                out.append(maybe_resolve_view(pod, pvcs, pvs) or pod)
        return out

    def list_pods_on_node(self, node_name: str) -> List[PodSpec]:
        return list(self._all_pods().get(node_name, []))

    def list_unschedulable_pods(self) -> List[PodSpec]:
        # reference NewUnschedulablePodLister: pending pods with no node.
        # The control loop calls this FIRST each tick (the safety gate), so
        # it must refresh the per-tick pod cache — a stale view here would
        # let a drain proceed while pods are already unschedulable.
        self.refresh()
        return [
            p
            for p in self._all_pods().get("", [])
            if p.phase == "Pending"
        ]

    def list_pdbs(self) -> List[PDBSpec]:
        items = self._request(
            "GET", "/apis/policy/v1/poddisruptionbudgets"
        ).get("items", [])
        return [decode_pdb(o) for o in items]

    def get_pod(self, namespace: str, name: str) -> Optional[PodSpec]:
        # single-attempt: the only production caller is the drain verify
        # poll (actuator/drain.py), which already re-polls every 5 s per
        # pod until its own deadline — stacking the transport retry
        # budget under it would let one poll round overshoot
        # pod_eviction_timeout by pods x backoff
        try:
            obj = self._request(
                "GET", f"/api/v1/namespaces/{namespace}/pods/{name}",
                retries=False,
            )
        except urllib.error.HTTPError as err:
            if err.code == 404:
                return None
            raise
        return decode_pod(obj)

    # --- write path ---

    def evict_pod(self, pod: PodSpec, grace_seconds: int) -> None:
        body = {
            "apiVersion": "policy/v1",
            "kind": "Eviction",
            "metadata": {"name": pod.name, "namespace": pod.namespace},
            "deleteOptions": {"gracePeriodSeconds": int(grace_seconds)},
        }
        try:
            self._request(
                "POST",
                f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}/eviction",
                body,
            )
        except urllib.error.HTTPError as err:
            if err.code == 404:
                return  # already gone
            raise EvictionError(f"evict {pod.uid}: HTTP {err.code}") from err

    def _patch_taints(self, node_name: str, mutate) -> None:
        obj = self._request("GET", f"/api/v1/nodes/{node_name}")
        taints = (obj.get("spec", {}).get("taints", []) or [])
        self._request(
            "PATCH",
            f"/api/v1/nodes/{node_name}",
            {"spec": {"taints": mutate(taints)}},
        )

    def add_taint(self, node_name: str, taint: Taint) -> None:
        from k8s_spot_rescheduler_tpu_torch.models.cluster import (
            parse_rescheduler_taint_value,
        )

        def mutate(taints):
            entry = {"key": taint.key, "value": taint.value, "effect": taint.effect}
            # Same-key entry we own (or an empty value): REPLACE it — a
            # re-drain must refresh the ownership stamp, or the stale
            # one ages past the sweep's grace horizon under a live
            # drain. Same-key entry held by a FOREIGN writer (the
            # cluster autoscaler's bare-timestamp scale-down marker):
            # keep THEIRS untouched — overwriting would convert CA's
            # taint into one our orphan sweep may later remove,
            # aborting CA's node deletion.
            for t in taints:
                if t.get("key") != taint.key:
                    continue
                value = t.get("value") or ""
                if value and parse_rescheduler_taint_value(value) is None:
                    return taints  # foreign holder: leave their entry
            return [t for t in taints if t.get("key") != taint.key] + [entry]

        self._patch_taints(node_name, mutate)

    def remove_taint(self, node_name: str, taint_key: str) -> None:
        self._patch_taints(
            node_name,
            lambda taints: [t for t in taints if t.get("key") != taint_key],
        )

    # --- event sink (reference createEventRecorder, rescheduler.go:327) ---

    def event(
        self, kind: str, name: str, event_type: str, reason: str, message: str
    ) -> None:
        namespace = "default"
        obj_name = name
        if kind == "Pod" and "/" in name:
            namespace, obj_name = name.split("/", 1)
        body = {
            "metadata": {"generateName": "spot-rescheduler-"},
            "involvedObject": {"kind": kind, "name": obj_name,
                               "namespace": namespace if kind == "Pod" else ""},
            "type": event_type,
            "reason": reason,
            "message": message,
            "source": {"component": "rescheduler"},
        }
        try:
            self._request(
                "POST", f"/api/v1/namespaces/{namespace}/events", body
            )
        except Exception as err:  # noqa: BLE001, exception-discipline — events are best-effort decoration by contract (the reference's recorder is fire-and-forget too); nothing degrades when one is lost
            log.vlog(4, "event post failed: %s", err)


def from_environment(
    running_in_cluster: bool, kubeconfig: str = ""
) -> KubeClusterClient:
    """createKubeClient equivalent (reference rescheduler.go:304-324)."""
    if running_in_cluster:
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        return KubeClusterClient(
            f"https://{host}:{port}",
            token_file=os.path.join(SA_DIR, "token"),
            ca_file=os.path.join(SA_DIR, "ca.crt"),
        )

    import yaml

    kubeconfig = kubeconfig or os.path.expanduser("~/.kube/config")
    with open(kubeconfig) as fh:
        cfg = yaml.safe_load(fh)
    ctx_name = cfg.get("current-context")
    ctx = next(
        c["context"] for c in cfg.get("contexts", []) if c["name"] == ctx_name
    )
    cluster = next(
        c["cluster"]
        for c in cfg.get("clusters", [])
        if c["name"] == ctx["cluster"]
    )
    user = next(
        u["user"] for u in cfg.get("users", []) if u["name"] == ctx["user"]
    )

    def materialize(data_key: str, file_key: str, blob: dict) -> str:
        if file_key in blob:
            return blob[file_key]
        if data_key in blob:
            fh = tempfile.NamedTemporaryFile(delete=False, suffix=".pem")
            fh.write(base64.b64decode(blob[data_key]))
            fh.close()
            return fh.name
        return ""

    return KubeClusterClient(
        cluster["server"],
        token=user.get("token", ""),
        ca_file=materialize(
            "certificate-authority-data", "certificate-authority", cluster
        ),
        client_cert=materialize(
            "client-certificate-data", "client-certificate", user
        ),
        client_key=materialize("client-key-data", "client-key", user),
        insecure=bool(cluster.get("insecure-skip-tls-verify", False)),
    )

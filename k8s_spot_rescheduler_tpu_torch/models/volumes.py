"""Volume-topology resolution: PVC -> PV -> node-affinity.

The reference inherits volume predicates from the real scheduler
(``CheckPredicates``; predicate list reference README.md:103-114): a pod
whose PersistentVolumeClaim is bound to a zonal or local PV can only run
on nodes matching the PV's ``spec.nodeAffinity``. Decode marks every
PVC-bearing pod conservatively unplaceable (io/kube.decode_pod) — this
module is the step that LIFTS that conservatism when it can prove more:

- every claim the pod references must exist, be Bound, and name a known
  PV whose nodeAffinity is absent or in the canonical modeled form;
- the PVs' terms are ANDed into the pod's own requirement by term
  distribution (masks.merge_affinity_terms), so the result rides the
  existing NodeAffinityBit pseudo-taint machinery with zero solver or
  packer changes;
- anything else (unbound claim, missing PV, unmodeled PV affinity, term
  blow-up) leaves the pod exactly as decode made it: placeable nowhere.

Resolution happens where pods enter the model — the polling kube client
decorates its LIST results using same-tick PVC/PV LISTs, the fake
cluster decorates at add_pod, and the watch-mode client resolves at
event decode plus a per-tick retry for late bindings
(io/watch.WatchingKubeClusterClient._refresh_volumes). Bindings are
immutable for running pods — the only pods the planner ever moves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from k8s_spot_rescheduler_tpu_torch.models.cluster import PodSpec, PVCSpec, PVSpec
from k8s_spot_rescheduler_tpu_torch.predicates.masks import merge_affinity_terms


def resolve_volume_affinity(
    pod: PodSpec,
    pvcs: Dict[str, PVCSpec],  # keyed by "namespace/name"
    pvs: Dict[str, PVSpec],  # keyed by PV name
) -> PodSpec:
    """Return the pod with its PVCs' volume topology folded into
    ``node_affinity``, or the pod unchanged when that cannot be proven
    (fail-safe: unchanged means placeable nowhere)."""
    if not pod.pvc_resolvable or not pod.pvc_names:
        return pod
    term_sets = [pod.node_affinity]
    for claim in pod.pvc_names:
        pvc = pvcs.get(f"{pod.namespace}/{claim}")
        if pvc is None or pvc.phase != "Bound" or not pvc.volume_name:
            return pod
        pv = pvs.get(pvc.volume_name)
        if pv is None or pv.unmodeled:
            return pod
        if pv.node_affinity:
            term_sets.append(pv.node_affinity)
    merged = merge_affinity_terms(*term_sets)
    if merged is None:  # term blow-up: stay conservative
        return pod
    return dataclasses.replace(
        pod,
        node_affinity=merged,
        unmodeled_constraints=False,
        pvc_resolvable=False,
    )


def maybe_resolve_view(pod, pvc_map, pv_map) -> Optional[PodSpec]:
    """Native-path helper: a lazy PodView only needs materializing when
    it actually carries resolvable claims; returns the resolved PodSpec
    then, else None (keep the view)."""
    if not getattr(pod, "pvc_resolvable", False):
        return None
    spec = pod.to_pod_spec()
    resolved = resolve_volume_affinity(spec, pvc_map, pv_map)
    return resolved if resolved is not spec else None


def terminally_unresolvable(pod: PodSpec, pvcs, pvs) -> bool:
    """True when resolution failed for a reason that can never clear:
    every claim is Bound to a PRESENT PV, yet resolution still declined
    (an unmodeled PV affinity shape, or term blow-up). PV affinity is
    immutable, so retrying such a pod re-LISTs the cluster's volumes
    every tick for zero possible progress — the watch client flips its
    ``pvc_resolvable`` off instead (staying unmodeled: conservative)."""
    for claim in pod.pvc_names:
        pvc = pvcs.get(f"{pod.namespace}/{claim}")
        if pvc is None or pvc.phase != "Bound" or not pvc.volume_name:
            return False  # binding may still happen: keep retrying
        if pvs.get(pvc.volume_name) is None:
            return False  # PV may still appear
    return True

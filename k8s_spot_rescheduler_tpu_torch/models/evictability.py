"""Evictability filter: which pods may be moved off a node, and which pods
block the whole drain.

Framework equivalent of the cluster-autoscaler ``GetPodsForDeletionOnNodeDrain``
call (reference rescheduler.go:231 with ``deleteNonReplicated`` flag,
``skipNodesWithSystemPods=false``, ``skipNodesWithLocalStorage=false``) plus
the reference's second DaemonSet ownerRef pass (rescheduler.go:241-256).

Semantics (the reference's observable behavior, per README.md:103-114 and
the call sites):

- mirror (static) pods are skipped silently — they vanish with the node;
- DaemonSet-controlled pods are skipped silently (rescheduler.go:243-252);
- pods in a Succeeded/Failed phase are skipped — nothing to move;
- a pod with no controller owner reference **blocks the drain** unless
  ``delete_non_replicated`` is set (reference flag rescheduler.go:84; a
  blocking pod aborts the whole node, rescheduler.go:232-238 logs it and
  ``continue``s to the next node);
- a pod covered by a PodDisruptionBudget with no disruptions left **blocks
  the drain**;
- everything else is returned as "must be replanned onto spot nodes".
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from k8s_spot_rescheduler_tpu_torch.models.cluster import PDBSpec, PodSpec


@dataclasses.dataclass
class BlockingPod:
    pod: PodSpec
    reason: str


def get_pods_for_deletion(
    pods: Sequence[PodSpec],
    pdbs: Sequence[PDBSpec],
    *,
    delete_non_replicated: bool = False,
) -> Tuple[List[PodSpec], Optional[BlockingPod]]:
    """Return (pods that must be re-placed to drain the node, blocking pod).

    If a blocking pod is returned the node must not be drained this tick —
    the caller skips it, like reference rescheduler.go:232-239.
    """
    result: List[PodSpec] = []
    for pod in pods:
        if pod.is_mirror():
            continue
        if pod.phase in ("Succeeded", "Failed"):
            continue
        if pod.is_daemonset():
            continue
        if pod.controller_ref() is None and not delete_non_replicated:
            return [], BlockingPod(pod, "pod is not replicated")
        for pdb in pdbs:
            if pdb.selects(pod) and pdb.disruptions_allowed < 1:
                return [], BlockingPod(
                    pod, f"not enough pod disruption budget ({pdb.name})"
                )
        result.append(pod)
    return result, None

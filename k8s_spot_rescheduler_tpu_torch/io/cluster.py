"""The cluster-communication boundary.

The reference's "distributed backend" is the Kubernetes apiserver reached
through client-go: watch-cache listers for ready nodes / PDBs /
unschedulable pods (reference rescheduler.go:154-156), per-node pod LISTs
(nodes/nodes.go:129-145), the eviction subresource and taint updates
(scaler/scaler.go:58, 77) and the event sink (rescheduler.go:327-332).
``ClusterClient`` is that surface as one protocol; implementations:

- ``io.fake.FakeCluster`` — in-memory simulated cluster (descendant of the
  reference tests' ``fake.Clientset`` reactor, nodes/nodes_test.go:424-449)
  used by unit tests, the replay harness and the benchmarks;
- a real-cluster shim (kube API over HTTPS) plugs in behind the same
  protocol without touching loop/planner/actuator code.
"""

from __future__ import annotations

from typing import List, Optional, Protocol

from k8s_spot_rescheduler_tpu_torch.models.cluster import (
    NodeSpec,
    PDBSpec,
    PodSpec,
    Taint,
)


class EvictionError(Exception):
    """A pod eviction was rejected (apiserver error / PDB enforcement)."""


class EventSink(Protocol):
    """k8s Event recorder equivalent (reference rescheduler.go:327-332)."""

    def event(
        self, kind: str, name: str, event_type: str, reason: str, message: str
    ) -> None: ...


class ClusterClient(Protocol):
    # --- read path (lister equivalents) ---
    def list_ready_nodes(self) -> List[NodeSpec]: ...
    def list_pods_on_node(self, node_name: str) -> List[PodSpec]: ...
    def list_unschedulable_pods(self) -> List[PodSpec]: ...
    def list_pdbs(self) -> List[PDBSpec]: ...
    def get_pod(self, namespace: str, name: str) -> Optional[PodSpec]: ...

    # --- write path (actuation) ---
    def evict_pod(self, pod: PodSpec, grace_seconds: int) -> None: ...
    def add_taint(self, node_name: str, taint: Taint) -> None: ...
    def remove_taint(self, node_name: str, taint_key: str) -> None: ...

"""Scripted in-memory apiserver for the watch protocol — no HTTP, no
threads, no real time.

``tests/test_watch.py`` exercises the watch stack over a real streaming
HTTP stub, which is the right fidelity for protocol tests but the wrong
substrate for a *soak*: hundreds of ticks with injected stalls must run
on a virtual clock, and a virtual clock cannot coexist with watcher
threads blocked in real socket reads. ``ScriptedWatchSource`` provides
the exact surface the watch stack consumes — ``_request`` for LISTs,
``_stream`` for watch streams, plus the full ``ClusterClient`` read and
write verbs for the freshness gate's direct-LIST bypass and the drain
path — over plain dicts of raw API objects, so a soak drives
``Watcher.step()`` synchronously and deterministically (the seeded soak
in ``bench.py --watch-soak`` and tests/test_freshness.py).

Chaos composes the same way as production: wrap this source in a
``ChaosClusterClient`` (whose ``_stream`` hook injects drops, scripted
410s, and open-but-silent stalls) and hand THAT to
``WatchingKubeClusterClient``.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

from k8s_spot_rescheduler_tpu_torch.io.cluster import EvictionError
from k8s_spot_rescheduler_tpu_torch.io.kube import decode_node, decode_pdb, decode_pod
from k8s_spot_rescheduler_tpu_torch.models.cluster import (
    NodeSpec,
    PDBSpec,
    PodSpec,
    Taint,
)

RESOURCES = {
    "/api/v1/nodes": "nodes",
    "/api/v1/pods": "pods",
    "/apis/policy/v1/poddisruptionbudgets": "pdbs",
}


def raw_node(name: str, role: str, *, cpu_millis: int = 4000,
             ready: bool = True) -> dict:
    return {
        "metadata": {"name": name, "uid": f"uid-{name}",
                     "labels": {"kubernetes.io/role": role},
                     "resourceVersion": "1"},
        "spec": {},
        "status": {
            "allocatable": {"cpu": f"{cpu_millis}m", "memory": "8Gi",
                            "pods": "110"},
            "conditions": [
                {"type": "Ready", "status": "True" if ready else "False"}
            ],
        },
    }


def raw_pod(name: str, node: str, *, cpu_millis: int = 100,
            phase: str = "Running") -> dict:
    return {
        "metadata": {
            "name": name, "namespace": "default", "uid": f"uid-{name}",
            "labels": {"app": name}, "resourceVersion": "1",
            "ownerReferences": [
                {"kind": "ReplicaSet", "name": f"{name}-rs",
                 "controller": True}
            ],
        },
        "spec": {
            "nodeName": node,
            "containers": [
                {"resources": {"requests": {"cpu": f"{cpu_millis}m",
                                            "memory": "64Mi"}}}
            ],
        },
        "status": {"phase": phase},
    }


class ScriptedWatchSource:
    """Raw-dict apiserver double serving LIST + WATCH + the ClusterClient
    verbs, fully synchronous. Watch streams drain the currently queued
    events and then end (a server-side close); nothing blocks."""

    def __init__(self) -> None:
        self.objects: Dict[str, Dict[str, dict]] = {
            "nodes": {}, "pods": {}, "pdbs": {},
        }
        self.rv = {"nodes": 10, "pods": 10, "pdbs": 10}
        self.queues: Dict[str, collections.deque] = {
            r: collections.deque() for r in self.rv
        }
        self.list_count = {r: 0 for r in self.rv}
        self.stream_count = {r: 0 for r in self.rv}
        self.watch_params: List[tuple] = []  # (resource, rv or None)
        # ClusterClient read verbs served straight off the dicts (the
        # freshness gate's direct-LIST bypass path) — counted separately
        # from the watch stack's _request LISTs
        self.direct_reads = 0
        self.evictions: List[str] = []
        self.events: List[tuple] = []
        # the watch path skips the native LIST decoder (raw dicts here
        # never pass through real HTTP bodies)
        self.use_native_ingest = False

    # --- state mutation (the "cluster" changing) ---

    def push(self, resource: str, etype: str, obj: dict) -> None:
        """Apply a change and queue its watch event (like a real
        apiserver: state and stream advance together)."""
        self.rv[resource] += 1
        obj = dict(obj)
        obj["metadata"] = dict(
            obj["metadata"], resourceVersion=str(self.rv[resource])
        )
        uid = obj["metadata"]["uid"]
        if etype == "DELETED":
            self.objects[resource].pop(uid, None)
        else:
            self.objects[resource][uid] = obj
        self.queues[resource].append({"type": etype, "object": obj})

    def bookmark(self, resource: str) -> None:
        self.rv[resource] += 1
        self.queues[resource].append({
            "type": "BOOKMARK",
            "object": {"metadata": {
                "resourceVersion": str(self.rv[resource])
            }},
        })

    # --- watch-stack plumbing (what Watcher consumes) ---

    def _request(self, method: str, path: str, body=None, **kwargs):
        base = path.split("?", 1)[0]
        resource = RESOURCES.get(base)
        if method == "GET" and resource is not None:
            self.list_count[resource] += 1
            self.rv[resource] += 1
            return {
                "metadata": {"resourceVersion": str(self.rv[resource])},
                "items": list(self.objects[resource].values()),
            }
        raise ValueError(f"scripted source: unsupported {method} {path}")

    def _stream(self, path: str, read_timeout: float = 330.0):
        base, _, query = path.partition("?")
        resource = RESOURCES[base]
        self.stream_count[resource] += 1
        rv = None
        for part in query.split("&"):
            if part.startswith("resourceVersion="):
                rv = part.split("=", 1)[1]
        self.watch_params.append((resource, rv))
        q = self.queues[resource]
        while q:
            yield q.popleft()
        # queue drained: the server closes the stream (timeoutSeconds)

    def list_volume_snapshots(self):
        return {}, {}

    # --- ClusterClient read verbs (the direct-LIST bypass path) ---

    def refresh(self) -> None:
        pass

    def _nodes(self) -> List[NodeSpec]:
        return [decode_node(o) for o in self.objects["nodes"].values()]

    def _pods(self) -> List[PodSpec]:
        return [decode_pod(o) for o in self.objects["pods"].values()]

    def list_ready_nodes(self) -> List[NodeSpec]:
        self.direct_reads += 1
        return [n for n in self._nodes() if n.ready]

    def list_unready_nodes(self) -> List[NodeSpec]:
        self.direct_reads += 1
        return [n for n in self._nodes() if not n.ready]

    def list_pods_on_node(self, node_name: str) -> List[PodSpec]:
        self.direct_reads += 1
        return [p for p in self._pods() if p.node_name == node_name]

    def list_unschedulable_pods(self) -> List[PodSpec]:
        self.direct_reads += 1
        return [
            p for p in self._pods()
            if not p.node_name and p.phase == "Pending"
        ]

    def list_pdbs(self) -> List[PDBSpec]:
        self.direct_reads += 1
        return [decode_pdb(o) for o in self.objects["pdbs"].values()]

    def get_pod(self, namespace: str, name: str) -> Optional[PodSpec]:
        for obj in self.objects["pods"].values():
            meta = obj["metadata"]
            if meta["name"] == name and meta["namespace"] == namespace:
                return decode_pod(obj)
        return None

    # --- write verbs (the drain path; state changes flow back into the
    # watch streams exactly like a real apiserver) ---

    def evict_pod(self, pod: PodSpec, grace_seconds: int) -> None:
        for obj in list(self.objects["pods"].values()):
            if (
                obj["metadata"]["name"] == pod.name
                and obj["metadata"]["namespace"] == pod.namespace
            ):
                self.evictions.append(pod.name)
                self.push("pods", "DELETED", obj)
                return
        raise EvictionError(f"evict {pod.uid}: not found")

    def _patch_taints(self, node_name: str, mutate) -> None:
        for obj in self.objects["nodes"].values():
            if obj["metadata"]["name"] == node_name:
                taints = list(obj["spec"].get("taints", []) or [])
                obj = dict(obj, spec=dict(obj["spec"], taints=mutate(taints)))
                self.push("nodes", "MODIFIED", obj)
                return
        raise KeyError(node_name)

    def add_taint(self, node_name: str, taint: Taint) -> None:
        entry = {"key": taint.key, "value": taint.value,
                 "effect": taint.effect}
        self._patch_taints(
            node_name,
            lambda ts: [t for t in ts if t.get("key") != taint.key] + [entry],
        )

    def remove_taint(self, node_name: str, taint_key: str) -> None:
        self._patch_taints(
            node_name,
            lambda ts: [t for t in ts if t.get("key") != taint_key],
        )

    # --- event sink ---

    def event(self, kind, name, event_type, reason, message) -> None:
        self.events.append((kind, name, event_type, reason, message))

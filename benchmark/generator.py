"""The benchmark's one generator: a cluster and its churn, from a seed.

``draw_cluster`` is a frozen copy of the cluster builder of
``k8s_spot_rescheduler_tpu_torch/io/synthetic.py`` (``generate_cluster``
at commit ff5fa8423fbb72910a77038441847ae0cfea3599), drawing the same
numbers in the same order, but it emits plain records instead of the
program's objects and reads its knobs from a configuration file
(``configs/<name>.json``, key ``deployment``). ``generate_cluster``
draws the deployment's one cluster (its ``structure_seed``) and hands it
over in an order drawn from the run's seed. ``Churn`` is the traffic,
at the rates a traffic file (``traffic/<name>.json``) names: each call
stands for one housekeeping tick, with Poisson spot interruptions and as
many replacement spot nodes (of the three shapes) at a rate a spot node
a month, and a fixed number of pod deletions and creations a tick that
follow the cluster's own size, toleration and affinity rules.

Records are plain dicts, so both sides are built from the same data:
``feed.py`` turns them into the program's objects, and the plain
reference (``plain.py``) reads them as they are.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional

import numpy as np

SPOT_TAINT = ("cloud.provider/spot", "true", "NoSchedule")
SPOT_TOLERATION = ("cloud.provider/spot", "true", "Equal", "NoSchedule")
HOSTNAME_LABEL = "kubernetes.io/hostname"
ZONE_LABEL = "topology.kubernetes.io/zone"
PROBES = 8  # random nodes a churned pod tries before it stays pending
MONTH_S = 30 * 86400


def _label(selector: str) -> Dict[str, str]:
    key, value = selector.split("=", 1)
    return {key: value}


class Cluster:
    """The cluster as plain records, in insertion order (the order the
    program's mirror sees them): ``nodes`` name -> node, ``pods`` uid ->
    pod, ``by_node`` name -> {uid: pod}. Keeps each node's used cpu,
    memory, ephemeral storage and pod count, and the live pods and spot
    nodes as lists, for uniform draws."""

    def __init__(self, dep: dict):
        self.dep = dep
        self.nodes: Dict[str, dict] = {}
        self.pods: Dict[str, dict] = {}
        self.by_node: Dict[str, Dict[str, dict]] = {}
        self.used: Dict[str, List[int]] = {}
        self.pdbs: List[dict] = []
        self._pod_list: List[str] = []
        self._pod_at: Dict[str, int] = {}
        self.spot_list: List[str] = []
        self._spot_at: Dict[str, int] = {}
        self.node_list: List[str] = []
        self._node_at: Dict[str, int] = {}

    @staticmethod
    def _push(lst, at, key):
        at[key] = len(lst)
        lst.append(key)

    @staticmethod
    def _drop(lst, at, key):
        i = at.pop(key)
        last = lst.pop()
        if last != key:
            lst[i] = last
            at[last] = i

    def is_spot(self, node: dict) -> bool:
        key, value = self.dep["spot_label"].split("=", 1)
        return node["labels"].get(key) == value

    def add_node(self, node: dict) -> None:
        self.nodes[node["name"]] = node
        self.by_node[node["name"]] = {}
        self.used[node["name"]] = [0, 0, 0, 0]
        self._push(self.node_list, self._node_at, node["name"])
        if self.is_spot(node):
            self._push(self.spot_list, self._spot_at, node["name"])

    def add_pod(self, pod: dict) -> None:
        uid = f"{pod['namespace']}/{pod['name']}"
        self.pods[uid] = pod
        self.by_node[pod["node"]][uid] = pod
        req = pod["requests"]
        u = self.used[pod["node"]]
        u[0] += req["cpu"]
        u[1] += req["memory"]
        u[2] += req["ephemeral-storage"]
        u[3] += 1
        self._push(self._pod_list, self._pod_at, uid)

    def remove_pod(self, uid: str) -> dict:
        pod = self.pods.pop(uid)
        del self.by_node[pod["node"]][uid]
        req = pod["requests"]
        u = self.used[pod["node"]]
        u[0] -= req["cpu"]
        u[1] -= req["memory"]
        u[2] -= req["ephemeral-storage"]
        u[3] -= 1
        self._drop(self._pod_list, self._pod_at, uid)
        return pod

    def remove_node(self, name: str) -> List[dict]:
        displaced = [self.remove_pod(uid) for uid in list(self.by_node[name])]
        node = self.nodes.pop(name)
        del self.by_node[name], self.used[name]
        self._drop(self.node_list, self._node_at, name)
        if self.is_spot(node):
            self._drop(self.spot_list, self._spot_at, name)
        return displaced

    def fits(self, pod: dict, name: str) -> bool:
        """Room for ``pod`` on node ``name``: cpu, memory, ephemeral
        storage and pod count under allocatable, its hard taints
        tolerated."""
        node = self.nodes[name]
        alloc, u, req = node["allocatable"], self.used[name], pod["requests"]
        if u[3] + 1 > alloc["pods"]:
            return False
        if (u[0] + req["cpu"] > alloc["cpu"]
                or u[1] + req["memory"] > alloc["memory"]
                or u[2] + req["ephemeral-storage"] > alloc["ephemeral-storage"]):
            return False
        tols = {tuple(t) for t in pod["tolerations"]}
        return all(
            tuple(t) == SPOT_TAINT and SPOT_TOLERATION in tols
            for t in node["taints"]
        )

    def random_pod(self, rng) -> str:
        return self._pod_list[int(rng.integers(0, len(self._pod_list)))]


def _node(dep: dict, rng, prefix: str, i: int, labels: dict) -> dict:
    cpu, mem, cap, eph = dep["machine_shapes"][
        rng.integers(0, len(dep["machine_shapes"]))]
    node_labels = dict(labels)
    name = f"{prefix}-{i}"
    if dep["spread"]:
        node_labels[HOSTNAME_LABEL] = name
        node_labels[ZONE_LABEL] = f"z{i % 4}"
    return {
        "name": name,
        "labels": node_labels,
        "allocatable": {"cpu": cpu, "memory": mem, "pods": cap,
                        "ephemeral-storage": eph},
        "taints": [],
    }


def _pod_cpu(dep: dict, rng, n: int) -> np.ndarray:
    z = dep["pod_cpu"]
    if dep["zipf_sizes"]:
        raw = (rng.zipf(z["zipf_a"], n) * z["unit_m"]).clip(z["min_m"], z["max_m"])
    else:
        raw = rng.integers(50, 500, n)
    return raw.astype(np.int64)


def _app_constraints(dep: dict, app: int, ns: str):
    """(anti-affinity terms, spread constraints) of an app's pods: the
    generator's sparse widened terms and hard spread (every 17th, 19th
    and 13th app; see io/synthetic.generate_cluster)."""
    spread = ()
    if dep["spread"] and app % 13 == 0:
        if app % 26 == 0:
            sel = (
                ("app", "In", (f"app-{app}", f"app-{app}-canary")),
                ("canary", "DoesNotExist", ()),
            )
        else:
            sel = (("app", f"app-{app}"),)
        spread = ((HOSTNAME_LABEL, 3, sel), (ZONE_LABEL, 4, sel))
    terms = ()
    if dep["anti_affinity"] and app % 17 == 0:
        terms += (((ns,), (("app", "In", (f"app-{app}",)),
                           ("decoy", "NotIn", ("1",)))),)
    if dep["anti_affinity"] and app % 19 == 0:
        other_ns = f"ns-{(app + 1) % 16}"
        terms += ((tuple(sorted({ns, other_ns})),
                   (("app", "In", (f"app-{app}",)),)),)
    return terms, spread


def _pod(dep, name, node, cpu, mem, eph, app, tolerations, group) -> dict:
    ns = f"ns-{app % 16}"
    terms, spread = _app_constraints(dep, app, ns)
    return {
        "name": name,
        "namespace": ns,
        "node": node,
        "requests": {"cpu": int(cpu), "memory": int(mem),
                     "ephemeral-storage": int(eph)},
        "labels": {"app": f"app-{app}"},
        "owner": ("ReplicaSet", f"app-{app}-rs"),
        "tolerations": tolerations,
        "anti_affinity_group": group,
        "anti_affinity_match": terms,
        "spread_constraints": spread,
    }


def n_apps(dep: dict) -> int:
    return max(4, dep["n_pods"] // 100)


def draw_cluster(dep: dict, seed: int) -> Cluster:
    """The cluster of deployment ``dep`` drawn from ``seed``: the random
    fill of io/synthetic.generate_cluster, biggest pods first onto the
    node with the most room under its utilization target."""
    rng = np.random.default_rng(seed)
    cl = Cluster(dep)
    od_labels = _label(dep["on_demand_label"])
    spot_labels = _label(dep["spot_label"])
    on_demand = [_node(dep, rng, "od", i, od_labels)
                 for i in range(dep["n_on_demand"])]
    spot = [_node(dep, rng, "spot", i, spot_labels)
            for i in range(dep["n_spot"])]
    for node in on_demand + spot:
        cl.add_node(node)
    for node in spot:
        if dep["taints"] and rng.random() < dep["spot_taint_share"]:
            node["taints"].append(SPOT_TAINT)

    n = dep["n_pods"]
    sizes = _pod_cpu(dep, rng, n)
    mems = sizes * rng.integers(2, 6, n).astype(np.int64) * 1024**2
    ephs = sizes * rng.integers(16, 128, n).astype(np.int64) * 1024

    all_nodes = [(nd, dep["on_demand_util"]) for nd in on_demand] + [
        (nd, dep["spot_util"]) for nd in spot]
    heap = [(-(nd["allocatable"]["cpu"] * u), 0, idx)
            for idx, (nd, u) in enumerate(all_nodes)]
    heapq.heapify(heap)
    apps = n_apps(dep)
    for p in np.argsort(-sizes):
        cpu = int(sizes[p])
        app = int(rng.integers(0, apps))
        if not heap:
            break
        neg_room, cnt, best = heap[0]
        if -neg_room < cpu:
            continue
        heapq.heappop(heap)
        node = all_nodes[best][0]
        if cnt + 1 < node["allocatable"]["pods"] - 5:
            heapq.heappush(heap, (neg_room + cpu, cnt + 1, best))
        is_spot = cl.is_spot(node)
        tolerations = []
        if dep["taints"] and (
                is_spot or rng.random() < dep["on_demand_tolerant_share"]):
            tolerations = [SPOT_TOLERATION]
        group = ""
        if dep["anti_affinity"] and rng.random() < dep["anti_affinity_share"]:
            group = f"aff-{app}"
        cl.add_pod(_pod(dep, f"pod-{p}", node["name"], cpu, mems[p], ephs[p],
                        app, tolerations, group))
    if dep["pdbs"]:
        for a in range(0, apps, 3):
            cl.pdbs.append({
                "name": f"pdb-app-{a}", "namespace": f"ns-{a % 16}",
                "match_labels": {"app": f"app-{a}"},
                "disruptions_allowed": int(rng.integers(1, 10)),
            })
    return cl


def generate_cluster(dep: dict, seed: int) -> Cluster:
    """The run's cluster: the deployment's one cluster (drawn from its
    ``structure_seed``), its nodes and pods handed over in an order drawn
    from ``seed``. Every seed gets the same sizes, placements and
    predicates, so the seed moves which of equal pods and nodes come
    first (the planner's ties), and the churn, but not the amount of
    work."""
    base = draw_cluster(dep, dep["structure_seed"])
    rng = np.random.default_rng([int(seed), 3])
    cl = Cluster(dep)
    od = [n for n in base.nodes.values() if not base.is_spot(n)]
    spot = [n for n in base.nodes.values() if base.is_spot(n)]
    for group in (od, spot):
        for i in rng.permutation(len(group)):
            cl.add_node(group[i])
    pods = list(base.pods.values())
    for i in rng.permutation(len(pods)):
        cl.add_pod(pods[i])
    cl.pdbs = base.pdbs
    return cl


class Churn:
    """The churn stream of one run: ``step()`` draws one call's events,
    applies them to ``cluster`` and returns them as operations for the
    program's side (``feed.apply``):

    - ``("remove_node", name, moved)``: a spot interruption; ``moved``
      are the displaced pods that found room on another spot node (the
      scheduler's re-placement; the rest stay pending, off the cluster);
    - ``("add_node", node)``: a replacement spot node;
    - ``("remove_pod", uid)`` and ``("add_pod", pod)``: pod churn.

    The draws depend only on the seed and the cluster, so one seed gives
    one stream."""

    def __init__(self, cluster: Cluster, traffic: dict, seed: int):
        self.cl = cluster
        self.t = traffic
        dep = cluster.dep
        # a stream of its own, apart from the cluster's (generate_replay
        # draws its events from seed + 1)
        self.rng = np.random.default_rng([int(seed), 1])
        self.spot_labels = _label(dep["spot_label"])
        tick = float(traffic["tick_s"])
        self.spot_mean = (traffic["spot_interruptions_per_node_month"]
                          * dep["n_spot"] * tick / MONTH_S)
        self.deletions = int(round(traffic["pod_deletions_per_s"] * tick))
        self.creations = int(round(traffic["pod_creations_per_s"] * tick))
        self.new_nodes = 0
        self.new_pods = 0

    def _interrupt(self, ops) -> None:
        cl, rng = self.cl, self.rng
        if not cl.spot_list:
            return
        name = cl.spot_list[int(rng.integers(0, len(cl.spot_list)))]
        displaced = cl.remove_node(name)
        moved = []
        for pod in displaced:
            target = self._place(pod, cl.spot_list)
            if target is not None and not (
                    pod["anti_affinity_group"] or pod["anti_affinity_match"]
                    or pod["spread_constraints"]):
                pod = dict(pod, node=target)
                cl.add_pod(pod)
                moved.append(pod)
        ops.append(("remove_node", name, moved))

    def _replace(self, ops) -> None:
        i = self.new_nodes
        self.new_nodes += 1
        node = _node(self.cl.dep, self.rng, "spot-new", i, self.spot_labels)
        self.cl.add_node(node)
        ops.append(("add_node", node))

    def _place(self, pod: dict, names: List[str]) -> Optional[str]:
        """The first of ``PROBES`` random nodes of ``names`` with room
        for ``pod``, or None."""
        for _ in range(PROBES):
            if not names:
                return None
            name = names[int(self.rng.integers(0, len(names)))]
            if self.cl.fits(pod, name):
                return name
        return None

    def _new_pod(self, ops) -> None:
        cl, rng, dep = self.cl, self.rng, self.cl.dep
        cpu = int(_pod_cpu(dep, rng, 1)[0])
        mem = cpu * int(rng.integers(2, 6)) * 1024**2
        eph = cpu * int(rng.integers(16, 128)) * 1024
        app = int(rng.integers(0, n_apps(dep)))
        tolerant = dep["taints"] and rng.random() < dep["on_demand_tolerant_share"]
        group = ""
        if dep["anti_affinity"] and rng.random() < dep["anti_affinity_share"]:
            group = f"aff-{app}"
        name = f"pod-c{self.new_pods}"
        self.new_pods += 1
        pod = _pod(dep, name, "", cpu, mem, eph, app,
                   [SPOT_TOLERATION] if tolerant else [], group)
        target = self._place(pod, cl.node_list)
        if target is None:
            return
        if dep["taints"] and cl.is_spot(cl.nodes[target]) and not tolerant:
            # pods on spot nodes tolerate the spot taint, as in the seed
            pod["tolerations"] = [SPOT_TOLERATION]
        pod["node"] = target
        cl.add_pod(pod)
        ops.append(("add_pod", pod))

    def step(self) -> list:
        ops: list = []
        for _ in range(int(self.rng.poisson(self.spot_mean))):
            self._interrupt(ops)
        for _ in range(int(self.rng.poisson(self.spot_mean))):
            self._replace(ops)
        for _ in range(self.deletions):
            uid = self.cl.random_pod(self.rng)
            self.cl.remove_pod(uid)
            ops.append(("remove_pod", uid))
        for _ in range(self.creations):
            self._new_pod(ops)
        return ops

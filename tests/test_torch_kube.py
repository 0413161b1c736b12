"""The port's kube client, Lease elector and watch mirror on the CPU
against the JAX package's.

- Every decoder of the port (``decode_pod``, ``decode_node``,
  ``decode_pdb``, ``decode_pvc``, ``decode_pv``) gives the JAX decoder's
  answer, field for field, on seeded raw objects: edge-case shapes
  (quantities, tolerations, affinity and spread shapes in and out of the
  modeled surface, volumes) and the ``testing.encode_*`` round trip of
  every node, pod and PDB of synthetic configs 1-4, which also decodes
  back to the object it encoded.
- ``LeaseElector``: acquire, renew, a follower standing by, a takeover
  after the holder goes quiet and the old holder's lost renew, against
  ``testing.StubApiServer`` on a virtual clock, step for step as the JAX
  elector does.
- The watch mirror (``io/watch.WatchingKubeClusterClient`` with its
  ``ColumnarFeed``): seeded by LIST, then incremental events, a BOOKMARK
  and a 410-Gone re-list; after each, the port's mirror packs equal to
  the JAX package's mirror watching the same server and to the port's
  object path over the same frozen view, as ``tests/test_watch.py``
  checks for the reference.
- The CLI against the stub: ``--cluster kube:URL --watch-cache true``
  with leader election drains as the JAX package's controller does
  through the same server (``tests/test_torch_controller.py`` holds the
  in-process runs).

Tolerance: exact everywhere.
"""

import dataclasses
import functools
import logging
import re

import numpy as np
import pytest

from k8s_spot_rescheduler_tpu.io import kube as ref_kube
from k8s_spot_rescheduler_tpu.io.lease import LeaseElector as RefElector
from k8s_spot_rescheduler_tpu.io.watch import (
    WatchingKubeClusterClient as RefWatching,
)
from k8s_spot_rescheduler_tpu.utils.clock import FakeClock as RefClock
from k8s_spot_rescheduler_tpu_torch import testing
from k8s_spot_rescheduler_tpu_torch.cli.main import main as port_main
from k8s_spot_rescheduler_tpu_torch.io import kube as port_kube
from k8s_spot_rescheduler_tpu_torch.io import synthetic as port_synthetic
from k8s_spot_rescheduler_tpu_torch.io.lease import LeaseElector
from k8s_spot_rescheduler_tpu_torch.io.watch import WatchingKubeClusterClient
from k8s_spot_rescheduler_tpu_torch.metrics import registry as port_metrics
from k8s_spot_rescheduler_tpu_torch.models import cluster as port_cluster
from k8s_spot_rescheduler_tpu_torch.models import tensors as port_tensors
from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock

ON_DEMAND = "kubernetes.io/role=worker"
SPOT = "kubernetes.io/role=spot-worker"


def _view(obj):
    """A decoded object as plain data, comparable across packages."""
    return dataclasses.asdict(obj)


# --- decoders ----------------------------------------------------------------

_QUANTITIES = ("1", "250m", "1.5", "2", "64Mi", "2Gi", "1e3", "100k", "0")


def _term(rng, ns_ok: bool = True):
    """A raw pod-affinity term, in and out of the modeled surface."""
    term = {"topologyKey": str(rng.choice(
        ["kubernetes.io/hostname", "topology.kubernetes.io/zone",
         "failure-domain.beta.kubernetes.io/zone"]))}
    roll = int(rng.integers(0, 6))
    if roll == 0:
        term["labelSelector"] = {"matchLabels": {"app": f"a{rng.integers(3)}"}}
    elif roll == 1:
        term["labelSelector"] = {"matchExpressions": [
            {"key": "app", "operator": str(rng.choice(
                ["In", "NotIn", "Exists", "DoesNotExist", "Bogus"])),
             "values": [f"a{rng.integers(3)}", "a0"]}]}
    elif roll == 2:
        term["labelSelector"] = {}
    elif roll == 3:
        term["labelSelector"] = {"matchExpressions": [
            {"key": "tier", "operator": "Exists"}],
            "matchLabels": {"app": "a1"}}
    else:
        term["labelSelector"] = {"matchLabels": {"app": "a2"}}
    if ns_ok and rng.random() < 0.3:
        term["namespaces"] = ["ns-a", "ns-b"][: int(rng.integers(1, 3))]
    if rng.random() < 0.2:
        term["namespaceSelector"] = {} if rng.random() < 0.5 else {
            "matchLabels": {"team": "x"}}
    return term


def raw_variants(seed: int, n: int = 120):
    """Seeded raw pods, nodes, PDBs, PVCs and PVs over the decoders'
    edge cases."""
    rng = np.random.default_rng(seed)
    pods, nodes, pdbs, pvcs, pvs = [], [], [], [], []
    for i in range(n):
        spec = {
            "nodeName": f"n{i % 7}" if rng.random() < 0.9 else "",
            "containers": [
                {"resources": {"requests": {
                    r: str(rng.choice(_QUANTITIES))
                    for r in ("cpu", "memory", "ephemeral-storage")
                    if rng.random() < 0.8}}}
                for _ in range(int(rng.integers(0, 3)))
            ],
        }
        if rng.random() < 0.7:
            spec["priority"] = int(rng.integers(-10, 10))
        if rng.random() < 0.5:
            spec["tolerations"] = [
                {k: v for k, v in (
                    ("key", str(rng.choice(["", "spot", "gpu"]))),
                    ("operator", str(rng.choice(["Equal", "Exists"]))),
                    ("value", "true"),
                    ("effect", str(rng.choice(["", "NoSchedule",
                                               "NoExecute"]))),
                ) if rng.random() < 0.8}
                for _ in range(int(rng.integers(1, 3)))
            ]
        if rng.random() < 0.3:
            spec["nodeSelector"] = {"pool": f"p{rng.integers(3)}"}
        affinity = {}
        if rng.random() < 0.3:
            affinity["podAntiAffinity"] = {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    _term(rng) for _ in range(int(rng.integers(1, 3)))]}
        if rng.random() < 0.2:
            affinity["podAffinity"] = {
                "requiredDuringSchedulingIgnoredDuringExecution": [_term(rng)]}
        if rng.random() < 0.3:
            op = str(rng.choice(["In", "NotIn", "Exists", "DoesNotExist",
                                 "Gt", "Lt"]))
            expr = {"key": "zone", "operator": op}
            if op in ("In", "NotIn"):
                expr["values"] = ["z1", "z0", "z1"]
            elif op in ("Gt", "Lt"):
                expr["values"] = ["3"]
            term = {"matchExpressions": [expr]}
            if rng.random() < 0.3:
                term["matchFields"] = [{"key": "metadata.name",
                                        "operator": "In", "values": ["n1"]}]
            affinity["nodeAffinity"] = {
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": [term]}}
        if affinity:
            spec["affinity"] = affinity
        if rng.random() < 0.2:
            c = {"topologyKey": str(rng.choice(
                ["kubernetes.io/hostname", "topology.kubernetes.io/zone"])),
                "maxSkew": int(rng.integers(0, 3)),
                "labelSelector": {"matchLabels": {"app": "a1"}}}
            if rng.random() < 0.3:
                c["whenUnsatisfiable"] = "ScheduleAnyway"
            if rng.random() < 0.2:
                c["minDomains"] = int(rng.integers(1, 3))
            spec["topologySpreadConstraints"] = [c]
        if rng.random() < 0.15:
            spec["volumes"] = [{"name": "v", "persistentVolumeClaim": {
                "claimName": f"claim-{i}"}}]
        meta = {"name": f"pod-{i}", "uid": f"u{i}",
                "labels": {"app": f"a{rng.integers(3)}"}}
        if rng.random() < 0.8:
            meta["namespace"] = str(rng.choice(["default", "ns-a", ""]))
        if rng.random() < 0.7:
            meta["ownerReferences"] = [{"kind": str(rng.choice(
                ["ReplicaSet", "DaemonSet", "Job"])), "name": "o",
                "controller": bool(rng.random() < 0.8)}]
        if rng.random() < 0.1:
            meta["annotations"] = {"kubernetes.io/config.mirror": "x"}
        pod = {"metadata": meta, "spec": spec}
        if rng.random() < 0.9:
            pod["status"] = {"phase": str(rng.choice(
                ["Running", "Pending", "Succeeded", "Failed"]))}
        pods.append(pod)
    for i in range(n // 4):
        node = {"metadata": {"name": f"n{i}", "labels": {
            "kubernetes.io/role": str(rng.choice(["worker", "spot-worker"]))}},
            "spec": {}, "status": {"allocatable": {
                "cpu": str(rng.choice(_QUANTITIES)), "memory": "8Gi",
                "pods": "110"}}}
        if rng.random() < 0.5:
            node["spec"]["taints"] = [{"key": "spot", "value": "true"}
                                      if rng.random() < 0.5 else
                                      {"key": "x", "effect": "NoExecute"}]
        if rng.random() < 0.2:
            node["spec"]["unschedulable"] = True
        if rng.random() < 0.9:
            node["status"]["conditions"] = [{"type": "Ready", "status": str(
                rng.choice(["True", "False", "Unknown"]))}]
        nodes.append(node)
        sel = [None, {}, {"matchLabels": {"app": "a1"}},
               {"matchExpressions": [{"key": "app", "operator": "Bogus"}]},
               {"matchExpressions": [{"key": "app", "operator": "In",
                                      "values": ["a2", "a1"]}]}][i % 5]
        pdbs.append({"metadata": {"name": f"pdb-{i}", "namespace": "ns-a"},
                     "spec": {"selector": sel},
                     "status": {"disruptionsAllowed": int(rng.integers(0, 3))}})
        pvcs.append({"metadata": {"name": f"claim-{i}", "namespace": "default"},
                     "spec": {"volumeName": f"pv-{i}"},
                     "status": {"phase": str(rng.choice(["Bound", "Pending"]))}})
        pv = {"metadata": {"name": f"pv-{i}"}, "spec": {}}
        if i % 3 == 0:
            pv["spec"]["nodeAffinity"] = {"required": {"nodeSelectorTerms": [
                {"matchExpressions": [{"key": "zone", "operator": "In",
                                       "values": ["z1"]}]}]}}
        elif i % 3 == 1:
            pv["spec"]["nodeAffinity"] = {"required": {}}
        pvs.append(pv)
    return pods, nodes, pdbs, pvcs, pvs


@pytest.mark.parametrize("seed", range(3))
def test_decoders_match_the_reference_on_edge_cases(seed):
    pods, nodes, pdbs, pvcs, pvs = raw_variants(seed)
    for name, raws in (("decode_pod", pods), ("decode_node", nodes),
                       ("decode_pdb", pdbs), ("decode_pvc", pvcs),
                       ("decode_pv", pvs)):
        for raw in raws:
            got = getattr(port_kube, name)(raw)
            want = getattr(ref_kube, name)(raw)
            assert _view(got) == _view(want), (name, raw)


def _expected_pod(pod):
    """What ``decode_pod(encode_pod(pod))`` must give: ``pod``, with its
    anti-affinity group as the label and term it encodes as."""
    if not pod.anti_affinity_group:
        return pod
    group = pod.anti_affinity_group
    term = (testing.ALL_NAMESPACES, ((testing.GROUP_LABEL, "In", (group,)),))
    return dataclasses.replace(
        pod,
        anti_affinity_group="",
        labels={**pod.labels, testing.GROUP_LABEL: group},
        anti_affinity_match=tuple(sorted({*pod.anti_affinity_match, term})),
    )


@functools.lru_cache(maxsize=None)
def _port_cluster(config_id: int):
    return port_synthetic.generate_cluster(port_synthetic.CONFIGS[config_id], 0)


@pytest.mark.parametrize("config_id", [1, 2, 3, 4])
def test_encode_round_trip_of_every_synthetic_object(config_id):
    client = _port_cluster(config_id)
    for node in client.nodes.values():
        raw = testing.encode_node(node)
        got = port_kube.decode_node(raw)
        assert _view(got) == _view(node)
        assert _view(ref_kube.decode_node(raw)) == _view(got)
    for pod in client.pods.values():
        raw = testing.encode_pod(pod)
        got = port_kube.decode_pod(raw)
        assert _view(got) == _view(_expected_pod(pod)), pod.uid
        assert _view(ref_kube.decode_pod(raw)) == _view(got), pod.uid
    for pdb in client.pdbs:
        raw = testing.encode_pdb(pdb)
        got = port_kube.decode_pdb(raw)
        assert _view(got) == _view(pdb)
        assert _view(ref_kube.decode_pdb(raw)) == _view(got)


# --- the Lease elector -------------------------------------------------------


def _lease_script(elector_cls, kube_cls, clock_cls):
    """Two electors over one stub on one virtual clock; the record of
    every step: each ensure's answer, both leadership flags and the
    lease's holder and transitions."""
    stub = testing.StubApiServer()
    try:
        clock = clock_cls()
        wall = [1_700_000_000.0]

        def mk(identity):
            return elector_cls(kube_cls(stub.url), identity=identity,
                               lease_duration=15.0, clock=clock,
                               wall=lambda: wall[0])

        a, b = mk("replica-a"), mk("replica-b")
        out = []

        def step(who, advance=0.0):
            clock.sleep(advance)
            wall[0] += advance
            got = {"a": a, "b": b}[who].ensure()
            lease = next(iter(stub.leases.values()), {}).get("spec", {})
            out.append((who, got, a.is_leader, b.is_leader,
                        lease.get("holderIdentity"),
                        lease.get("leaseTransitions")))

        step("a")  # acquires (creates the lease)
        step("b")  # follows: first observation of the holder
        step("a", 5)  # renews
        step("b", 5)  # the record changed: still following
        step("b", 10)  # quiet 10 s < 15 s: still following
        step("b", 10)  # quiet past the duration: takes over
        step("a", 1)  # the old holder's renew loses the compare-and-swap
        step("b", 5)  # renews
        step("a", 1)  # follows
        return out
    finally:
        stub.close()


def test_lease_elector_matches_the_reference():
    got = _lease_script(LeaseElector, port_kube.KubeClusterClient, FakeClock)
    want = _lease_script(RefElector, ref_kube.KubeClusterClient, RefClock)
    assert got == want
    assert [r[1] for r in got] == [True, False, True, False, False, True,
                                   False, True, False]


# --- the watch mirror --------------------------------------------------------


def _start(watching_cls, kube_cls, clock_cls, stub):
    wc = watching_cls(kube_cls(stub.url), clock=clock_cls())
    tracker = testing.MirrorTracker(wc)
    wc.start(timeout=30)
    return wc, tracker


def _mirror_pack(wc, resources):
    wc.list_unschedulable_pods()  # the tick's first read freezes the view
    store = wc.columnar_store(resources, on_demand_label=ON_DEMAND,
                              spot_label=SPOT)
    return store.pack(wc.list_pdbs())


def _object_pack(wc, resources, packed):
    nodes, unready = wc.list_ready_nodes(), wc.list_unready_nodes()
    node_map = port_cluster.build_node_map(
        nodes, {n.name: wc.list_pods_on_node(n.name)
                for n in [*nodes, *unready]},
        on_demand_label=ON_DEMAND, spot_label=SPOT, unready_nodes=unready,
    )
    return port_tensors.pack_cluster(
        node_map, wc.list_pdbs(), resources=resources,
        pad_candidates=packed.slot_req.shape[0],
        pad_slots=packed.slot_req.shape[1],
        pad_spot=packed.spot_free.shape[0],
    )


def _assert_same_pack(want, got, what):
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert (w.dtype, w.shape) == (g.dtype, g.shape), f"{what}: {f}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")


def test_watch_mirror_follows_seed_events_bookmark_and_relist():
    spec = port_synthetic.CONFIGS[4]
    small = dataclasses.replace(spec, n_on_demand=12, n_spot=12, n_pods=150)
    client = port_synthetic.generate_cluster(small, 3)
    resources = tuple(spec.resources)
    stub = testing.StubApiServer.from_cluster(client)
    port = ref = None
    try:
        port = _start(WatchingKubeClusterClient, port_kube.KubeClusterClient,
                      FakeClock, stub)
        ref = _start(RefWatching, ref_kube.KubeClusterClient, RefClock, stub)

        def check(what):
            for wc, tracker in (port, ref):
                tracker.wait(stub)
            got, _ = _mirror_pack(port[0], resources)
            want, _ = _mirror_pack(ref[0], resources)
            _assert_same_pack(want, got, f"{what}: JAX mirror")
            obj, _ = _object_pack(port[0], resources, got)
            _assert_same_pack(obj, got, f"{what}: port objects")
            return got

        seeded = check("seed")
        lists = dict(stub.list_count)
        # incremental: a pod arrives, a pod leaves, a node is tainted
        pods = sorted(stub.objects["pods"])
        new = dict(stub.objects["pods"][pods[0]])
        new["metadata"] = dict(new["metadata"], name="late-pod",
                               uid="late-pod-uid")
        stub.push("pods", "ADDED", new)
        stub.push("pods", "DELETED", stub.objects["pods"][pods[1]])
        node = next(iter(stub.objects["nodes"].values()))
        stub.push("nodes", "MODIFIED", dict(node, spec=dict(
            node["spec"], taints=[{"key": "ToBeDeletedByClusterAutoscaler",
                                   "value": "1", "effect": "NoSchedule"}])))
        after = check("incremental")
        assert stub.list_count == lists  # no re-list
        assert port[0]._feed.store.n_pods == len(stub.objects["pods"])
        assert not all(np.array_equal(getattr(seeded, f), getattr(after, f))
                       for f in seeded._fields)
        # a BOOKMARK advances the version and changes nothing
        stub.bookmark("pods")
        _assert_same_pack(after, check("bookmark"), "bookmark")
        assert stub.list_count == lists
        # 410 Gone: the watch re-lists and the feed reconciles
        stub.expire()
        stub.push("pods", "DELETED", stub.objects["pods"][pods[2]])
        check("relist")
        assert all(stub.list_count[r] > lists[r] for r in ("nodes", "pods"))
        assert port[0]._feed.store.n_pods == len(stub.objects["pods"])
    finally:
        for wc in (port, ref):
            if wc is not None:
                wc[0].stop()
        stub.close()


# --- the CLI ------------------------------------------------------------------


def test_cli_drains_through_the_stub_with_the_watch_and_the_lease(caplog):
    """``--cluster kube:URL --watch-cache true --leader-elect true``: the
    port's CLI takes the lease, plans from the watch mirror and drains
    what the frozen JAX CLI run drained through the same server."""
    caplog.set_level(logging.INFO, logger="spot_rescheduler_tpu")
    frozen = testing.load_ticks()["kube_cli"]
    client = port_synthetic.generate_cluster(
        port_synthetic.CONFIGS[testing.KUBE_CLI_CONFIG], 0)
    assert testing.cluster_digest(client) == frozen["digest"]
    stub = testing.StubApiServer.from_cluster(client)
    before = port_metrics.robustness_snapshot()["planner_fallback"]
    try:
        argv = ["--cluster", f"kube:{stub.url}", *testing.KUBE_CLI_ARGS,
                "--leader-elect", "true", "--leader-elect-identity", "port",
                "--device", "cpu"]
        assert port_main(argv) == 0
    finally:
        stub.close()
    drained = [m.group(1) for m in (
        re.search(r"tick \d+: drained=(\[.*?\])", msg)
        for msg in caplog.messages) if m]
    assert drained == [repr(rec) for rec in frozen["drained"]]
    assert all(frozen["drained"])
    assert sorted(stub.evictions) == frozen["evicted"]
    assert [h["spec"]["holderIdentity"] for h in stub.leases.values()] == [
        "port"]
    assert port_metrics.robustness_snapshot()["planner_fallback"] == before

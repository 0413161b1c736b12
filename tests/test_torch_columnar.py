"""The port's columnar mirror on the CPU against the JAX package's.

``models/columnar.ColumnarStore.pack`` of the port must give, field for
field and dtype for dtype, the port's object-path ``pack_cluster`` over
``build_node_map`` and the JAX package's ``ColumnarStore.pack`` on the
same cluster, with the same decode (``ColumnarMeta.build_plan``,
``blocking_pods``, the unmodeled mask) as ``PackMeta``'s:

- on ``io/synthetic.CONFIGS`` 1-2 at full size, 3-4 cut to 200 + 200
  nodes and 3,000 pods (same shapes, resources and constraint mix), and
  every ``QUALITY_CONFIGS`` entry;
- over seeded churn applied to both packages' fake clusters at once:
  pod removals and additions carrying every modeled constraint surface,
  taint replacement and removal, readiness flips, spot interruption and
  a node re-added under the same name, and pods added before their node;
- ``node_pod_counts`` and the verdict pass agree with the object path's
  metrics pass (``get_pods_for_deletion`` per node) and with the JAX
  package's.

Tolerance: exact everywhere.
"""

import dataclasses
import functools

import numpy as np
import pytest

from k8s_spot_rescheduler_tpu.io import synthetic as ref_synthetic
from k8s_spot_rescheduler_tpu.models import cluster as ref_cluster
from k8s_spot_rescheduler_tpu.models import evictability as ref_evict
from k8s_spot_rescheduler_tpu.models import tensors as ref_tensors
from k8s_spot_rescheduler_tpu_torch.io import synthetic as port_synthetic
from k8s_spot_rescheduler_tpu_torch.models import cluster as port_cluster
from k8s_spot_rescheduler_tpu_torch.models import evictability as port_evict
from k8s_spot_rescheduler_tpu_torch.models import tensors as port_tensors
from k8s_spot_rescheduler_tpu_torch.models.columnar import ColumnarMeta

ON_DEMAND = "kubernetes.io/role=worker"
SPOT = "kubernetes.io/role=spot-worker"
# configs 3 and 4 cut in scale only: 200 + 200 nodes, 3,000 pods
REDUCED = dict(n_on_demand=200, n_spot=200, n_pods=3000)
QUALITY = sorted(ref_synthetic.QUALITY_CONFIGS)
CASES = ["config1", "config2", "config3", "config4"] + [
    f"quality-{q}" for q in QUALITY
]
PACKAGES = (
    (ref_synthetic, ref_cluster, ref_tensors, ref_evict),
    (port_synthetic, port_cluster, port_tensors, port_evict),
)


def _generate(synthetic, case: str, seed: int = 0):
    if case.startswith("config"):
        n = int(case[len("config"):])
        spec = synthetic.CONFIGS[n]
        if n >= 3:
            spec = dataclasses.replace(spec, **REDUCED)
        return synthetic.generate_cluster(spec, seed), spec
    spec = synthetic.QUALITY_CONFIGS[case[len("quality-"):]]
    return synthetic.generate_quality_cluster(spec, seed), spec


def _store(client, resources):
    return client.columnar_store(
        tuple(resources), on_demand_label=ON_DEMAND, spot_label=SPOT
    )


def _object_pack(cluster_mod, tensors_mod, client, resources, **pads):
    nodes = client.list_ready_nodes()
    unready = client.list_unready_nodes()
    node_map = cluster_mod.build_node_map(
        nodes,
        {n.name: client.list_pods_on_node(n.name) for n in [*nodes, *unready]},
        on_demand_label=ON_DEMAND,
        spot_label=SPOT,
        unready_nodes=unready,
    )
    return tensors_mod.pack_cluster(
        node_map, client.list_pdbs(), resources=tuple(resources), **pads
    )


def _assert_same_pack(want, got, what):
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert (w.dtype, w.shape) == (g.dtype, g.shape), f"{what}: {f}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")


def _meta_view(packed, meta):
    """What the planner reads back from a meta: the candidates' node
    names, blocking pods, unmodeled mask and every valid lane's plan
    under a fixed placement row."""
    K = packed.slot_req.shape[1]
    spot = meta.spot_rows if hasattr(meta, "spot_rows") else meta.spot
    row = (np.arange(K) * 7 % max(1, len(spot))).astype(np.int32)
    plans = []
    for c in np.flatnonzero(np.asarray(packed.cand_valid)):
        p = meta.build_plan(int(c), row)
        plans.append((p.node.node.name, p.candidate_index,
                      [x.uid for x in p.pods], dict(p.assignments)))
    return (
        meta.n_candidates,
        [(b.pod.uid, b.reason) for b in meta.blocking_pods()],
        np.asarray(meta.unmodeled_candidate_mask()).tolist(),
        meta.unplaceable_pod_count(),
        plans,
    )


def _check(ref_client, port_client, resources, what):
    """Port mirror == port objects == JAX mirror, packs and decode."""
    ref_store, port_store = (_store(c, resources)
                             for c in (ref_client, port_client))
    want, want_meta = ref_store.pack(ref_client.list_pdbs())
    got, got_meta = port_store.pack(port_client.list_pdbs())
    assert isinstance(got_meta, ColumnarMeta)
    _assert_same_pack(want, got, f"{what}: JAX mirror vs port mirror")
    # the object path at the mirror's shapes (pads are high-water marks)
    C, K = got.slot_req.shape[:2]
    obj, obj_meta = _object_pack(
        port_cluster, port_tensors, port_client, resources,
        pad_candidates=C, pad_slots=K, pad_spot=got.spot_free.shape[0],
    )
    _assert_same_pack(obj, got, f"{what}: port objects vs port mirror")
    assert _meta_view(got, got_meta) == _meta_view(want, want_meta), what
    assert _meta_view(got, got_meta) == _meta_view(obj, obj_meta), what


@functools.lru_cache(maxsize=None)
def _clusters(case: str):
    return tuple(_generate(synthetic, case) for synthetic, *_ in PACKAGES)


@pytest.mark.parametrize("case", CASES)
def test_columnar_pack_matches_objects_and_the_reference(case):
    (ref_client, spec), (port_client, _) = _clusters(case)
    _check(ref_client, port_client, spec.resources, case)


# --- churn ------------------------------------------------------------------


def _churn_step(mods, client, step: int, rng) -> None:
    """One seeded churn step on one package's fake cluster; ``rng`` is a
    fresh generator seeded per step, so both packages take the same
    actions."""
    _, cluster_mod, _, _ = mods
    PodSpec, NodeSpec, Taint = (cluster_mod.PodSpec, cluster_mod.NodeSpec,
                                cluster_mod.Taint)
    action = step % 5
    if action == 0:  # evictions
        uids = sorted(client.pods)
        for uid in rng.choice(uids, size=min(12, len(uids)), replace=False):
            client._remove_pod(str(uid))
    elif action == 1:  # pods arrive, carrying every modeled surface
        nodes = sorted(client.nodes)
        for i in range(10):
            node = str(rng.choice(nodes))
            extra = {}
            roll = int(rng.integers(0, 8))
            if roll == 1:
                extra["node_selector"] = {"pool": f"g{i % 3}"}
            elif roll == 2:
                extra["node_affinity"] = ((("zone", "In", (f"z{i % 2}",)),),)
            elif roll == 3:
                extra["node_affinity"] = (
                    (("metadata.name", "FieldIn", (node,)),),
                )
            elif roll == 4:
                extra["anti_affinity_match"] = {"churn": f"a{i % 2}"}
                extra["labels"] = {"churn": f"a{i % 2}"}
            elif roll == 5:
                extra["anti_affinity_zone_match"] = {"churn": f"z{i % 2}"}
            elif roll == 6:
                extra["pod_affinity_match"] = {"churn": f"p{i % 2}"}
            elif roll == 7:
                extra["unmodeled_constraints"] = True
            client.add_pod(PodSpec(
                name=f"churn-{step}-{i}", namespace="default", node_name=node,
                requests={"cpu": int(rng.integers(50, 800)),
                          "memory": 64 * 1024**2},
                owner_refs=[cluster_mod.OwnerRef("ReplicaSet", "churn-rs")],
                **extra,
            ))
    elif action == 2:  # spot interruption, and the node comes back by name
        spots = sorted(n for n in client.nodes if n.startswith("spot-"))
        gone = str(rng.choice(spots))
        old = client.nodes[gone]
        client.remove_node(gone)
        labels = dict(old.labels)
        if step % 2:
            labels["topology.kubernetes.io/zone"] = f"z{step % 3}"
        client.add_node(NodeSpec(name=gone, labels=labels,
                                 allocatable=dict(old.allocatable)))
        client.add_pod(PodSpec(
            name=f"back-{step}", namespace="default", node_name=gone,
            requests={"cpu": 100, "memory": 32 * 1024**2},
            owner_refs=[cluster_mod.OwnerRef("ReplicaSet", "back-rs")],
        ))
    elif action == 3:  # taint replacement, readiness flip, untaint
        names = sorted(client.nodes)
        name = str(rng.choice(names))
        client.add_taint(name, Taint("ToBeDeletedByClusterAutoscaler", "",
                                     "NoSchedule"))
        other = str(rng.choice(names))
        client.nodes[other].ready = not client.nodes[other].ready
        if step > 4:
            client.remove_taint(name, "ToBeDeletedByClusterAutoscaler")
    else:  # pods before their node, as a watch can deliver them: the
        # mirror parks them, then takes the node, then the cluster the pods
        late = f"spot-late-{step}"
        early = [PodSpec(
            name=f"early-{step}-{i}", namespace="default", node_name=late,
            requests={"cpu": 100 + 50 * i, "memory": 16 * 1024**2},
            owner_refs=[cluster_mod.OwnerRef("ReplicaSet", "early-rs")],
        ) for i in range(3)]
        for pod in early:
            client._columnar.add_pod(pod)
        client.add_node(NodeSpec(
            name=late, labels={"kubernetes.io/role": "spot-worker"},
            allocatable={"cpu": 4000, "memory": 16 * 1024**3, "pods": 110,
                         "ephemeral-storage": 100 * 1024**3},
        ))
        for pod in early:
            client.add_pod(pod)


@pytest.mark.parametrize("case", ["config3", "config4"])
def test_columnar_pack_matches_under_churn(case):
    clients = []
    for mods in PACKAGES:
        synthetic = mods[0]
        spec = dataclasses.replace(
            synthetic.CONFIGS[int(case[-1])],
            n_on_demand=40, n_spot=40, n_pods=500,
        )
        client = synthetic.generate_cluster(spec, 11)
        _store(client, spec.resources)  # attached before the churn
        clients.append(client)
    for step in range(10):
        for mods, client in zip(PACKAGES, clients):
            _churn_step(mods, client, step, np.random.default_rng(step))
        _check(*clients, spec.resources, f"{case} churn step {step}")


# --- the metrics pass -------------------------------------------------------


@pytest.mark.parametrize("case", ["config2", "config4", "quality-affinity"])
def test_node_pod_counts_and_verdicts_match_the_metrics_pass(case):
    (ref_client, spec), (port_client, _) = _clusters(case)
    ref_store = _store(ref_client, spec.resources)
    port_store = _store(port_client, spec.resources)
    pdbs_r, pdbs_p = ref_client.list_pdbs(), port_client.list_pdbs()
    want_v, got_v = ref_store.verdicts(pdbs_r), port_store.verdicts(pdbs_p)
    for f in dataclasses.fields(got_v):
        w, g = getattr(want_v, f.name), getattr(got_v, f.name)
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name
    got = port_store.node_pod_counts(pdbs_p, verdicts=got_v)
    assert got == ref_store.node_pod_counts(pdbs_r, verdicts=want_v)
    assert got == port_store.node_pod_counts(pdbs_p)
    # the object path's metrics pass: evictable pods per classified node
    nodes = port_client.list_ready_nodes()
    node_map = port_cluster.build_node_map(
        nodes, {n.name: port_client.list_pods_on_node(n.name) for n in nodes},
        on_demand_label=ON_DEMAND, spot_label=SPOT,
    )
    for counts, infos in zip(got, (node_map.on_demand, node_map.spot)):
        assert dict(counts) == {
            info.node.name: len(
                port_evict.get_pods_for_deletion(info.pods, pdbs_p)[0]
            )
            for info in infos
        }

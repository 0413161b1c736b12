"""Plain records (``generator.py``) as the program's objects, and the
churn applied to the program's simulated API server.

``node_obj``, ``pod_obj`` and ``pdb_obj`` build ``NodeSpec``/``PodSpec``/
``PDBSpec`` objects of ``models``, the program's
``k8s_spot_rescheduler_tpu_torch/models/cluster.py``. ``apply`` hands one
call's churn to ``io/fake.FakeCluster``, whose hooks keep the program's
``ColumnarStore`` mirror in step. The plain reference reads the records
themselves.
"""

from __future__ import annotations


def node_obj(models, rec: dict):
    return models.NodeSpec(
        name=rec["name"],
        labels=dict(rec["labels"]),
        allocatable=dict(rec["allocatable"]),
        taints=[models.Taint(*t) for t in rec["taints"]],
    )


def pod_obj(models, rec: dict):
    return models.PodSpec(
        name=rec["name"],
        namespace=rec["namespace"],
        node_name=rec["node"],
        requests=dict(rec["requests"]),
        labels=dict(rec["labels"]),
        owner_refs=[models.OwnerRef(*rec["owner"])],
        tolerations=[models.Toleration(*t) for t in rec["tolerations"]],
        anti_affinity_group=rec["anti_affinity_group"],
        anti_affinity_match=rec["anti_affinity_match"],
        spread_constraints=rec["spread_constraints"],
    )


def pdb_obj(models, rec: dict):
    return models.PDBSpec(
        name=rec["name"],
        namespace=rec["namespace"],
        match_labels=dict(rec["match_labels"]),
        disruptions_allowed=rec["disruptions_allowed"],
    )


def fake_cluster(cluster):
    """The program's simulated API server holding ``cluster``, in its
    insertion order."""
    from k8s_spot_rescheduler_tpu_torch.io.fake import FakeCluster
    from k8s_spot_rescheduler_tpu_torch.models import cluster as models

    fc = FakeCluster()
    for rec in cluster.nodes.values():
        fc.add_node(node_obj(models, rec))
    for rec in cluster.pods.values():
        fc.add_pod(pod_obj(models, rec))
    fc.pdbs = [pdb_obj(models, rec) for rec in cluster.pdbs]
    return fc


def apply(fc, ops) -> None:
    """One call's churn on the simulated API server (and through its
    hooks on the mirror). A pod is deleted through the server's eviction
    with no grace period, its termination run at once on the server's
    clock (the server re-places no evicted pod)."""
    from k8s_spot_rescheduler_tpu_torch.models import cluster as models

    for op in ops:
        kind = op[0]
        if kind == "remove_pod":
            fc.evict_pod(fc.pods[op[1]], 0)
            fc.clock.advance(0)
        elif kind == "add_pod":
            fc.add_pod(pod_obj(models, op[1]))
        elif kind == "add_node":
            fc.add_node(node_obj(models, op[1]))
        else:  # remove_node: the node and its pods go; the moved come back
            fc.remove_node(op[1])
            for rec in op[2]:
                fc.add_pod(pod_obj(models, rec))

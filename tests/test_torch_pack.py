"""The port's host pack path on the CPU against the JAX package's.

The same synthetic clusters come out of both packages' generators (node
names, pod UIDs, requests), and the port's object-path ``pack_cluster``
gives, field for field, the reference's ``PackedCluster`` with the same
``PackMeta`` decode (``build_plan``, ``blocking_pods``). Tolerance:
exact everywhere. The port's generator also reproduces the cluster
digests frozen beside the JAX package's controller runs
(``data/ticks_seed0.json``), which the chip smoke checks on the card
before it compares any drain.
"""

import functools

import numpy as np
import pytest

from k8s_spot_rescheduler_tpu.io import synthetic as ref_synthetic
from k8s_spot_rescheduler_tpu.models import cluster as ref_cluster
from k8s_spot_rescheduler_tpu.models import tensors as ref_tensors
from k8s_spot_rescheduler_tpu.utils.config import (
    ReschedulerConfig as RefConfig,
)
from k8s_spot_rescheduler_tpu_torch import testing
from k8s_spot_rescheduler_tpu_torch.io import synthetic as port_synthetic
from k8s_spot_rescheduler_tpu_torch.models import cluster as port_cluster
from k8s_spot_rescheduler_tpu_torch.models import tensors as port_tensors
from k8s_spot_rescheduler_tpu_torch.models.tensors import load_npz
from k8s_spot_rescheduler_tpu_torch.utils.config import (
    ReschedulerConfig as PortConfig,
)
from tests.torch_port_fixtures import frozen_path

QUALITY = sorted(ref_synthetic.QUALITY_CONFIGS)
CASES = [f"config{n}" for n in (1, 2, 3, 4)] + [f"quality-{q}" for q in QUALITY]


@functools.lru_cache(maxsize=None)
def _clusters(case: str):
    """(reference FakeCluster, port FakeCluster, spec) of ``case`` at
    seed 0, each from its own package's generator."""
    if case.startswith("config"):
        n = int(case[len("config"):])
        spec = ref_synthetic.CONFIGS[n]
        return (
            ref_synthetic.generate_cluster(spec, 0),
            port_synthetic.generate_cluster(port_synthetic.CONFIGS[n], 0),
            spec,
        )
    q = case[len("quality-"):]
    spec = ref_synthetic.QUALITY_CONFIGS[q]
    return (
        ref_synthetic.generate_quality_cluster(spec, 0),
        port_synthetic.generate_quality_cluster(
            port_synthetic.QUALITY_CONFIGS[q], 0
        ),
        spec,
    )


def _node_map(cluster_mod, client, cfg):
    """The classified node map the controller's object observe builds."""
    nodes = client.list_ready_nodes()
    unready = client.list_unready_nodes()
    return cluster_mod.build_node_map(
        nodes,
        {n.name: client.list_pods_on_node(n.name) for n in [*nodes, *unready]},
        on_demand_label=cfg.on_demand_node_label,
        spot_label=cfg.spot_node_label,
        priority_threshold=cfg.priority_threshold,
        unready_nodes=unready,
    )


@functools.lru_cache(maxsize=None)
def _packs(case: str):
    """((reference pack, meta), (port pack, meta)) of ``case`` through
    each package's object path, with the spec's resources."""
    ref_client, port_client, spec = _clusters(case)
    out = []
    for cluster_mod, tensors_mod, cfg_cls, client in (
        (ref_cluster, ref_tensors, RefConfig, ref_client),
        (port_cluster, port_tensors, PortConfig, port_client),
    ):
        cfg = cfg_cls(resources=tuple(spec.resources))
        out.append(tensors_mod.pack_cluster(
            _node_map(cluster_mod, client, cfg),
            client.list_pdbs(),
            resources=cfg.resources,
        ))
    return tuple(out)


def _cluster_view(client):
    return (
        list(client.nodes),
        [(uid, p.node_name, sorted(p.requests.items()))
         for uid, p in client.pods.items()],
        [(pdb.namespace, pdb.name) for pdb in client.pdbs],
    )


@pytest.mark.parametrize("case", CASES)
def test_generate_cluster_matches_the_reference(case):
    ref_client, port_client, _ = _clusters(case)
    assert _cluster_view(port_client) == _cluster_view(ref_client)
    assert testing.cluster_digest(port_client) == testing.cluster_digest(
        ref_client
    )


@pytest.mark.parametrize("config_id", [3, 4])
def test_generator_reproduces_the_frozen_digest(config_id):
    """The digest the chip smoke checks before any drain: the port's
    generator on this box's numpy gives the frozen cluster."""
    frozen = testing.load_ticks()
    _, port_client, _ = _clusters(f"config{config_id}")
    digests = {
        run["digest"]
        for run in frozen["runs"].values()
        if run["config"] == config_id
    }
    assert digests == {testing.cluster_digest(port_client)}


def _assert_same_pack(want, got):
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert w.dtype == g.dtype and w.shape == g.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize(
    "case", ["config1", "config2", "config3"]
    + [f"quality-{q}" for q in QUALITY]
)
def test_pack_cluster_matches_the_reference(case):
    (want, want_meta), (got, got_meta) = _packs(case)
    _assert_same_pack(want, got)
    assert got_meta.n_candidates == want_meta.n_candidates
    assert [i.node.name for i in got_meta.candidates] == [
        i.node.name for i in want_meta.candidates
    ]
    assert [i.node.name for i in got_meta.spot] == [
        i.node.name for i in want_meta.spot
    ]
    assert [(b.pod.uid, b.reason) for b in got_meta.blocking_pods()] == [
        (b.pod.uid, b.reason) for b in want_meta.blocking_pods()
    ]
    np.testing.assert_array_equal(
        got_meta.unmodeled_candidate_mask(),
        want_meta.unmodeled_candidate_mask(),
    )
    assert got_meta.unplaceable_pod_count() == want_meta.unplaceable_pod_count()
    # decode every valid lane with a placement row over the spot pool
    n_spot = len(want_meta.spot)
    K = want.slot_req.shape[1]
    row = (np.arange(K) * 7 % max(1, n_spot)).astype(np.int32)
    for c in np.flatnonzero(np.asarray(want.cand_valid)):
        w = want_meta.build_plan(int(c), row)
        g = got_meta.build_plan(int(c), row)
        assert (g.node.node.name, g.candidate_index) == (
            w.node.node.name, w.candidate_index
        )
        assert [p.uid for p in g.pods] == [p.uid for p in w.pods]
        assert g.assignments == w.assignments


def test_config3_pack_matches_the_frozen_pack():
    """The port's object-path pack at config 3 against the JAX package's
    columnar-route pack frozen for the chip smoke: equal on the
    unpadded region (lanes of real candidates, rows of real spots)."""
    frozen, _ = load_npz(frozen_path(3))
    (_, meta), (got, _) = _packs("config3")
    n_c, n_s = meta.n_candidates, len(meta.spot)
    assert got.slot_req.shape[1:] == frozen.slot_req.shape[1:]
    for f in got._fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(frozen, f))
        n = n_s if f.startswith("spot_") else n_c
        np.testing.assert_array_equal(g[:n], w[:n], err_msg=f)

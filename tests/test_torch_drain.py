"""The drain actuator's eviction rounds (``actuator/drain.py``) on the
in-memory fake cluster: a round's evictions land in pod order whatever
the threads would do, so the fake's eviction log, its termination order
and the re-placement of evicted pods are the same on every run."""

import threading
import time

import pytest

from k8s_spot_rescheduler_tpu_torch.actuator import drain
from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
    CONFIGS,
    generate_cluster,
)


def _busiest_on_demand_node(client):
    name = max((n for n in client.nodes if n.startswith("od-")),
               key=lambda n: len(client._by_node.get(n, {})))
    pods = sorted(client._by_node[name].values(), key=lambda p: p.uid)
    assert len(pods) >= 3
    return client.nodes[name], pods


def _drain(client, node, pods):
    drain.drain_node(client, client, node, pods, clock=client.clock,
                     max_graceful_termination=30, pod_eviction_timeout=120.0,
                     eviction_retry_time=10.0)


def _slow_first_eviction(client, first_uid):
    """The first pod's eviction stalls before it reaches the fake: over a
    thread pool the other pods' evictions would overtake it."""
    inner = client.evict_pod

    def evict_pod(pod, grace_seconds):
        if pod.uid == first_uid:
            time.sleep(0.2)
        inner(pod, grace_seconds)

    client.evict_pod = evict_pod


def test_fake_cluster_evicts_a_round_in_pod_order():
    client = generate_cluster(CONFIGS[1], 0, reschedule_evicted=True)
    assert client.serial_evictions
    node, pods = _busiest_on_demand_node(client)
    _slow_first_eviction(client, pods[0].uid)
    threads = []
    inner = client.evict_pod

    def evict_pod(pod, grace_seconds):
        threads.append(threading.get_ident())
        inner(pod, grace_seconds)

    client.evict_pod = evict_pod
    _drain(client, node, pods)
    assert client.evictions == [p.uid for p in pods]
    assert set(threads) == {threading.get_ident()}
    assert not client._by_node.get(node.name)


@pytest.mark.parametrize("serial", [True, False])
def test_every_pod_is_evicted_once_either_way(serial):
    """The thread-pool path (a real API client) evicts the same pods."""
    client = generate_cluster(CONFIGS[1], 0, reschedule_evicted=True)
    client.serial_evictions = serial
    node, pods = _busiest_on_demand_node(client)
    _slow_first_eviction(client, pods[0].uid)
    _drain(client, node, pods)
    assert sorted(client.evictions) == sorted(p.uid for p in pods)
    assert not client._by_node.get(node.name)

"""The port's ``--replay-device-only`` (``k8s_spot_rescheduler_tpu_torch/
bench/replay_device.py``) on the CPU, held against the root
``bench.py``'s on the JAX package: the harvest, the harvest cache in
both directions, and the device half's selection.

The replay runs 1 event (seed 0): its one tick leaves 76 valid lanes
greedy-unproven, and best-fit does not prove them all, so repair fires
on the harvested tick, the regime the mode exists for. Tolerance: exact.
The harvested PackedCluster is bit-identical field by field (values and
dtypes), ``unproven`` and ``bf_only`` equal, and the port's union
(``union_program(8, True, use_kernel=True)``, plain versions on the CPU)
selects as the reference's ``make_fused_planner(with_repair(plan_ffd,
8))``. The device-only protocol runs here with a chain of 1 and one
repetition: its pinned chain of 50 is the card's (the arithmetic is
``tests/test_torch_bench.py``'s).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu_torch import testing
from k8s_spot_rescheduler_tpu_torch.bench import __main__ as bench_main
from k8s_spot_rescheduler_tpu_torch.bench import protocol, replay_device
from k8s_spot_rescheduler_tpu_torch.models.tensors import PackedCluster
from tests.torch_port_fixtures import (
    reference_harvest,
    reference_union_selection,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVENTS = 1


def _root_bench():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import bench

    return bench


@pytest.fixture(scope="module")
def harvests(tmp_path_factory):
    """The reference's harvest (its cache written to a temporary file)
    and the port's, at ``EVENTS`` events."""
    cache = str(tmp_path_factory.mktemp("harvest") / "reference.npz")
    want, want_stats = reference_harvest(EVENTS, 0, cache)
    got, got_stats = replay_device.harvest_tick(EVENTS, 0)
    return {"want": want, "want_stats": want_stats, "got": got,
            "got_stats": got_stats, "cache": cache}


def _same_pack(got, want) -> None:
    for f in PackedCluster._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_harvest_equals_the_jax_package(harvests):
    got, want = harvests["got"], harvests["want"]
    assert got["packed"] is not None
    assert (got["unproven"], got["bf_only"]) == (want["unproven"],
                                                 want["bf_only"])
    assert not got["bf_only"] and got["unproven"] > 0  # repair fires
    _same_pack(got["packed"], want["packed"])
    counts = [k for k in harvests["want_stats"]
              if not k.startswith("replan_ms")]
    assert {k: harvests["got_stats"][k] for k in counts} == {
        k: harvests["want_stats"][k] for k in counts}


def test_reference_cache_loads_in_the_port(harvests):
    got, stats = replay_device.load_harvest(harvests["cache"])
    want = harvests["want"]
    _same_pack(got["packed"], want["packed"])
    assert (got["unproven"], got["bf_only"]) == (want["unproven"],
                                                 want["bf_only"])
    assert stats["replan_ms_p50"] == harvests["want_stats"]["replan_ms_p50"]
    assert stats["replan_ms_p99"] == harvests["want_stats"]["replan_ms_p99"]


def test_port_cache_loads_in_the_reference(harvests, tmp_path, monkeypatch):
    path = replay_device.save_harvest(str(tmp_path / "port"),
                                      harvests["got"], harvests["got_stats"])
    assert path == str(tmp_path / "port.npz") and os.path.exists(path)
    root_bench = _root_bench()
    seen = {}

    def capture(args, harvest, stats):
        seen.update(harvest=harvest, stats=stats)
        return 0

    monkeypatch.setattr(root_bench, "_replay_device_protocol", capture)
    # the reference's own suffix rule finds the file the port wrote
    root_bench.run_replay_device_only(argparse.Namespace(
        events=EVENTS, seed=0, harvest_cache=str(tmp_path / "port")))
    _same_pack(seen["harvest"]["packed"], harvests["got"]["packed"])
    assert seen["harvest"]["unproven"] == harvests["got"]["unproven"]
    assert seen["harvest"]["bf_only"] == harvests["got"]["bf_only"]
    for key in ("replan_ms_p50", "replan_ms_p99"):
        assert seen["stats"][key] == harvests["got_stats"][key]


def test_device_half_selects_as_the_jax_union(harvests, monkeypatch):
    """``--replay-device-only --harvest-cache`` through the bench's
    ``run`` on the reference's cache: the row's selection is the
    reference union's on the same tick."""
    real = protocol.run_protocol
    monkeypatch.setattr(protocol, "run_protocol",
                        lambda fused, dp: real(fused, dp, reps=1, n_chain=1))
    rc, row = bench_main.run(["--device", "cpu", "--replay-device-only",
                          "--harvest-cache", harvests["cache"]])
    assert rc == 0
    want = reference_union_selection(harvests["want"]["packed"])
    assert row["metric"] == "replay_constrained_device_only_ms"
    assert row["selection"] == want
    assert row["feasible"] == want[2]
    assert row["note"] == "best-fit AND repair fire"
    C, K, R = harvests["want"]["packed"].slot_req.shape
    assert row["tick_shape"] == {"C": C, "K": K, "R": R,
                                 "S": harvests["want"]["packed"].spot_free.shape[0]}
    assert set(row["device_only"]) == {"chain_len", "chain_ms", "rtt_ms",
                                       "device_only_ms"}
    assert row["backend_attestation"]["solve_backend"] == "cpu"
    assert row["launches"]["B1"] == 0  # plain versions on the CPU


def test_no_harvestable_tick_gives_the_reference_error_row(monkeypatch):
    monkeypatch.setattr(
        replay_device, "harvest_tick",
        lambda n, seed: ({"packed": None, "unproven": -1, "bf_only": True},
                         {"replan_ms_p50": 0.0, "replan_ms_p99": 0.0}))
    rc, row = bench_main.run(["--device", "cpu", "--replay-device-only",
                          "--events", "1"])
    assert rc == 1
    assert row["value"] is None
    assert row["error"] == replay_device.NO_TICK_ERROR


def test_frozen_harvest_loads_in_both_packages(monkeypatch):
    """``data/replay_harvest_seed0.npz`` (the reference's cache at
    ``BENCH_HARVEST_EVENTS`` events) against its frozen row."""
    frozen = testing.load_bench()["harvest"]
    got, _ = replay_device.load_harvest(testing.HARVEST_PATH)
    root_bench = _root_bench()
    seen = {}
    monkeypatch.setattr(root_bench, "_replay_device_protocol",
                        lambda args, harvest, stats: seen.update(h=harvest))
    root_bench.run_replay_device_only(argparse.Namespace(
        events=frozen["events"], seed=0, harvest_cache=testing.HARVEST_PATH))
    _same_pack(got["packed"], seen["h"]["packed"])
    assert got["unproven"] == frozen["unproven"]
    assert got["bf_only"] == frozen["bf_only"]
    C, K, R = got["packed"].slot_req.shape
    assert frozen["tick_shape"] == {"C": C, "K": K, "R": R,
                                    "S": got["packed"].spot_free.shape[0]}

"""The readers of the plan's inner spans and of its host-sync counter, on
the CPU at a tiny size: read where each metric's entry lists the cell,
left out where it does not, and None where no traced call holds the span."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.conftest import run_cpu

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
NEW_SPAN_METRICS = ("host_sync_ms.cut", "host_syncs.cut", "greedy_ms.cut",
                    "commit_ms.cut", "repair_ms.cut", "pack_spread_ms.cut")


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_the_plans_inner_spans_and_syncs(tiny_cell, name):
    """A cut reads at least 3 syncs (one step, its probe, the fetch)."""
    cell = tiny_cell(name)
    # no call profiled: every traced call feeds the span readers
    cell.traffic = dict(cell.traffic, trace_calls=0)
    res = run_cpu(cell, 2**31 + 5, 2.0, trace=True)
    assert res["correct"]
    listed = {m["name"] for m in cell.per_layer} & set(NEW_SPAN_METRICS)
    assert listed >= {"host_sync_ms.cut", "host_syncs.cut", "greedy_ms.cut",
                      "commit_ms.cut"}
    for metric in listed:
        assert metric in res["metrics"], metric
        assert res["metrics"][metric]["value"] > 0, metric
    assert res["metrics"]["host_syncs.cut"]["value"] >= 3
    for metric in set(NEW_SPAN_METRICS) - listed:
        assert metric not in res["metrics"]


def test_a_span_reader_reads_a_missing_span_as_none():
    run = harness.RunRecord("cut")
    run.spans = [{"plan.solve": 3.0}, {"plan.solve": 5.0}]
    for metric in NEW_SPAN_METRICS:
        if metric != "host_syncs.cut":
            read = harness.load_reader(harness.find_reader(metric))
            assert read(run, metric) is None, metric
    run.spans = [{"union.greedy": 3.0}, {"plan.solve": 5.0}]
    read = harness.load_reader(harness.find_reader("greedy_ms.cut"))
    assert read(run, "greedy_ms.cut") == 1.5

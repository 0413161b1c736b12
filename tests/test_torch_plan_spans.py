"""The plan's inner spans and its host-sync counter, on the CPU.

- a 32-step schedule cut in which repair fires every step carries the
  pack's, the union's, repair's and the loop's spans, each declared in
  ``utils/tracing.SPAN_NAMES``, one of each a step (none inside a loop
  over slots or rounds), nested under ``plan.pack`` and ``plan.solve``,
  with nothing dropped;
- ``device_syncs_total`` counts 2·H + 1 reads for a cut that reaches the
  horizon H and 2·n + 3 for one a terminal probe ends after n drains,
  with or without a trace, and a cut without a trace builds no span;
- the per-tick plan and a schedule step's re-proof count their reads,
  and the flight recorder's redacted trace keeps each read's site;
- with a trace dir set, the Chrome trace of ``device_trace`` carries the
  spans as ``torch.profiler`` ranges;
- ``Trace.origin`` places spans on ``time.perf_counter``;
  ``DrainSchedule.meta`` is the meta the schedule was cut with;
- the ``trace-contract`` analysis pass is clean on the port.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from k8s_spot_rescheduler_tpu_torch.io import synthetic
from k8s_spot_rescheduler_tpu_torch.loop import flight
from k8s_spot_rescheduler_tpu_torch.metrics import registry
from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
    TorchSolverPlanner,
)
from k8s_spot_rescheduler_tpu_torch.utils import tracing
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ON_DEMAND = "kubernetes.io/role=worker"
SPOT = "kubernetes.io/role=spot-worker"
RESOURCES = ("cpu", "memory", "ephemeral-storage", "pods")
HORIZON = 32


def _spec(name, n, pods, util, spot_util):
    """A cluster with the whole predicate surface at a small size."""
    return synthetic.SyntheticSpec(
        name, n, n, pods, zipf_sizes=True, taints=True, anti_affinity=True,
        pdbs=True, spread=True, on_demand_util=util, spot_util=spot_util,
        resources=RESOURCES,
    )


# seed 3: 32 drains and more (the cut reaches the horizon) with a valid
# lane the greedy passes cannot prove at every step, so repair fires
# every step; and 3 drains before a terminal probe
FULL = _spec("spans-full", 48, 500, 0.1, 0.1)
SHORT = _spec("spans-short", 40, 400, 0.3, 0.5)
SHORT_DRAINS = 3

# one of each a union solve (and so a step), wherever repair fires
PER_STEP = ("union.greedy", "union.repair", "repair.partial",
            "repair.rounds", "repair.validate", "schedule.commit")
PER_PACK = ("pack.verdicts", "pack.order", "pack.spread", "pack.predicates",
            "pack.fill")


def _setup(spec, horizon=HORIZON):
    client = synthetic.generate_cluster(spec, 3)
    store = client.columnar_store(
        RESOURCES, on_demand_label=ON_DEMAND, spot_label=SPOT
    )
    cfg = ReschedulerConfig(
        resources=RESOURCES, on_demand_node_label=ON_DEMAND,
        spot_node_label=SPOT, schedule_horizon=horizon,
    )
    return TorchSolverPlanner(cfg, device="cpu"), store, client.list_pdbs()


def _delta(before, after):
    sites = {
        k: v - before["by_site"].get(k, 0.0)
        for k, v in after["by_site"].items()
        if v != before["by_site"].get(k, 0.0)
    }
    return (after["device_syncs"] - before["device_syncs"], sites,
            after["plan_schedules"] - before["plan_schedules"])


def _cut(spec, traced=True, horizon=HORIZON):
    planner, store, pdbs = _setup(spec, horizon)
    before = registry.host_sync_snapshot()
    with tracing.tick_trace(enabled=traced) as trace:
        schedule = planner.plan_schedule(store, pdbs)
    return trace, schedule, _delta(before, registry.host_sync_snapshot())


@pytest.fixture(scope="module")
def full_cut():
    return _cut(FULL)


def _ancestors(trace):
    """{id(span): [names of its ancestors, outermost first]}."""
    out = {}
    stack = [(sp, []) for sp in trace.spans]
    while stack:
        sp, up = stack.pop()
        out[id(sp)] = up
        stack.extend((c, up + [sp.name]) for c in sp.children)
    return out


def test_a_full_horizon_cut_holds_every_plan_span(full_cut):
    trace, schedule, _ = full_cut
    assert len(schedule.steps) == HORIZON
    assert trace.dropped == 0
    for name in PER_STEP + PER_PACK + ("device.sync",):
        assert name in tracing.SPAN_NAMES, name
        assert trace.find(name), name
    # repair fired every step; no span opens per slot or per round
    for name in PER_STEP:
        assert len(trace.find(name)) == HORIZON, name
    for name in PER_PACK:
        assert len(trace.find(name)) == 1, name
    sites = [sp.attrs["site"] for sp in trace.find("device.sync")]
    assert sorted(sites) == sorted(
        ["found", "repair-gate"] * HORIZON + ["fetch"])


def test_the_plan_spans_nest_under_plan_solve_and_plan_pack(full_cut):
    trace = full_cut[0]
    up = _ancestors(trace)
    for name in ("union.greedy", "union.repair", "schedule.commit",
                 "device.sync"):
        for sp in trace.find(name):
            assert up[id(sp)][:2] == ["plan.schedule", "plan.solve"], name
    for name in ("repair.partial", "repair.rounds", "repair.validate"):
        for sp in trace.find(name):
            assert up[id(sp)][-1] == "union.repair", name
    for name in PER_PACK:
        (sp,) = trace.find(name)
        assert up[id(sp)] == ["plan.schedule", "plan.pack"], name


@pytest.mark.parametrize("case", ["horizon", "probe"])
def test_a_cut_counts_its_host_syncs(full_cut, case):
    if case == "horizon":
        _, schedule, (syncs, sites, cuts) = full_cut
        assert len(schedule.steps) == HORIZON
        assert syncs == 2 * HORIZON + 1
        assert sites == {"found": HORIZON, "repair-gate": HORIZON,
                         "fetch": 1}
    else:
        _, schedule, (syncs, sites, cuts) = _cut(SHORT)
        n = len(schedule.steps)
        assert n == SHORT_DRAINS
        assert syncs == 2 * n + 3
        assert sites == {"found": n + 1, "repair-gate": n + 1, "fetch": 1}
    assert cuts == 1


def test_without_a_trace_a_cut_builds_no_span_and_counts_its_syncs(
    monkeypatch,
):
    def no_span(*args, **kwargs):
        raise AssertionError("a span was built with no trace active")

    monkeypatch.setattr(tracing, "Span", no_span)
    assert tracing.current_trace() is None
    trace, schedule, (syncs, sites, cuts) = _cut(SHORT, traced=False)
    assert trace is None
    assert len(schedule.steps) == SHORT_DRAINS
    assert syncs == 2 * SHORT_DRAINS + 3 and cuts == 1


def test_the_flight_recorder_keeps_the_sync_sites(full_cut):
    recorder = flight.FlightRecorder(ring_size=2)
    recorder.record_tick(full_cut[0].to_dict())
    stack = list(recorder.last_tick()["trace"]["spans"])
    sites = set()
    while stack:
        sp = stack.pop()
        if sp["name"] == "device.sync":
            sites.add(sp["attrs"]["site"])
        stack.extend(sp.get("spans", ()))
    assert sites == {"found", "repair-gate", "fetch"}


def test_the_per_tick_plan_and_a_step_count_their_syncs():
    planner, store, pdbs = _setup(SHORT)
    before = registry.host_sync_snapshot()
    with tracing.tick_trace() as trace:
        report = planner.plan(store, pdbs)
    syncs, sites, cuts = _delta(before, registry.host_sync_snapshot())
    assert report.plan is not None and cuts == 0
    # the staged solve: the prefilter, then a union's gate, its chosen
    # lane and a selection fetch a chunk solved
    chunks = report.chunks_solved
    assert sites == {"prefilter": 1, "repair-gate": chunks, "lane": chunks,
                     "selection": chunks}
    up = _ancestors(trace)
    for sp in trace.find("device.sync"):
        if sp.attrs["site"] == "selection":
            assert up[id(sp)][-1] == "plan.solve"

    schedule = planner.plan_schedule(store, pdbs)
    before = registry.host_sync_snapshot()
    assert schedule.next_plan(store, pdbs).plan is not None
    _, sites, _ = _delta(before, registry.host_sync_snapshot())
    assert sites == {"step-validate": 1}


def test_a_trace_dir_puts_the_plan_spans_in_the_chrome_trace(tmp_path):
    planner, store, pdbs = _setup(SHORT, horizon=2)
    tracing.enable_profiler(str(tmp_path))
    try:
        with tracing.tick_trace(), tracing.device_trace() as dt:
            planner.plan_schedule(store, pdbs)
    finally:
        tracing.disable_profiler()
    with open(dt.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"plan.solve", "union.greedy", "union.repair", "pack.spread",
            "device.sync"} <= names


def test_the_trace_origin_is_on_perf_counter():
    t0 = time.perf_counter()
    trace = tracing.Trace()
    time.sleep(0.002)
    with trace.span("plan.pack"):
        pass
    t1 = time.perf_counter()
    (sp,) = trace.spans
    start = trace.origin + sp.t0_ms / 1e3
    assert t0 <= trace.origin < start <= t1
    assert start - trace.origin >= 0.002


def test_a_schedule_keeps_the_meta_it_was_cut_with():
    planner, store, pdbs = _setup(SHORT)
    schedule = planner.plan_schedule(store, pdbs)
    meta = schedule.meta
    assert schedule.empty_report().n_candidates == meta.n_candidates
    assert len(meta.cand_rows) == meta.n_candidates
    with pytest.raises(AttributeError):
        schedule.meta = None


def test_the_trace_contract_is_clean_on_the_port():
    proc = subprocess.run(
        [sys.executable, "-m", "tools.analysis", "--tier", "ast",
         "--no-baseline", "--pass", "trace-contract",
         "k8s_spot_rescheduler_tpu_torch"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "trace-contract" not in proc.stdout

"""The port's bench modes ``--smoke``, ``--pallas-smoke``, ``--chaos``
and ``--watch-soak`` (``k8s_spot_rescheduler_tpu_torch/bench/smoke.py``
and ``soak.py``) on the CPU, held against the root ``bench.py``'s same
modes on the JAX package, and the no-card exit of all six new modes.

Tolerance: exact. The soaks' stats equal the reference's key by key with
no violation; the smoke cluster's packs are bit-identical tick by tick
and the staged chunks and delta lanes equal; the parity packs are
bit-identical and the port's plain versions show no mismatch. The
smoke's delta ticks upload other byte counts than the reference's: the
reference pads each delta section to a power-of-two length for its
jitted scatter, the port writes it unpadded (``planner/solver_planner``),
so here the first full pack's bytes are equal and each delta ships
fewer.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS as REF_CONFIGS
from k8s_spot_rescheduler_tpu.utils.config import (
    ReschedulerConfig as RefConfig,
)
from k8s_spot_rescheduler_tpu_torch.bench import __main__ as bench_main
from k8s_spot_rescheduler_tpu_torch.bench import smoke, soak
from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOAK_TICKS = 300


def _root_bench():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import bench

    return bench


# --- the bench's flags --------------------------------------------------------

NEW_MODES = (
    ["--replay-device-only"], ["--carry-wall"],
    ["--carry-wall", "--config", "4", "--scale", "0.5"], ["--smoke"],
    ["--pallas-smoke"], ["--chaos"], ["--watch-soak"],
)


@pytest.mark.parametrize("flags", NEW_MODES, ids=" ".join)
def test_new_mode_without_a_card_exits_1_and_prints_no_row(flags, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the mode would run on it")
    assert bench_main.main(["--device", "cuda", *flags]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "torch.cuda.is_available()" in out.err


# --- registry ----------------------------------------------------------------------


def test_freshness_snapshot_equals_the_jax_package():
    from k8s_spot_rescheduler_tpu.metrics import registry as ref_metrics

    ref_before = ref_metrics.freshness_snapshot()
    before = metrics.freshness_snapshot()
    assert set(before) == set(ref_before)
    for mod in (ref_metrics, metrics):
        mod.update_watch_event("pods")
        mod.update_watch_event("nodes")
        mod.update_watch_relist("pods")
        mod.update_watch_stream_error("nodes")
        mod.update_watch_stall("pods")
        mod.update_watch_drift("nodes", 3)
        mod.update_watch_presence_heal("pods", 2)
        mod.update_resync_audit()
        mod.update_freshness_bypass()
        mod.update_mirror_stale_planned()
        mod.update_mirror_staleness(7.5)
        mod.update_observe_delta_events(4)
    ref_after = ref_metrics.freshness_snapshot()
    after = metrics.freshness_snapshot()
    # the counters by their deltas (earlier tests in this process may
    # have counted), the two gauges by the values just set
    gauges = ("mirror_staleness_seconds", "observe_delta_events")
    delta = {k: after[k] - before[k] for k in after if k not in gauges}
    ref_delta = {k: ref_after[k] - ref_before[k] for k in ref_after
                 if k not in gauges}
    assert delta == ref_delta
    assert delta["watch_events"] == 2 and delta["watch_drift"] == 3
    assert {k: after[k] for k in gauges} == {k: ref_after[k] for k in gauges}
    assert after["mirror_staleness_seconds"] == 7.5
    assert after["observe_delta_events"] == 4


# --- the soaks ---------------------------------------------------------------------


def _reference_chaos_row(capsys) -> dict:
    import json

    root_bench = _root_bench()
    if root_bench._emit_once.locked():  # emit prints one row a process
        root_bench._emit_once.release()
    rc = root_bench.run_chaos(
        argparse.Namespace(chaos_ticks=SOAK_TICKS, seed=0),
        "chaos_soak_completed_ticks", "count")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert rc == 0
    return json.loads(lines[-1])


def test_chaos_soak_equals_the_jax_package(capsys):
    want = _reference_chaos_row(capsys)
    args = bench_main.build_parser().parse_args(
        ["--device", "cpu", "--chaos", "--chaos-ticks", str(SOAK_TICKS)])
    rc, row = soak.run_chaos(args, torch.device("cpu"),
                             *bench_main.metric_for(args))
    assert rc == 0 and row["ok"] and "violations" not in row
    keys = set(want) - {"wall_s", "backend_attestation"}
    assert {k: row[k] for k in keys} == {k: want[k] for k in keys}
    assert row["planner_fallback_ticks"] == 2


def test_watch_soak_equals_the_jax_package():
    want, want_violations = _root_bench().watch_soak(SOAK_TICKS, 0)
    got, violations = soak.watch_soak(SOAK_TICKS, 0, torch.device("cpu"))
    assert violations == want_violations == []
    assert got == want


def test_scripted_crash_planner_crashes_on_every_entry_point():
    calls = []

    class Inner:
        device = torch.device("cpu")

        def plan(self, obs, pdbs):
            calls.append("plan")

        def plan_async(self, obs, pdbs):
            calls.append("plan_async")

        def plan_schedule(self, obs, pdbs):
            calls.append("plan_schedule")

    planner = soak._ScriptedCrashPlanner(Inner(), {2, 3})
    planner.plan(None, ())
    with pytest.raises(RuntimeError, match="scripted planner crash #2"):
        planner.plan_async(None, ())
    with pytest.raises(RuntimeError, match="scripted planner crash #3"):
        planner.plan_schedule(None, ())
    planner.plan_schedule(None, ())
    assert calls == ["plan", "plan_schedule"]
    assert planner.device == torch.device("cpu")


# --- the smoke -----------------------------------------------------------------------


def _reference_smoke_spec():
    return dataclasses.replace(REF_CONFIGS[2], name="bench-smoke",
                               n_on_demand=64, n_spot=64, n_pods=600)


def _churned_packs(client, store, pdbs, priority_threshold, n_ticks=5,
                   churn=3):
    """The smoke's tick sequence of host packs: the same churn loop as
    ``run_incremental_ticks``, packing instead of planning."""
    uids = iter(list(client.pods))
    packs = []
    for i in range(n_ticks):
        if i:
            for _ in range(churn):
                uid = next(uids, None)
                if uid is not None:
                    client._remove_pod(uid)
        packs.append(store.pack(pdbs, priority_threshold=priority_threshold)[0])
    return packs


def test_smoke_ticks_equal_the_jax_package():
    root_bench = _root_bench()
    ref_spec = _reference_smoke_spec()
    spec = smoke.smoke_spec()
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_spec)
    _, _, _, rclient, rstore, rpdbs = root_bench.build_problem(
        2, 0, spec=ref_spec)
    _, want, _, _ = root_bench.run_incremental_ticks(
        rclient, rstore, rpdbs, ref_spec, "jax", n_ticks=5, churn=3,
        staged_chunk_lanes=16)
    _, _, _, client, store, pdbs = bench_main.build_problem(spec, 0)
    _, got, _, traces = bench_main.run_incremental_ticks(
        client, store, pdbs, spec, torch.device("cpu"), n_ticks=5, churn=3,
        staged_chunk_lanes=16)
    for field in ("delta_pack_lanes", "full_repack", "chunks_solved",
                  "chunks_skipped", "n_feasible"):
        assert [getattr(r, field) for r in got] == [
            getattr(r, field) for r in want], field
    assert got[0].upload_bytes == want[0].upload_bytes
    assert all(0 < r.upload_bytes < got[0].upload_bytes for r in got[1:])
    assert all(t.find("plan.solve") for t in traces)
    # the same packs tick by tick, on fresh clusters of the same seed
    thr = RefConfig().priority_threshold
    assert thr == ReschedulerConfig().priority_threshold
    _, _, _, rclient, rstore, rpdbs = root_bench.build_problem(
        2, 0, spec=ref_spec)
    _, _, _, client, store, pdbs = bench_main.build_problem(spec, 0)
    for want_pack, got_pack in zip(
            _churned_packs(rclient, rstore, rpdbs, thr),
            _churned_packs(client, store, pdbs, thr)):
        for f in got_pack._fields:
            assert np.array_equal(np.asarray(getattr(got_pack, f)),
                                  np.asarray(getattr(want_pack, f))), f


def test_smoke_row_on_the_cpu():
    args = bench_main.build_parser().parse_args(["--device", "cpu", "--smoke"])
    rc, row = smoke.run_smoke(args, torch.device("cpu"),
                              *bench_main.metric_for(args))
    assert rc == 0 and row["ok"]
    assert row["metric"] == "bench_smoke_delta_upload_bytes"
    assert row["value"] == row["upload_bytes"][-1] < row["upload_bytes"][0]
    assert row["span_solve_ms"] > 0
    assert row["span_queue_ms"] == row["span_wire_ms"] == 0.0
    assert row["verify_protocol_ms"] > 0


def test_span_ms_median_sums_each_trace_and_skips_missing():
    class Span:
        def __init__(self, dur_ms):
            self.dur_ms = dur_ms

    class Trace:
        def __init__(self, *durs):
            self.spans = [Span(d) for d in durs]

        def find(self, name):
            return self.spans if name == "plan.solve" else []

    traces = [Trace(1.0, 2.0), Trace(5.0), Trace(), None]
    assert smoke.span_ms_median(traces, "plan.solve") == 3.0
    assert smoke.span_ms_median(traces, "wire.transfer") == 0.0
    assert smoke.span_ms_median([None], "plan.solve") == 0.0


# --- the parity smoke --------------------------------------------------------------


def test_pallas_smoke_packs_equal_the_jax_package(monkeypatch):
    """The reference's three parity packs, captured as its kernel
    receives them (its solves replaced by the oracle: only the packs are
    compared here), against ``smoke.parity_cases``."""
    from k8s_spot_rescheduler_tpu.ops import pallas_ffd
    from k8s_spot_rescheduler_tpu.solver import ffd as ref_ffd
    from k8s_spot_rescheduler_tpu.solver.numpy_oracle import plan_oracle

    seen = []

    def stream_bf(pk, layout=None, interpret=False):
        seen.append(pk)
        return plan_oracle(pk, best_fit=True)

    monkeypatch.setattr(pallas_ffd, "plan_stream_bf_pallas", stream_bf)
    monkeypatch.setattr(pallas_ffd, "plan_ffd_pallas",
                        lambda pk: plan_oracle(pk))
    monkeypatch.setattr(
        ref_ffd, "plan_ffd_streamed",
        lambda pk, carry_chunks, layout, best_fit: plan_oracle(pk, best_fit))
    want = _root_bench().pallas_parity_smoke(seed=0)
    assert want["ok"] and want["checks"] == 15
    got = smoke.parity_cases(0)
    assert len(got) == len(seen) == 3
    for g, w in zip(got, seen):
        for f in g._fields:
            a, b = np.asarray(getattr(g, f)), np.asarray(getattr(w, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_pallas_smoke_on_the_cpu_checks_the_plain_versions():
    args = bench_main.build_parser().parse_args(["--device", "cpu",
                                             "--pallas-smoke"])
    rc, row = smoke.run_pallas_smoke(args, torch.device("cpu"),
                                     *bench_main.metric_for(args))
    assert rc == 0 and row["ok"]
    assert row["mismatches"] == [] and row["checks"] == 15
    assert row["chunk_counts"] == [2, 3, 5]
    assert row["kernels"] == []

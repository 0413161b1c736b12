"""The port's service-side bench modes (``bench/service_smoke.py``,
``bench/fleet_chaos.py`` and the driver's ``--serve-smoke``,
``--sched-smoke``, ``--fleet-chaos``, ``--fleet-twin-smoke``,
``--fleet-twin``, ``--storm-smoke`` and ``--twin-calibration``) on the
CPU, held against the root ``bench.py``'s same modes on the JAX package
(``data/bench_seed0.json`` parts ``serve``, ``sched`` and ``fleet``).

Tolerance: exact, in every count, byte total and selection. No test
reads a wall time: ``serve_smoke``'s ``reuse_ok`` also asks the pooled
socket to beat the fresh connection on the host clock, so its count
half ``reuse_counts_ok`` is what is held here. ``serve_smoke`` runs its
pooled-reuse phase cut to 5 + 3 ticks (the freeze ran the reference's
100 + 25): the reuses are one fewer than the pooled ticks in both, and
each reuse-phase tick after a tenant's first applies one delta.

The fleet-chaos sick phase on a service configured for the card, where
no batch leaves the device (``PlannerService._host_path_open`` false):
every count equals the JAX package's but ``recovered_after_ticks`` (1
against 2: the two batches after the phase are both healthy probes, no
2 s probe spacing of a host path between them) and so ``ticks`` (27
against 28).
"""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

from k8s_spot_rescheduler_tpu_torch import testing
from k8s_spot_rescheduler_tpu_torch.bench import __main__ as bench_main
from k8s_spot_rescheduler_tpu_torch.bench.fleet_chaos import fleet_chaos_smoke
from k8s_spot_rescheduler_tpu_torch.bench.service_smoke import (
    sched_smoke,
    serve_smoke,
)
from k8s_spot_rescheduler_tpu_torch.service.server import PlannerService

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REUSE, FRESH = 5, 3  # the cut pooled-reuse phase


def _root_bench():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import bench

    return bench


@pytest.fixture(scope="module")
def frozen():
    return testing.load_bench()


# --- the driver's flags ----------------------------------------------------------------

SERVICE_MODES = (
    ["--serve-smoke"], ["--sched-smoke"], ["--fleet-chaos"],
    ["--fleet-twin-smoke"], ["--fleet-twin"], ["--storm-smoke"],
    ["--serve-smoke", "--tenants", "6"],
)


@pytest.mark.parametrize("flags", SERVICE_MODES, ids=" ".join)
def test_service_mode_without_a_card_exits_1_and_prints_no_row(flags, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the mode would run on it")
    assert bench_main.main(["--device", "cuda", *flags]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "torch.cuda.is_available()" in out.err


def _carry_rows(tmp_path, rows) -> str:
    path = tmp_path / "rows.jsonl"
    path.write_text("\n".join(
        r if isinstance(r, str) else json.dumps(r) for r in rows) + "\n")
    return str(path)


def test_load_twin_calibration_equals_the_root_bench(tmp_path):
    path = _carry_rows(tmp_path, [
        "carry-wall: a progress line, not JSON",
        {"metric": "carry_union_wall_ms_config3_x1",
         "twin_calibration": {"C8xK16xS8xR2xW1xA2": {"solve_s": 0.002}}},
        {"metric": "other", "value": 1},
        {"twin_calibration": {"C8xK16xS8xR2xW1xA2": {"solve_s": 0.003},
                              "C4xK8xS4xR2xW1xA2": {"solve_s": 0.001},
                              "bad": {"wall": 1}}},
    ])
    got = bench_main.load_twin_calibration(path)
    assert got == _root_bench().load_twin_calibration(path)
    assert got == {"C8xK16xS8xR2xW1xA2": {"solve_s": 0.003},
                   "C4xK8xS4xR2xW1xA2": {"solve_s": 0.001}}


def test_a_calibration_file_without_a_table_fails_in_both(tmp_path, capsys):
    path = _carry_rows(tmp_path, [{"metric": "x", "value": 1}, "log line"])
    with pytest.raises(ValueError, match="twin_calibration"):
        bench_main.load_twin_calibration(path)
    with pytest.raises(ValueError, match="twin_calibration"):
        _root_bench().load_twin_calibration(path)
    with pytest.raises(OSError):
        bench_main.load_twin_calibration(str(tmp_path / "missing.jsonl"))
    # the driver refuses it before it runs: exit 1, no row
    assert bench_main.main(["--device", "cpu", "--fleet-twin-smoke",
                            "--twin-calibration", path]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "twin_calibration" in out.err


# --- serve-smoke --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    return serve_smoke(n_tenants=testing.BENCH_SERVE_TENANTS,
                       seed=testing.BENCH_SEED, device="cpu",
                       reuse_ticks=REUSE, fresh_ticks=FRESH)


def test_serve_smoke_selections_and_wire_bytes_equal_the_jax_freeze(
        served, frozen):
    want = frozen["serve"]
    assert served["selections"] == want["selections"]
    assert served["solo_lanes"] == want["solo_lanes"]
    for key in ("n_tenants", "full_tick_bytes", "quiet_tick_bytes",
                "churn_tick_bytes", "resync_tick_bytes", "delta_resyncs",
                "solo_lanes_max", "remote_fallbacks", "mismatches",
                "delta_mismatches", "trace_violations", "wire_ok"):
        assert served[key] == want[key], key
    assert served["forced_resyncs"] == served["n_tenants"]


def test_serve_smoke_reuse_phase_counts_equal_the_jax_freeze(served, frozen):
    want = frozen["serve"]
    assert (want["reuse_ticks"], want["fresh_ticks"]) == (
        testing.BENCH_SERVE_REUSE)
    assert (served["reuse_ticks"], served["fresh_ticks"]) == (REUSE, FRESH)
    # one fresh connect, then a reuse each pooled tick, in both runs
    assert want["wire_reuse"] == want["reuse_ticks"] - 1
    assert served["wire_reuse"] == REUSE - 1
    assert (served["wire_reconnects"], served["wire_pooled_conns"]) == (
        want["wire_reconnects"], want["wire_pooled_conns"]) == (0, 1)
    assert served["reuse_counts_ok"]
    # the quiet and churn ticks apply a delta a tenant; each reuse-phase
    # agent ships a full pack first, then a delta a tick
    ticks = sum(testing.BENCH_SERVE_REUSE)
    assert served["delta_applied"] == want["delta_applied"] - ticks + (
        REUSE + FRESH)


def test_serve_smoke_cobatches_the_tenants(served):
    # the reference's co-batching checks: one batch of two tenants or
    # more, carrying more lanes than any one tenant holds
    assert served["batch_tenants_max"] >= 2
    assert served["batch_lanes_max"] > served["solo_lanes_max"]
    assert served["quiet_cobatch"] >= 2


# --- sched-smoke ----------------------------------------------------------------------------


def test_sched_smoke_equals_the_jax_freeze(frozen):
    stats, violations = sched_smoke(testing.BENCH_SEED, "cpu")
    want = dict(frozen["sched"])
    assert violations == want.pop("violations") == []
    assert stats["schedule_cut"] == want.pop("schedule_cut")
    assert stats["failovers"] >= 1
    assert {k: stats[k] for k in want} == want


def test_driver_sched_smoke_row_on_the_cpu(frozen):
    rc, row = bench_main.run(["--device", "cpu", "--sched-smoke"])
    assert rc == 0
    assert row["metric"] == "sched_smoke_fetches_total"
    assert row["value"] == frozen["sched"]["fetches_total"]
    assert row["ok"] and "violations" not in row
    assert row["backend_attestation"]["solve_backend"] == "cpu"
    assert row["backend_attestation"]["remote_planner_fallbacks"] == 0
    assert set(row["launches"]) == {"B1", "B2", "B3", "B4", "B1t", "B2t",
                                    "B5"}


# --- fleet-chaos ---------------------------------------------------------------------------


def _fleet_want(frozen) -> dict:
    want = dict(frozen["fleet"])
    assert want["ok"] and want["n_agents"] == testing.BENCH_FLEET_AGENTS
    return want


def test_fleet_chaos_equals_the_jax_freeze(frozen):
    got = fleet_chaos_smoke(testing.BENCH_FLEET_AGENTS, testing.BENCH_SEED,
                            device="cpu")
    assert got.pop("failover_ms") >= 0
    assert got == _fleet_want(frozen)


def test_fleet_chaos_under_the_cuda_rule_differs_only_where_named(
        frozen, monkeypatch):
    # a service on the card never takes the host path (the tensors stay
    # on the CPU here; the rule is the service's, not the device's)
    monkeypatch.setattr(PlannerService, "_host_path_open", lambda self: False)
    got = fleet_chaos_smoke(testing.BENCH_FLEET_AGENTS, testing.BENCH_SEED,
                            device="cpu")
    got.pop("failover_ms")
    want = _fleet_want(frozen)
    named = {"recovered_after_ticks": (1, 2), "ticks": (27, 28)}
    for key, (port, jax) in named.items():
        assert (got.pop(key), want.pop(key)) == (port, jax), key
    assert got == want
    assert got["sick_detect_batches"] == 3 and got["ok"]


def test_driver_fleet_chaos_row_on_the_cpu(frozen):
    rc, row = bench_main.run(["--device", "cpu", "--fleet-chaos"])
    assert rc == 0 and row["ok"]
    want = _fleet_want(frozen)
    assert row["metric"] == "fleet_chaos_failover_ms"
    assert row["value"] == row["failover_ms"]
    for key in ("n_agents", "ticks", "sick_detect_ticks",
                "sick_detect_batches", "recovered_after_ticks", "failovers",
                "fallbacks", "delta_resyncs", "corrupt_resyncs",
                "half_close_strikes", "half_close_reconnects",
                "flight_eq_metrics", "flight_deltas", "selections"):
        assert row[key] == want[key], key
    assert row["warmed_buckets"] == len(want["warmed_buckets"])
    assert row["warmed_bucket_keys"] == want["warmed_buckets"]
    # the agents' scripted local fallbacks, none of the service's
    assert row["backend_attestation"]["remote_planner_fallbacks"] == (
        want["fallbacks"])

"""The port's tenant twin (``service/twin.py``) and fleet twin
(``bench/fleet_twin.py``) on the CPU, against the JAX package's.

- ``fleet_specs`` equal the JAX package's for the same arguments.
- One twin of each package, driven through the same script against its
  own package's service (a dead endpoint ahead of the live one, churn,
  a spot storm and its restore, a forced resync, a v3 schedule tick):
  every request body is byte-identical, and every tick's breaker state,
  failovers, resyncs, retry time, post counts and verified selection
  are equal.
- ``churn``, ``spot_interrupt``, ``spot_restore`` and the packs after
  them equal the JAX twin's.
- ``induce_shed_edges`` fires every reason of ``SHED_REASONS`` with the
  metric and flight deltas of the JAX freeze (``data/bench_seed0.json``
  part ``edges``).
- The replicas' ``solve_hook``, given a calibration table keyed by a
  real twin bucket (``bucket_for`` of a twin's pack), charges every
  batch as the JAX package's fleet does: the same busy time, device
  frontier and virtual clock after each batch, the measured cost where
  the batch's bucket has one (a zero cost falling back to the base
  line), the modelled line elsewhere, and the same answers.
- A small fleet (16 twins, 360 simulated seconds, two phases and the
  restart storm) keeps the fleet invariants: no twin crash, every
  spot-checked selection solo-identical, the shed, failover and resync
  ledgers equal, the occupancy curve increasing. Its run is threaded
  and not deterministic tick by tick, so it is held to these, not to a
  freeze; the wall budget is set out of reach and no wall figure is
  read. Its ``host_split`` accounts for every batch and tick. The same
  fleet with a calibration table charges some of its batches a
  measured cost, and its curve has the JAX fleet's phases and active
  twins under the same table, increasing in both. The reference's
  "degenerate queue-wait curve" check (the heavier phase's p99 above
  the lighter one's) is left out here: with a few dozen waits a phase
  it turns on one joint tick's timing (the reference's own
  ``test_capacity_curve_shape`` fails so under load).

Tolerance: exact.
"""

from __future__ import annotations

import dataclasses
import socket

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.bench import fleet_twin as ref_fleet_twin
from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS as REF_CONFIGS
from k8s_spot_rescheduler_tpu.metrics import registry as ref_metrics
from k8s_spot_rescheduler_tpu.planner.solver_planner import (
    SolverPlanner as RefSolverPlanner,
)
from k8s_spot_rescheduler_tpu.service import buckets as ref_buckets
from k8s_spot_rescheduler_tpu.service import server as ref_server
from k8s_spot_rescheduler_tpu.service import twin as ref_twin
from k8s_spot_rescheduler_tpu.utils.clock import FakeClock as RefClock
from k8s_spot_rescheduler_tpu.utils.config import (
    ReschedulerConfig as RefConfig,
)
from k8s_spot_rescheduler_tpu_torch import testing
from k8s_spot_rescheduler_tpu_torch.bench import fleet_twin
from k8s_spot_rescheduler_tpu_torch.io.synthetic import CONFIGS
from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
    TorchSolverPlanner,
)
from k8s_spot_rescheduler_tpu_torch.service import agent
from k8s_spot_rescheduler_tpu_torch.service import buckets
from k8s_spot_rescheduler_tpu_torch.service import server
from k8s_spot_rescheduler_tpu_torch.service import twin
from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

torch.set_num_threads(1)


@pytest.mark.parametrize("n,seed,deadline_frac",
                         ((32, 7, 0.0), (20, 0, 0.5), (1, 3, 0.0)))
def test_fleet_specs_equal_the_jax_package(n, seed, deadline_frac):
    got = twin.fleet_specs(n, seed=seed, deadline_frac=deadline_frac)
    want = ref_twin.fleet_specs(n, seed=seed, deadline_frac=deadline_frac)
    assert [dataclasses.astuple(s) for s in got] == [
        dataclasses.astuple(s) for s in want]
    assert (twin.SIZE_TIERS, twin.CADENCE_TIERS_S, twin.CHURN_TIERS,
            twin.SCHEDULE_EVERY) == (
        ref_twin.SIZE_TIERS, ref_twin.CADENCE_TIERS_S, ref_twin.CHURN_TIERS,
        ref_twin.SCHEDULE_EVERY)


def test_twin_keeps_the_agents_breaker_and_shed_reasons():
    tw = twin.TenantTwin(twin.fleet_specs(1)[0], ReschedulerConfig(
        resources=CONFIGS[2].resources), FakeClock(), ["http://a:1"])
    assert isinstance(tw.endpoints[0], agent.Endpoint)
    for name in ("FAIL_THRESHOLD", "BACKOFF_BASE", "BACKOFF_MAX",
                 "RETRY_AFTER_CAP_S", "RETRY_JITTER_FRAC", "RESYNC_JITTER_S"):
        assert getattr(agent.RemotePlanner, name) == getattr(
            ref_twin.RemotePlanner, name), name
    assert metrics.SHED_REASONS == ref_metrics.SHED_REASONS
    assert fleet_twin.SHED_REASONS == ref_fleet_twin.SHED_REASONS
    assert fleet_twin.SHED_FLIGHT_KINDS == ref_fleet_twin.SHED_FLIGHT_KINDS


# --- one twin, scripted, in both packages ------------------------------------------------


def _dead_url() -> str:
    """A localhost port nothing listens on (connection refused)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return f"http://127.0.0.1:{port}"


PACKAGES = {
    "port": (twin, server, ReschedulerConfig, FakeClock, CONFIGS,
             lambda cfg: TorchSolverPlanner(cfg, device="cpu"),
             {"device": "cpu"}, "torch"),
    "ref": (ref_twin, ref_server, RefConfig, RefClock, REF_CONFIGS,
            RefSolverPlanner, {}, "numpy"),
}


def _script(package: str, spec, dead: str, monkeypatch) -> tuple:
    """One twin of ``package`` through a fixed script against its own
    package's service; returns (request bodies, per-step records)."""
    mod, srv_mod, cfg_cls, clock_cls, configs, planner, kw, solver = (
        PACKAGES[package])
    cfg = cfg_cls(resources=configs[2].resources, solver=solver,
                  device_sick_threshold=0, schedule_horizon=6)
    clock = clock_cls()
    srv = srv_mod.ServiceServer(cfg, "127.0.0.1:0", batch_window_s=0.0,
                                clock=clock, **kw)
    srv.start_background(scheduler=False)
    bodies = []
    real_post = mod.post_plan

    def post(url, body, headers, timeout=mod.HTTP_TIMEOUT_S):
        bodies.append((url.replace(srv.address, "live"), bytes(body),
                       dict(headers)))
        return real_post(url, body, headers, timeout)

    monkeypatch.setattr(mod, "post_plan", post)
    solo = planner(cfg)
    tw = mod.TenantTwin(spec, cfg, clock, [dead, f"http://{srv.address}"])
    records = []

    def step(note):
        reply = tw.tick()
        records.append({
            "note": note,
            "served": reply is not None,
            "selection": None if reply is None else [
                bool(reply.found), int(reply.index), int(reply.n_feasible),
                np.asarray(reply.row).tolist()],
            "verify": tw.verify(solo),
            "breakers": [(ep.consecutive_failures,
                          round(ep.skip_until - clock.now(), 9), ep.acked_fp)
                         for ep in tw.endpoints],
            "retry_in": round(tw.retry_due - clock.now(), 9)
            if tw.retry_due else 0.0,
            "counts": (tw.offered, tw.served, tw.shed_ticks, tw.crashes,
                       tw.failovers, tw.resyncs, tw.full_posts,
                       tw.full_served, tw.delta_posts, tw.schedule_ticks,
                       tw.wire_bytes_sent),
        })
        clock.advance(1.0)

    try:
        step("first contact")       # the dead replica fails once
        step("breaker opens")       # twice: its skip window opens
        step("quiet delta")
        for i in range(3):
            tw.churn()
            step(f"churn {i}")
        tw.spot_interrupt(0.5)
        step("spot storm")
        tw.spot_restore()
        step("storm restored")
        srv.service.invalidate_tenant_cache()
        step("resync demanded")
        clock.advance(max(0.0, tw.retry_due - clock.now()))
        step("resync answered")
        while tw.offered < 2 * mod.SCHEDULE_EVERY:
            tw.churn()
            step(f"tick {tw.offered + 1}")
    finally:
        srv.close()
    return bodies, records


def test_one_twin_speaks_the_jax_twins_wire_and_breaker(monkeypatch):
    spec = dataclasses.replace(twin.fleet_specs(4, seed=3)[0], churn_prob=0.6)
    ref_spec = ref_twin.TwinSpec(**dataclasses.asdict(spec))
    dead = _dead_url()
    bodies, records = _script("port", spec, dead, monkeypatch)
    ref_bodies, ref_records = _script("ref", ref_spec, dead, monkeypatch)
    assert len(bodies) == len(ref_bodies)
    for i, (got, want) in enumerate(zip(bodies, ref_bodies)):
        assert got == want, i
    assert records == ref_records
    # the script reached every rung of the ladder
    last = records[-1]["counts"]
    assert last[4] >= 3  # failovers past the dead replica
    assert last[5] == 1 and last[8] > 0 and last[9] >= 1  # resync, deltas, v3
    assert all(r["verify"] is None for r in records)


def test_twin_storm_and_churn_equal_the_jax_twin():
    spec = dataclasses.replace(twin.fleet_specs(4, seed=3)[0], churn_prob=1.0)
    cfg = ReschedulerConfig(resources=CONFIGS[2].resources)
    ref_cfg = RefConfig(resources=REF_CONFIGS[2].resources, solver="numpy")
    tw = twin.TenantTwin(spec, cfg, FakeClock(), urls=[])
    ref = ref_twin.TenantTwin(ref_twin.TwinSpec(**dataclasses.asdict(spec)),
                              ref_cfg, RefClock(), urls=[])

    def state(t):
        packed, _ = t.store.pack(t.pdbs)
        return ([n.name for n in t.live_spot_nodes()], t.bucket_signature(),
                sorted(t.store._pod_row), [np.asarray(f) for f in packed])

    def same():
        a, b = state(tw), state(ref)
        assert a[:3] == b[:3]
        for x, y in zip(a[3], b[3]):
            np.testing.assert_array_equal(x, y)

    same()
    for _ in range(3):
        assert tw.churn() == ref.churn()
        same()
    assert tw.spot_interrupt(0.5) == ref.spot_interrupt(0.5) >= 1
    same()
    assert tw.churn() == ref.churn()
    assert tw.spot_interrupt(1.0) == ref.spot_interrupt(1.0)
    assert tw.spot_interrupt(0.5) == ref.spot_interrupt(0.5) == 0
    same()
    assert tw.spot_restore() == ref.spot_restore() >= 2
    same()


# --- shed edges ------------------------------------------------------------------------------


def test_induce_shed_edges_equals_the_jax_freeze():
    got = fleet_twin.induce_shed_edges(seed=testing.BENCH_SEED, device="cpu")
    want = testing.load_bench()["edges"]
    assert got == want
    assert got["ok"] and set(got["metric_delta"]) == set(metrics.SHED_REASONS)
    assert all(v >= 1 for v in got["metric_delta"].values())


# --- a small fleet ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_fleet() -> dict:
    return fleet_twin.fleet_twin(
        n_twins=16, n_replicas=2, sim_s=360.0, seed=0, phases=2,
        # the smoke's cost line (the reference's --fleet-twin-smoke)
        slo_ms=60000.0, cost_base_s=0.3, cost_per_lane_s=0.4,
        resync_storm_s=120.0, max_wall_s=1e9, device="cpu",
    )


def test_small_fleet_no_crash_no_mismatch(small_fleet):
    assert small_fleet["crashes"] == 0
    assert small_fleet["mismatches"] == []
    assert small_fleet["verified_selections"] >= 16
    assert small_fleet["ever_active"] == 16
    assert small_fleet["calibrated_batches"] == 0


def test_small_fleet_ledgers_equal(small_fleet):
    f = small_fleet
    assert f["shed_total_metric"] == f["shed_total_flight"]
    assert f["failovers_metric"] == f["failovers_flight"] > 0
    assert f["resyncs_server"] == f["resyncs_twins"]
    storm = f["resync_storm"]
    assert storm["affected"] >= 1 and storm["converge_ticks"] >= 1
    assert storm["resyncs_server"] == storm["resyncs_twins"]
    assert storm["resync_sheds"] == storm["resync_sheds_flight"]
    assert storm["ingest_inflight_max"] <= storm["ingest_cap"]
    assert storm["full_packs"] >= storm["affected"]
    # every failure the fleet reports is one of the invariants above or
    # the reference's p99-ordering check (module docstring)
    assert [x for x in f["failures"]
            if not x.startswith("degenerate queue-wait curve")] == []


def test_small_fleet_occupancy_curve_increases(small_fleet):
    curve = small_fleet["capacity_curve"]
    assert [r["phase"] for r in curve] == [0, 1]
    assert [r["active_twins"] for r in curve] == [8, 16]
    occ = [r["occupancy"] for r in curve]
    assert 0 < occ[0] < occ[1] <= 1.0
    assert small_fleet["capacity_tenants_per_device_at_slo"] >= 4
    assert small_fleet["jain_fleet"] >= 0.8


def test_small_fleet_host_split_accounts_every_batch(small_fleet):
    split = small_fleet["host_split"]
    assert split["ticks"] >= split["batches"] > 0
    assert 0 < split["logged_batches"] <= split["batches"]
    assert set(split["loop_s"]) == {"ticks", "spot_checks", "churn", "other"}
    assert set(split["batch_ms_median"]) == {"assemble", "scatter", "reply"}
    assert set(split["request_ms_median"]) == {"admit", "decode", "encode"}


# --- the calibrated cost ---------------------------------------------------------------------


def _twin_buckets() -> dict:
    """Each bucket a 16-twin fleet lands in, with one twin's pack in it,
    from both packages' twins and buckets."""
    cfg = ReschedulerConfig(resources=CONFIGS[2].resources)
    ref_cfg = RefConfig(resources=REF_CONFIGS[2].resources)
    out = {}
    for spec in twin.fleet_specs(16):
        tw = twin.TenantTwin(spec, cfg, FakeClock(), ["http://a:1"])
        packed, _ = tw.store.pack(tw.pdbs)
        ref_tw = ref_twin.TenantTwin(ref_twin.TwinSpec(
            **dataclasses.asdict(spec)), ref_cfg, RefClock(), ["http://a:1"])
        ref_packed, _ = ref_tw.store.pack(ref_tw.pdbs)
        key = buckets.bucket_for(packed).key
        assert key == ref_buckets.bucket_for(ref_packed).key
        out.setdefault(key, (packed, ref_packed))
    return out


def _fleet(package: str, calibration: dict):
    if package == "port":
        cfg = ReschedulerConfig(resources=CONFIGS[2].resources,
                                solver="torch", device_sick_threshold=0)
        clock = FakeClock()
        return fleet_twin._Fleet(cfg, clock, 1, 16, 0.3, 0.4,
                                 calibration=calibration, device="cpu"), clock
    cfg = RefConfig(resources=REF_CONFIGS[2].resources, solver="numpy",
                    device_sick_threshold=0)
    clock = RefClock()
    return ref_fleet_twin._Fleet(cfg, clock, 1, 16, 0.3, 0.4,
                                 calibration=calibration), clock


class _Request:
    """What the hook reads of a queued request."""

    def __init__(self, bucket, enqueued: float, lanes: int):
        self.bucket, self.enqueued, self.lanes = bucket, enqueued, lanes


@pytest.mark.parametrize("zero_for_small", (False, True))
def test_calibrated_charge_equals_the_jax_fleets(zero_for_small):
    packs = _twin_buckets()
    assert len(packs) == 2  # the fleet's two buckets (K8 and K16)
    (small_key, small), (big_key, big) = sorted(packs.items())
    # measured costs keyed by a real twin bucket; a zero cost falls back
    # to the base line (the reference's "or cost_base_s")
    table = {big_key: {"solve_s": 0.5}}
    if zero_for_small:
        table[small_key] = {"solve_s": 0.0}
    # (bucket, members, enqueue times): calibrated, modelled, calibrated
    # again after an idle gap (the batch starts at its last enqueue)
    script = ((big_key, big, (0.0, 0.125)), (small_key, small, (0.25,)),
              (big_key, big, (40.0, 41.0, 42.0)))
    fleets = {name: _fleet(name, table) for name in ("port", "ref")}
    try:
        calibrated = 0
        for n, (key, (packed, ref_packed), times) in enumerate(script, 1):
            seen = {}
            for name, (fleet, clock) in fleets.items():
                mod = buckets if name == "port" else ref_buckets
                pack = packed if name == "port" else ref_packed
                b = mod.bucket_for(pack)
                stacked = mod.stack_bucket(
                    [mod.pad_to_bucket(pack, b)] * len(times), b)
                batch = [_Request(b, t, int(np.asarray(
                    pack.cand_valid).sum())) for t in times]
                out = fleet.replicas[0].service.solve_hook(stacked, batch)
                seen[name] = (np.asarray(out).tolist(), fleet.busy_s,
                              fleet.frontier, clock.now())
            assert seen["port"] == seen["ref"], key
            calibrated += key in table
            assert fleets["port"][0].calibrated_batches == calibrated
            assert fleets["port"][0].batches == n
        assert calibrated == (3 if zero_for_small else 2)
    finally:
        for fleet, _ in fleets.values():
            fleet.close()


def test_calibrated_small_fleet_follows_the_jax_fleets_curve():
    table = {key: {"solve_s": 0.5} for key in _twin_buckets()
             if "K16" in key}
    kw = dict(n_twins=16, n_replicas=2, sim_s=360.0, seed=0, phases=2,
              slo_ms=60000.0, cost_base_s=0.3, cost_per_lane_s=0.4,
              resync_storm_s=120.0, max_wall_s=1e9, calibration=table)
    got = fleet_twin.fleet_twin(device="cpu", **kw)
    want = ref_fleet_twin.fleet_twin(**kw)
    assert 0 < got["calibrated_batches"] < got["host_split"]["batches"]
    for run in (got, want):
        assert run["crashes"] == 0 and run["mismatches"] == []
        occ = [r["occupancy"] for r in run["capacity_curve"]]
        assert 0 < occ[0] < occ[1] <= 1.0

    def shape(run):
        return [(r["phase"], r["active_twins"], r["tenants_per_device"])
                for r in run["capacity_curve"]]

    assert shape(got) == shape(want) == [(0, 8, 4.0), (1, 16, 8.0)]

"""The port's multi-tenant planner service against the JAX package's,
on the CPU: the tenant batch (``parallel/tenant_batch``) row for row,
schedule for schedule and delta scatter for delta scatter against the
JAX programs; the service's queue, fairness and failure domains under a
virtual clock (``submit_nowait`` + ``drain_once``); the serve-smoke core
over HTTP; agents and services of the two packages talking to each
other; the JAX package's warm-state file; and the ``--serve`` /
``--planner-url`` CLI pair. The port runs with ``device="cpu"``, its
kernels B1t/B2t taking their plain versions."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.models.tensors import (
    PackedCluster as JaxPackedCluster,
)
from k8s_spot_rescheduler_tpu.parallel import tenant_batch as jax_tb
from k8s_spot_rescheduler_tpu.service import buckets as jax_buckets
from k8s_spot_rescheduler_tpu.service import server as jax_server
from k8s_spot_rescheduler_tpu.service.agent import (
    RemotePlanner as JaxRemotePlanner,
)
from k8s_spot_rescheduler_tpu.utils.config import (
    ReschedulerConfig as JaxConfig,
)
from k8s_spot_rescheduler_tpu_torch import testing
from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
    CONFIGS,
    generate_cluster,
)
from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.models.delta import (
    emit_packed_delta,
    pack_fingerprint,
    pad_packed_delta,
    pad_pow2,
)
from k8s_spot_rescheduler_tpu_torch.models.tensors import (
    PackedCluster,
    tenant_slice,
    to_device,
    to_numpy,
)
from k8s_spot_rescheduler_tpu_torch.ops.ffd_kernels import KernelError
from k8s_spot_rescheduler_tpu_torch.parallel import tenant_batch
from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
    TorchSolverPlanner,
)
from k8s_spot_rescheduler_tpu_torch.service import buckets
from k8s_spot_rescheduler_tpu_torch.service import server as port_server
from k8s_spot_rescheduler_tpu_torch.service.agent import RemotePlanner
from k8s_spot_rescheduler_tpu_torch.service.server import (
    PlannerService,
    ServiceBusy,
    ServiceFault,
    ServiceServer,
)
from k8s_spot_rescheduler_tpu_torch.solver.fallback import union_program
from k8s_spot_rescheduler_tpu_torch.solver.select import selection_vector
from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig
from tests.test_repair import _affinity_swap_case, _rotation_coverage_case

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# stacks of tenants


def _all_invalid(b) -> PackedCluster:
    """A pad tenant: invalid lanes, empty slots, not-ok empty spots."""
    return tenant_slice(PlannerService._all_invalid_stack(b), 0)


def _stack(name: str):
    """(bucket, stacked numpy pack) of 4 tenants of one bucket:
    ``contended`` holds two pools greedy cannot prove (repair runs), a
    seeded random pack and an all-invalid pad tenant; ``config1`` four
    seeds of synthetic config 1, the last replaced by a pad tenant."""
    if name == "contended":
        rng = np.random.default_rng(11)
        tenants = [_affinity_swap_case(), _rotation_coverage_case(),
                   testing.random_pack(rng, 6, 5, 7, 1)]
    else:
        from tests.torch_port_fixtures import pack_config

        tenants = [pack_config(1, seed) for seed in range(3)]
    tenants = [PackedCluster(*t) for t in tenants]
    dims = np.max([buckets.bucket_for(t) for t in tenants], axis=0)
    b = buckets.Bucket(*(int(d) for d in dims))
    tenants.append(_all_invalid(b))
    return b, buckets.stack_bucket(
        [buckets.pad_to_bucket(t, b) for t in tenants], b
    )


STACKS = ("contended", "config1")


@pytest.mark.parametrize("rounds, best_fit", [(8, True), (0, True),
                                              (0, False)])
@pytest.mark.parametrize("stack", STACKS)
def test_plan_tenants_batched_matches_jax(stack, rounds, best_fit):
    _, stacked = _stack(stack)
    got = tenant_batch.make_tenant_batch_planner(
        rounds=rounds, best_fit_fallback=best_fit
    )(to_device(stacked, "cpu")).numpy()
    want = np.asarray(jax_tb.make_tenant_batch_planner(
        None, rounds=rounds, best_fit_fallback=best_fit
    )(JaxPackedCluster(*stacked)))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    # the serve-smoke rule: each row is the tenant's solo selection
    solve = union_program(rounds, best_fit, use_kernel=True)
    for t in range(got.shape[0]):
        solo = selection_vector(solve, to_device(tenant_slice(stacked, t),
                                                 "cpu"))
        assert np.array_equal(got[t], solo.numpy())
    if stack == "contended" and rounds:
        # greedy leaves the two contended pools unproven; repair
        # proves them
        greedy = tenant_batch.plan_tenants_batched(
            None, to_device(stacked, "cpu"), rounds=0)
        assert not greedy[:2, 1].any() and got[:2, 1].all()


@pytest.mark.parametrize("horizon", [4, 8])
@pytest.mark.parametrize("stack", STACKS)
def test_plan_tenants_scheduled_matches_jax(stack, horizon):
    _, stacked = _stack(stack)
    got = tenant_batch.make_tenant_schedule_planner(
        horizon=horizon, rounds=8
    )(to_device(stacked, "cpu")).numpy()
    want = np.asarray(jax_tb.make_tenant_schedule_planner(
        None, horizon=horizon, rounds=8
    )(JaxPackedCluster(*stacked)))
    assert got.shape == (4, horizon, stacked.slot_req.shape[2] + 3)
    assert np.array_equal(got, want)
    # tenants that ran out early hold -1 rows past their terminal probe
    ended = [t for t in range(4) if (got[t, :, 1] == 0).any()]
    assert ended
    for t in ended:
        stop = int(np.argmax(got[t, :, 1] == 0))
        assert (got[t, stop + 1:] == -1).all()


def test_tenant_mesh_is_refused():
    _, stacked = _stack("contended")
    with pytest.raises(ValueError, match="mesh"):
        tenant_batch.plan_tenants_batched(object(), to_device(stacked, "cpu"))


def _churned(packed: PackedCluster, seed: int) -> PackedCluster:
    """``packed`` with a few lanes, validity bits and spot rows changed."""
    rng = np.random.default_rng(seed)
    new = PackedCluster(*(np.array(f) for f in packed))
    C, S = new.slot_req.shape[0], new.spot_free.shape[0]
    for c in rng.choice(C, size=min(2, C), replace=False):
        new.slot_req[c] += 1.0
        new.slot_valid[c, 0] = ~new.slot_valid[c, 0]
    new.cand_valid[rng.integers(C)] ^= True
    for s in rng.choice(S, size=min(3, S), replace=False):
        new.spot_free[s] -= 2.0
        new.spot_count[s] += 1
        new.spot_aff[s, 0] ^= np.uint32(1 << 31)
        new.spot_taints[s, 0] ^= np.uint32(5)
    return new


@pytest.mark.parametrize("stack", STACKS)
def test_apply_tenant_deltas_matches_jax(stack):
    b, stacked = _stack(stack)
    T = stacked.slot_req.shape[0]
    bases = [tenant_slice(stacked, t) for t in range(T)]
    # the last tenant rides the batch with an empty delta, as a
    # full-pack tenant does
    news = [_churned(p, t) for t, p in enumerate(bases[:-1])] + [bases[-1]]
    deltas = [emit_packed_delta(p, n) for p, n in zip(bases, news)]
    rows = {sec: pad_pow2(max(len(getattr(d, sec)) for d in deltas))
            for sec in ("lanes", "cand_rows", "spot_rows")}
    padded = [pad_packed_delta(d, b.C, b.S, lane_rows=rows["lanes"],
                               cand_rows=rows["cand_rows"],
                               spot_rows=rows["spot_rows"], K=b.K)
              for d in deltas]
    stacked_delta = type(padded[0])(*(
        np.stack([getattr(d, f) for d in padded]) for f in padded[0]._fields
    ))
    got = to_numpy(tenant_batch.make_tenant_delta_applier()(
        *to_device(stacked, "cpu"), stacked_delta))
    from k8s_spot_rescheduler_tpu.models.columnar import (
        PackedDelta as JaxDelta,
    )

    want = jax_tb.apply_tenant_deltas(
        *(np.array(f) for f in stacked), JaxDelta(*stacked_delta))
    for f in PackedCluster._fields:
        assert np.array_equal(getattr(got, f), np.asarray(getattr(want, f))), f
        assert np.array_equal(getattr(got, f),
                              np.stack([getattr(n, f) for n in news])), f


# ---------------------------------------------------------------------------
# the queue under a virtual clock


def tiny_packed(n_lanes: int = 2, seed: int = 0) -> PackedCluster:
    """C=2 lanes, K=2 slots, S=2 spots; ``n_lanes`` valid lanes."""
    rng = np.random.default_rng(seed)
    C, K, S, R, W, A = 2, 2, 2, 2, 1, 2
    return PackedCluster(
        slot_req=rng.random((C, K, R), np.float32),
        slot_valid=np.ones((C, K), bool),
        slot_tol=np.zeros((C, K, W), np.uint32),
        slot_aff=np.zeros((C, K, A), np.uint32),
        cand_valid=np.arange(C) < n_lanes,
        spot_free=np.full((S, R), 100.0, np.float32),
        spot_count=np.zeros(S, np.int32),
        spot_max_pods=np.full(S, 58, np.int32),
        spot_taints=np.zeros((S, W), np.uint32),
        spot_ok=np.ones(S, bool),
        spot_aff=np.zeros((S, A), np.uint32),
    )


def _stub_solve(record=None):
    def solve(stacked, reqs):
        if record is not None:
            record.append([r.tenant for r in reqs])
        T = stacked.slot_req.shape[0]
        K = stacked.slot_req.shape[2]
        return np.zeros((T, 3 + K), np.int32)

    return solve


def _service(clock=None, solver="numpy", **kwargs) -> PlannerService:
    cfg = kwargs.pop("config", None) or ReschedulerConfig(solver=solver)
    return PlannerService(cfg, clock=clock or FakeClock(), batch_window_s=0,
                          device="cpu", **kwargs)


def test_flooding_tenant_cannot_starve_another():
    svc = _service(max_batch_tenants=2)
    batches = []
    svc.solve_hook = _stub_solve(batches)
    for i in range(20):
        svc.submit_nowait("flooder", tiny_packed(seed=i))
    victim = svc.submit_nowait("victim", tiny_packed(seed=99))
    assert svc.drain_once()
    assert batches[0] == ["flooder", "victim"]
    assert victim.event.is_set() and victim.reply.batch_tenants == 2
    while svc.drain_once():
        pass
    assert all(set(b) == {"flooder"} for b in batches[1:])
    assert svc.queue_depth() == 0


def test_drr_interleaves_within_batch_capacity():
    svc = _service(max_batch_tenants=6)
    batches = []
    svc.solve_hook = _stub_solve(batches)
    for tenant in ("a", "b", "c"):
        for i in range(3):
            svc.submit_nowait(tenant, tiny_packed(seed=i))
    assert svc.drain_once()
    assert batches[0][:3] == ["a", "b", "c"]
    assert sorted(batches[0]) == ["a", "a", "b", "b", "c", "c"]


def test_batch_picks_oldest_request_bucket():
    clock = FakeClock()
    svc = _service(clock, max_batch_tenants=8)
    batches = []
    svc.solve_hook = _stub_solve(batches)
    big = tiny_packed()._replace(
        slot_req=np.zeros((20, 2, 2), np.float32),
        slot_valid=np.ones((20, 2), bool),
        slot_tol=np.zeros((20, 2, 1), np.uint32),
        slot_aff=np.zeros((20, 2, 2), np.uint32),
        cand_valid=np.ones(20, bool),
    )
    elder = svc.submit_nowait("elder", big)
    clock.advance(1.0)
    for i in range(3):
        svc.submit_nowait(f"t{i}", tiny_packed(seed=i))
    assert svc.drain_once()
    assert batches[0] == ["elder"] and elder.event.is_set()


def test_expired_request_is_evicted_with_cadence_retry_after():
    svc = _service()
    svc.queue_timeout_s = 0.05
    svc._cadence_s = 3.2
    svc._thread = object()  # a scheduler that never drains
    before = metrics.service_snapshot()["tenant_evictions"]
    with pytest.raises(ServiceBusy) as err:
        svc.submit("loner", tiny_packed())
    assert err.value.retry_after == 4
    assert metrics.service_snapshot()["tenant_evictions"] == before + 1
    assert svc.queue_depth() == 0


def test_client_deadline_bounds_server_wait():
    svc = _service()
    svc._thread = object()
    t0 = time.monotonic()
    with pytest.raises(ServiceBusy):
        svc.submit("impatient", tiny_packed(), timeout_s=0.1)
    assert time.monotonic() - t0 < 5.0


def test_tenant_state_is_pruned():
    clock = FakeClock()
    svc = _service(clock)
    svc.solve_hook = _stub_solve()
    for i in range(5):
        svc.submit_nowait(f"churner-{i}", tiny_packed(seed=i))
    while svc.drain_once():
        pass
    assert len(svc._last_plan_wall) == 5 and svc._queues == {}
    clock.advance(port_server.TENANT_STATE_TTL_S + 10)
    svc.submit_nowait("fresh", tiny_packed())
    assert svc.drain_once()
    assert set(svc._last_plan_wall) == {"fresh"}


def test_solve_failure_contained_per_batch():
    svc = _service()

    def exploding(stacked, reqs):
        raise RuntimeError("device fell over")

    svc.solve_hook = exploding
    req = svc.submit_nowait("t", tiny_packed())
    assert svc.drain_once()
    assert req.error is not None and "device fell over" in str(req.error)
    assert svc.fatal is None
    svc.solve_hook = _stub_solve()
    req2 = svc.submit_nowait("t", tiny_packed())
    assert svc.drain_once() and req2.reply is not None


def test_device_error_flips_the_watchdog_to_the_host_path():
    """Off the card the watchdog keeps the JAX semantics: a device error
    flips it sick (gauge, /healthz) and the host path answers the next
    batches, bit-identically to the device path."""
    svc = _service(solver="torch",
                   config=ReschedulerConfig(device_sick_threshold=3))

    def failing(stacked, reqs):
        raise RuntimeError("device answered garbage")

    svc.solve_hook = failing
    bad = svc.submit_nowait("t", tiny_packed())
    assert svc.drain_once() and bad.error is not None
    assert svc.healthz_snapshot()["device"] == "sick"
    assert metrics.service_snapshot()["device_sick"] == 1
    ok = svc.submit_nowait("t", tiny_packed(seed=3))
    assert svc.drain_once() and ok.reply is not None
    assert svc.batch_log[-1]["path"] == "host"
    solo = _service(solver="torch")
    want = solo.submit_nowait("t", tiny_packed(seed=3))
    assert solo.drain_once()
    assert (ok.reply.index, ok.reply.n_feasible) == (want.reply.index,
                                                     want.reply.n_feasible)
    assert np.array_equal(ok.reply.row, want.reply.row)
    metrics.update_service_device_sick(False)


@pytest.mark.parametrize("cause", ["error", "out_of_memory", "slow",
                                   "canary"])
def test_watchdog_on_the_card_reports_and_never_serves_the_host(cause):
    """On a cuda service the watchdog's verdict is a report (gauge,
    /healthz): a device error or an out-of-memory fails its batch typed
    without ending the service, slowness and a failed canary flip it
    sick, and every later batch still runs on the device path (here the
    ``solve_hook`` seam) — none on the host path. Healthy solves while
    sick are the hysteresis probes that clear it."""
    clock = FakeClock()
    svc = _service(clock=clock, solver="torch", max_batch_tenants=8,
                   config=ReschedulerConfig(device_sick_threshold=3))
    svc.device = torch.device("cuda", 0)  # the hook stands in for the card
    calls = []

    def healthy(stacked, reqs):
        calls.append([r.tenant for r in reqs])
        return _stub_solve()(stacked, reqs)

    svc.solve_hook = healthy
    for _ in range(6):  # the shape's first solve, then the calibration
        req = svc.submit_nowait("t", tiny_packed())
        assert svc.drain_once() and req.reply is not None
    if cause == "slow":
        def slow(stacked, reqs):
            clock.advance(1.0)
            return healthy(stacked, reqs)

        svc.solve_hook = slow
        for _ in range(3):
            req = svc.submit_nowait("t", tiny_packed())
            assert svc.drain_once() and req.reply is not None
    else:
        err = {
            "error": RuntimeError("device answered garbage"),
            "out_of_memory": torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB"),
            "canary": RuntimeError("canary wedged"),
        }[cause]

        def failing(stacked, reqs):
            raise err

        svc.solve_hook = failing
        if cause == "canary":
            clock.advance(svc._devhealth.CANARY_INTERVAL_S + 1)
            svc.run_canary()
        else:
            bad = svc.submit_nowait("t", tiny_packed())
            assert svc.drain_once() and bad.error is not None
    assert svc.fatal is None
    assert svc.healthz_snapshot()["device"] == "sick"
    assert metrics.service_snapshot()["device_sick"] == 1
    svc.solve_hook = healthy
    before = len(calls)
    for seed in range(3):
        req = svc.submit_nowait("t", tiny_packed(seed=seed))
        assert svc.drain_once() and req.reply is not None
    assert len(calls) == before + 3
    assert svc.batch_log and not [
        b for b in svc.batch_log if b["path"] == "host"
    ]
    assert svc.healthz_snapshot()["device"] != "sick"
    assert metrics.service_snapshot()["device_sick"] == 0


@pytest.mark.parametrize("threshold", [0, 3])
def test_kernel_fault_ends_the_service(threshold):
    """A fault of the card's kernels is not contained and not a
    watchdog verdict: the batch fails, the service ends (ServiceFault
    now and on every later drain), queued work is answered, new work is
    refused, and no batch moves to the host path."""
    svc = _service(solver="torch", config=ReschedulerConfig(
        device_sick_threshold=threshold))
    told = []
    svc.on_fatal.append(lambda: told.append(True))

    def faulting(stacked, reqs):
        raise KernelError("ffd kernel launch failed: invalid argument")

    svc.solve_hook = faulting
    req = svc.submit_nowait("a", tiny_packed())
    with pytest.raises(ServiceFault):
        svc.drain_once()
    assert req.error is not None and svc.fatal is not None and told
    snap = svc.healthz_snapshot()
    assert snap["device"] in ("unwatched", "calibrating")
    with pytest.raises(ServiceBusy):
        svc.submit_nowait("b", tiny_packed())
    with pytest.raises(ServiceFault):
        svc.drain_once()
    assert not [b for b in svc.batch_log if b["path"] == "host"]


def test_kernel_fault_ends_serve_forever_non_zero():
    """Through HTTP: the agent's request fails (it falls back), and the
    server's ``serve_forever`` raises ServiceFault, which the CLI turns
    into exit 1."""
    server = ServiceServer(ReschedulerConfig(), "127.0.0.1:0",
                           batch_window_s=0, device="cpu")

    def faulting(stacked, reqs):
        raise KernelError("ffd kernel launch failed: invalid argument")

    server.service.solve_hook = faulting
    ended = {}

    def run():
        try:
            server.serve_forever()
        except ServiceFault as err:
            ended["fault"] = err

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    cfg = ReschedulerConfig(planner_timeout=30.0)
    agent = RemotePlanner(cfg, f"http://{server.address}", tenant="t")
    client = generate_cluster(CONFIGS[1], 0)
    store = client.columnar_store(cfg.resources,
                                  on_demand_label=cfg.on_demand_node_label,
                                  spot_label=cfg.spot_node_label)
    before = metrics.service_snapshot()["remote_planner_fallback"]
    report = agent.plan(store, client.list_pdbs())
    assert report.solver == "remote-fallback"
    assert metrics.service_snapshot()["remote_planner_fallback"] == before + 1
    thread.join(timeout=30)
    assert not thread.is_alive() and "fault" in ended


def test_delta_scatter_failure_serves_from_the_host_mirrors(monkeypatch):
    """A failed device scatter drops the device twins and serves the
    batch from the host mirrors: the same plan as the full pack."""
    svc = _service(solver="torch")
    old = tiny_packed(seed=1)
    new = _churned(old, 3)
    first = svc.submit_nowait("t", old, pack_fingerprint=pack_fingerprint(old))
    assert svc.drain_once() and first.reply is not None

    def broken(*args):
        raise RuntimeError("scatter failed")

    monkeypatch.setattr(port_server, "apply_tenant_deltas", broken)
    delta = emit_packed_delta(old, new)
    box = {}
    svc._thread = None
    thread = threading.Thread(target=lambda: box.setdefault(
        "reply", svc.submit_delta("t", delta, pack_fingerprint(old),
                                  pack_fingerprint(new))))
    thread.start()
    thread.join(timeout=60)
    assert svc._tenant_cache["t"].device is None
    want = _service(solver="torch").submit("t", new)
    got = box["reply"]
    assert (got.index, got.found, got.n_feasible) == (
        want.index, want.found, want.n_feasible)
    assert np.array_equal(got.row, want.row)


def test_delta_requests_match_full_packs_through_the_device_scatter():
    """v4 deltas ride the batched scatter on the service's device: each
    tenant's plan equals the plan of its full new pack, and the device
    twin equals the new pack bit for bit."""
    svc = _service(solver="torch")
    olds = [PackedCluster(*tiny_packed(seed=s)) for s in range(3)]
    news = [_churned(p, s) for s, p in enumerate(olds)]
    for s, p in enumerate(olds):
        svc.submit_nowait(f"t{s}", p, pack_fingerprint=pack_fingerprint(p))
    while svc.drain_once():
        pass
    replies = {}

    def send(s):
        replies[s] = svc.submit_delta(
            f"t{s}", emit_packed_delta(olds[s], news[s]),
            pack_fingerprint(olds[s]), pack_fingerprint(news[s]))

    threads = [threading.Thread(target=send, args=(s,)) for s in range(3)]
    svc._thread = object()  # the test drains
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while svc.queue_depth() < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert svc.drain_once()
    for t in threads:
        t.join(timeout=30)
    assert sorted(svc.batch_log[-1]["tenants"]) == ["t0", "t1", "t2"]
    for s in range(3):
        want = _service(solver="torch").submit(f"t{s}", news[s])
        got = replies[s]
        assert (got.index, got.n_feasible) == (want.index, want.n_feasible)
        assert np.array_equal(got.row, want.row)
        twin = to_numpy(svc._tenant_cache[f"t{s}"].device)
        b = svc._tenant_cache[f"t{s}"].bucket
        padded = buckets.pad_to_bucket(news[s], b)
        for f in PackedCluster._fields:
            assert np.array_equal(getattr(twin, f), getattr(padded, f)), f
    assert metrics.service_snapshot()["delta_requests"].get("applied", 0) >= 3


@pytest.mark.parametrize("horizon", [0, 2])
def test_batch_log_entry_precedes_every_reply(horizon):
    """A caller woken with its reply finds its batch, launches included,
    in ``batch_log``: the entry is written before any member is woken."""
    svc = _service(solver="torch")
    seen = []

    class Recording(threading.Event):
        def set(self):
            seen.append([list(b["tenants"]) for b in svc.batch_log])
            super().set()

    reqs = [svc.submit_nowait(f"t{s}", tiny_packed(seed=s),
                              schedule_horizon=horizon) for s in range(3)]
    for req in reqs:
        req.event = Recording()
    assert svc.drain_once()
    assert all(req.event.is_set() and req.error is None for req in reqs)
    assert seen == [[["t0", "t1", "t2"]]] * 3
    assert svc.batch_log[-1]["horizon"] == horizon


def test_unknown_delta_base_demands_a_resync():
    svc = _service(solver="torch")
    old, new = tiny_packed(seed=1), tiny_packed(seed=2)
    with pytest.raises(port_server.ResyncRequired):
        svc.submit_delta("nobody", emit_packed_delta(old, new),
                         pack_fingerprint(old), pack_fingerprint(new))


# ---------------------------------------------------------------------------
# HTTP: the serve-smoke core, interop, warm state, the CLI pair


def _fleet(n: int, cfg):
    out = []
    for seed in range(n):
        client = generate_cluster(CONFIGS[2], seed)
        store = client.columnar_store(cfg.resources,
                                      on_demand_label=cfg.on_demand_node_label,
                                      spot_label=cfg.spot_node_label)
        out.append((store, client.list_pdbs()))
    return out


def _selection(report):
    if report.plan is None:
        return (False, None, None, report.n_feasible)
    return (True, report.plan.node.node.name, dict(report.plan.assignments),
            report.n_feasible)


def _plan_together(agents, fleet):
    """Every agent plans its tenant at once; returns the reports."""
    reports = [None] * len(agents)
    barrier = threading.Barrier(len(agents))

    def run(i):
        barrier.wait(timeout=30)
        reports[i] = agents[i].plan(*fleet[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(agents))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return reports


def test_serve_smoke_core():
    """4 tenants planning together over HTTP through the port's service
    (its batch on the plain B1t/B2t) equal their solo plans by
    ``TorchSolverPlanner(device="cpu")`` and by the JAX package's
    planner; no agent falls back and the batches coalesce."""
    from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner
    from k8s_spot_rescheduler_tpu.utils.config import (
        ReschedulerConfig as JC,
    )

    cfg = ReschedulerConfig(resources=CONFIGS[2].resources,
                            planner_timeout=60.0, staged_chunk_lanes=0)
    fleet = _fleet(4, cfg)
    solo = TorchSolverPlanner(cfg, device="cpu")
    solo_sel = [_selection(solo.plan(store, pdbs)) for store, pdbs in fleet]
    jax_solo = SolverPlanner(JC(resources=CONFIGS[2].resources,
                                staged_chunk_lanes=0))
    jax_sel = [_selection(jax_solo.plan(store, pdbs))
               for store, pdbs in fleet]
    assert solo_sel == jax_sel
    server = ServiceServer(cfg, "127.0.0.1:0", batch_window_s=1.0,
                           device="cpu")
    server.start_background()
    try:
        before = metrics.service_snapshot()
        agents = [RemotePlanner(cfg, f"http://{server.address}",
                                tenant=f"t{i}") for i in range(4)]
        reports = _plan_together(agents, fleet)
        after = metrics.service_snapshot()
    finally:
        server.close()
    assert [r.solver for r in reports] == ["remote"] * 4
    assert [_selection(r) for r in reports] == solo_sel
    assert after["remote_planner_fallback"] == before["remote_planner_fallback"]
    assert max(len(b["tenants"]) for b in server.service.batch_log) >= 2


@pytest.mark.parametrize("direction", ["jax-agent-port-server",
                                       "port-agent-jax-server"])
def test_agents_and_services_interoperate(direction):
    cfg = ReschedulerConfig(resources=CONFIGS[2].resources,
                            planner_timeout=60.0)
    jcfg = JaxConfig(resources=CONFIGS[2].resources, planner_timeout=60.0,
                     solver="numpy")
    fleet = _fleet(2, cfg)
    if direction == "jax-agent-port-server":
        server = ServiceServer(cfg, "127.0.0.1:0", batch_window_s=0.01,
                               device="cpu")
        make_agent = JaxRemotePlanner
        agent_cfg = jcfg
    else:
        server = jax_server.ServiceServer(jcfg, "127.0.0.1:0",
                                          batch_window_s=0.01)
        make_agent = RemotePlanner
        agent_cfg = cfg
    server.start_background()
    try:
        agents = [make_agent(agent_cfg, f"http://{server.address}",
                             tenant=f"t{i}") for i in range(2)]
        reports = [a.plan(*f) for a, f in zip(agents, fleet)]
        # a second tick ships the delta (wire v4) over the same wire
        again = [a.plan(*f) for a, f in zip(agents, fleet)]
    finally:
        server.close()
    solo = TorchSolverPlanner(cfg, device="cpu")
    want = [_selection(solo.plan(*f)) for f in fleet]
    assert [r.solver for r in reports + again] == ["remote"] * 4
    assert [_selection(r) for r in reports] == want
    assert [_selection(r) for r in again] == want


def test_port_reads_the_jax_warm_state_file(tmp_path):
    """A port replica restarted on a JAX replica's state directory
    pre-runs the same buckets and names the same resync causes."""
    jcfg = JaxConfig(solver="numpy", service_state_dir=str(tmp_path))
    jsvc = jax_server.PlannerService(jcfg, clock=FakeClock(),
                                     batch_window_s=0)
    packs = [tiny_packed(seed=0), tiny_packed(seed=1)._replace(
        slot_req=np.zeros((12, 2, 2), np.float32),
        slot_valid=np.ones((12, 2), bool),
        slot_tol=np.zeros((12, 2, 1), np.uint32),
        slot_aff=np.zeros((12, 2, 2), np.uint32),
        cand_valid=np.ones(12, bool),
    )]
    for i, p in enumerate(packs):
        jsvc.submit_nowait(f"t{i}", JaxPackedCluster(*p),
                           pack_fingerprint=pack_fingerprint(p))
    while jsvc.drain_once():
        pass
    assert jsvc.save_state()
    svc = _service(solver="torch", config=ReschedulerConfig(
        service_state_dir=str(tmp_path)))
    warmed = svc.warm_start()
    assert sorted(warmed) == sorted(
        jax_buckets.bucket_for(JaxPackedCluster(*p)).key for p in packs)
    assert svc._warm_fps == {f"t{i}": pack_fingerprint(p)
                             for i, p in enumerate(packs)}
    assert svc._tenant_bucket == jsvc._tenant_bucket
    old, new = packs[0], tiny_packed(seed=5)
    with pytest.raises(port_server.ResyncRequired, match="restart"):
        svc.submit_delta("t0", emit_packed_delta(old, new),
                         pack_fingerprint(old), pack_fingerprint(new))
    # and the port's own file reads back the same way
    assert svc.save_state()
    again = _service(solver="torch", config=ReschedulerConfig(
        service_state_dir=str(tmp_path)))
    assert sorted(again.warm_start()) == sorted(warmed)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_and_agent_cli_pair_drains_as_the_jax_cli():
    """``--serve`` and an agent with ``--planner-url`` on config 1 drain
    what the JAX package's CLI drains (the frozen run), with no agent
    tick on the local fallback; SIGTERM drains the service to exit 0."""
    import re

    env = dict(os.environ, PYTHONPATH=ROOT)
    port = _free_port()
    serve = subprocess.Popen(
        [sys.executable, "-m", "k8s_spot_rescheduler_tpu_torch", "--serve",
         f"127.0.0.1:{port}", "--device", "cpu", "--no-metrics-server"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    try:
        import urllib.request

        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                    health = r.read().decode()
                break
            except OSError:
                assert serve.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        assert "B1t/B2t" in health
        agent = subprocess.run(
            [sys.executable, "-m", "k8s_spot_rescheduler_tpu_torch",
             *testing.CLI_ARGS, "--planner-url", f"http://127.0.0.1:{port}",
             "--planner-timeout", "60s"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        )
    finally:
        serve.terminate()
        out, _ = serve.communicate(timeout=60)
    assert agent.returncode == 0, agent.stderr[-2000:]
    drained = re.findall(r"tick \d+: drained=(\[.*?\])", agent.stderr)
    want = testing.load_ticks()["cli"]["records"]
    assert drained == [str(r["drained"]) for r in want]
    assert "remote_planner_fallback_total=0" in agent.stderr
    assert serve.returncode == 0, out[-2000:]


def test_service_flags_flow_into_config_and_refused_flags_stay_refused():
    from k8s_spot_rescheduler_tpu_torch.cli.main import (
        build_parser,
        config_from_args,
    )

    args = build_parser().parse_args([
        "--planner-urls", "http://a:1,http://b:2", "--planner-timeout", "3s",
        "--delta-wire-enabled", "false", "--device-sick-threshold", "5",
        "--service-drain-grace", "2s", "--service-state-dir", "/x",
        "--service-batch-window", "50ms", "--service-queue-timeout", "7s",
        "--service-resync-ingest-cap", "2",
        "--service-resync-ingest-budget", "1024", "--serve", "127.0.0.1:1",
    ])
    cfg = config_from_args(args)
    assert (cfg.planner_urls, cfg.planner_timeout, cfg.delta_wire_enabled,
            cfg.device_sick_threshold, cfg.service_drain_grace,
            cfg.service_state_dir, cfg.service_batch_window,
            cfg.service_queue_timeout, cfg.service_resync_ingest_cap,
            cfg.service_resync_ingest_budget) == (
        "http://a:1,http://b:2", 3.0, False, 5, 2.0, "/x", 0.05, 7.0, 2, 1024)
    assert args.serve == "127.0.0.1:1"
    chaos = config_from_args(build_parser().parse_args([
        "--service-chaos-profile", "heavy", "--service-chaos-seed", "4"]))
    assert (chaos.service_chaos_profile, chaos.service_chaos_seed) == (
        "heavy", 4)
    for flag in ("--service-chaos-profile", "--chaos-profile", "--mesh-shape",
                 "--solver-hbm-budget", "--carry-chunks", "--jax-cache-dir"):
        with pytest.raises(SystemExit):
            build_parser().parse_args([flag, "x"])
    assert not config_from_args(build_parser().parse_args([])).debug_endpoints
    assert config_from_args(build_parser().parse_args(
        ["--debug-endpoints", "true"])).debug_endpoints
    with pytest.raises(ValueError, match="chaos"):
        ReschedulerConfig(service_chaos_profile="flaky")
    with pytest.raises(ValueError):
        ReschedulerConfig(planner_timeout=0)


def test_healthz_names_the_batch_program_and_debug_is_absent():
    import json
    import urllib.error
    import urllib.request

    server = ServiceServer(ReschedulerConfig(), "127.0.0.1:0", device="cpu")
    server.start_background()
    try:
        with urllib.request.urlopen(f"http://{server.address}/healthz",
                                    timeout=10) as r:
            out = json.loads(r.read())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://{server.address}/debug/trace",
                                   timeout=10)
    finally:
        server.close()
    assert out["ok"] and out["solve_device"] == "cpu"
    assert out["batch_program"] == (
        "tenant-batch(torch union, plain B1t/B2t on cpu)")
    assert err.value.code == 404


def test_json_sidecar_plans_through_the_queue():
    import json
    import urllib.request

    from k8s_spot_rescheduler_tpu_torch.sidecar.server import PlannerSidecar
    from tests.test_kube import _node, _pod

    sidecar = PlannerSidecar(ReschedulerConfig(), "127.0.0.1:0",
                             device="cpu")
    sidecar.start_background()
    body = {
        "nodes": [_node("od-1", "worker"), _node("spot-1", "spot-worker")],
        "pods": [_pod("a", "od-1", cpu="300m"),
                 _pod("b", "od-1", cpu="200m")],
        "pdbs": [],
    }
    try:
        req = urllib.request.Request(
            f"http://{sidecar.address}/v1/plan",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
    finally:
        sidecar.close()
    assert out["found"] is True and out["node"] == "od-1"
    assert out["assignments"] == {"default/a": "spot-1",
                                  "default/b": "spot-1"}


def test_frozen_service_answers_hang_together():
    """The JAX service's frozen answers for chip smoke phase 8 belong to
    today's fleet: one entry a tenant of ``testing.SERVICE_TENANTS``, each
    batched row its solo selection and its schedule's first step, each
    tenant ``SERVICE_TICKS`` agent ticks without a fallback."""
    import json

    with open(testing.SERVICE_PATH) as f:
        frozen = json.load(f)
    assert [t["name"] for t in frozen["tenants"]] == [
        name for name, _, _ in testing.SERVICE_TENANTS]
    assert (frozen["horizon"], frozen["ticks"]) == (
        testing.SERVICE_HORIZON, testing.SERVICE_TICKS)
    for (name, config_id, seed), t in zip(testing.SERVICE_TENANTS,
                                          frozen["tenants"]):
        assert (t["config"], t["seed"]) == (config_id, seed)
        row = np.asarray(t["row"])
        assert t["row"] == t["solo"] and row[1] == 1
        sched = np.asarray(t["schedule"])
        assert sched.shape == (testing.SERVICE_HORIZON, row.size)
        assert np.array_equal(sched[0], row)
        assert len(t["records"]) == testing.SERVICE_TICKS
        assert not any(r["planner_fallback"] for r in t["records"])


def test_service_listens_with_a_fleet_backlog():
    """Agents connecting at once must not overflow the listen backlog
    (socketserver's default of 5 drops the rest's SYNs for 1 s)."""
    server = ServiceServer(ReschedulerConfig(), "127.0.0.1:0", device="cpu")
    try:
        assert server.server.request_queue_size >= 64
    finally:
        server.close()

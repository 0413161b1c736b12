"""The port's service fault layer (``service/chaos.py``) on the CPU
against the JAX package's.

- ``ServiceFaultPlan`` profiles, and the draws of ``ChaosAgentTransport``
  and ``ServiceChaos``: the same plan and the same call sequence give
  the same outcomes, bytes and clock in both packages.
- The agent's transport: a scripted 503 storm with its Retry-After, a
  slow-loris upload that eats the deadline, half-closed pooled sockets
  that the pool retries once on a fresh socket, and the
  ``--service-chaos-*`` flags arming the agent and the service.
- A corrupted request answers as the JAX service answers it (a 400 or
  a plan), never a crash.
- On the CPU the sick phase flips the watchdog and the host path
  answers, then the hysteresis probes recover it, step for step as the
  JAX service does. On a service configured for cuda (the ``solve_hook``
  seam standing in for the card, the tensors on the CPU) every batch
  stays on the device path, and a scripted solve error fails its batch
  typed without ending the service and is no fault of the card's
  kernels (``is_device_fault``).
- A fleet of agents under ``ServiceFaultPlan.profile("light", 0)``:
  every selection equals the no-chaos answer, no agent crashes, and the
  flight recorder's deltas equal the metrics' deltas.

Tolerance: exact everywhere.
"""

import dataclasses
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.loop import flight as ref_flight
from k8s_spot_rescheduler_tpu.service import chaos as ref_chaos
from k8s_spot_rescheduler_tpu.service import server as ref_server
from k8s_spot_rescheduler_tpu.service import wire as ref_wire
from k8s_spot_rescheduler_tpu.utils.clock import FakeClock as RefClock
from k8s_spot_rescheduler_tpu.utils.config import (
    ReschedulerConfig as RefConfig,
)
from k8s_spot_rescheduler_tpu_torch.io.synthetic import CONFIGS
from k8s_spot_rescheduler_tpu_torch.loop import flight
from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.ops.ffd_kernels import is_device_fault
from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
    TorchSolverPlanner,
)
from k8s_spot_rescheduler_tpu_torch.service import chaos as port_chaos
from k8s_spot_rescheduler_tpu_torch.service import wire
from k8s_spot_rescheduler_tpu_torch.service.agent import (
    PooledWireTransport,
    RemoteCallError,
    RemotePlanner,
)
from k8s_spot_rescheduler_tpu_torch.service.devhealth import (
    DeviceHealthWatchdog,
)
from k8s_spot_rescheduler_tpu_torch.service.server import (
    PlannerService,
    ServiceServer,
)
from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig
from tests.test_service import tiny_packed as ref_tiny_packed
from tests.test_torch_service import _fleet, _selection, tiny_packed

torch.set_num_threads(1)

PACKAGES = {"port": (port_chaos, FakeClock), "ref": (ref_chaos, RefClock)}


# --- plans and draws -----------------------------------------------------------


def test_profiles_equal_the_reference():
    assert (port_chaos.ServiceFaultPlan.PROFILES
            == ref_chaos.ServiceFaultPlan.PROFILES)
    for name in port_chaos.ServiceFaultPlan.PROFILES:
        assert dataclasses.asdict(
            port_chaos.ServiceFaultPlan.profile(name, 5)) == dataclasses.asdict(
            ref_chaos.ServiceFaultPlan.profile(name, 5)), name
    for mod in (port_chaos, ref_chaos):
        with pytest.raises(ValueError, match="unknown service chaos"):
            mod.ServiceFaultPlan.profile("bogus")
    with pytest.raises(ValueError, match="service_chaos_profile"):
        ReschedulerConfig(service_chaos_profile="bogus")
    assert ReschedulerConfig(service_chaos_profile="heavy",
                             service_chaos_seed=2).service_chaos_seed == 2


REPLY = b"reply-bytes-" + bytes(range(64))


def _transport_outcomes(package, plan_kw, calls=80):
    mod, clock_cls = PACKAGES[package]
    clock = clock_cls()
    t = mod.ChaosAgentTransport(lambda *a: REPLY,
                                mod.ServiceFaultPlan(**plan_kw), clock=clock)
    out = []
    for _ in range(calls):
        try:
            out.append(("ok", t("http://x/v2/plan", b"body", {}, 5.0)))
        except Exception as err:  # noqa: BLE001 — the outcome is the record
            out.append((type(err).__name__, str(err),
                        getattr(err, "retry_after", None)))
    return out, dict(t.stats), clock.now()


TRANSPORT_PLANS = {
    "heavy-11": dataclasses.asdict(
        port_chaos.ServiceFaultPlan.profile("heavy", 11)),
    "light-0": dataclasses.asdict(
        port_chaos.ServiceFaultPlan.profile("light", 0)),
    "scripted": dict(seed=3, http_503_script=(2, 5), reply_delay_rate=0.3,
                     reply_delay_s=9.0, reply_corrupt_rate=0.2,
                     reply_truncate_rate=0.1),
}


@pytest.mark.parametrize("plan", sorted(TRANSPORT_PLANS))
def test_agent_transport_draws_equal_the_reference(plan):
    got = _transport_outcomes("port", TRANSPORT_PLANS[plan])
    assert got == _transport_outcomes("ref", TRANSPORT_PLANS[plan])
    assert any(o[0] != "ok" for o in got[0])
    assert any(o[0] == "ok" and o[1] != REPLY for o in got[0]) or (
        plan == "light-0")


def _server_chaos_outcomes(package):
    mod, clock_cls = PACKAGES[package]
    clock = clock_cls()
    chaos = mod.ServiceChaos(mod.ServiceFaultPlan(
        seed=4, sick_phase=(3, 6, 1.5), solve_error_script=(2, 7),
        request_corrupt_rate=0.4), clock=clock)
    out = []
    for i in range(12):
        out.append(("active", chaos.sick_phase_active()))
        try:
            chaos.on_batch()
            out.append(("batch", clock.now()))
        except Exception as err:  # noqa: BLE001 — the outcome is the record
            out.append((type(err).__name__, str(err)))
        out.append(("corrupt", chaos.corrupt_request(bytes(range(i, i + 40)))))
    return out, dict(chaos.stats)


def test_server_chaos_draws_equal_the_reference():
    got = _server_chaos_outcomes("port")
    assert got == _server_chaos_outcomes("ref")
    assert got[1]["solve_error"] == 2 and got[1]["sick_latency"] == 4
    assert got[1]["request_corrupt"] > 0


# --- the agent's transport -----------------------------------------------------


def test_agent_transport_scripted_503_and_slow_loris():
    clock = FakeClock()
    t = port_chaos.ChaosAgentTransport(
        lambda *a: b"ok" + bytes(32),
        port_chaos.ServiceFaultPlan(http_503_script=(2,),
                                    http_503_retry_after=7.0),
        clock=clock)
    t("u", b"b", {}, 5.0)  # request 1 passes
    with pytest.raises(RemoteCallError) as exc:
        t("u", b"b", {}, 5.0)  # request 2 is the scripted 503
    assert exc.value.retry_after == 7.0
    loris = port_chaos.ChaosAgentTransport(
        lambda *a: b"ok", port_chaos.ServiceFaultPlan(slow_loris_rate=1.0),
        clock=clock)
    t0 = clock.now()
    with pytest.raises(TimeoutError):
        loris("u", b"b", {}, 5.0)
    assert clock.now() - t0 == pytest.approx(5.0)  # ate the whole deadline


def test_service_chaos_flags_arm_the_agent_and_the_service():
    off = ReschedulerConfig(planner_url="http://127.0.0.1:9")
    assert isinstance(RemotePlanner(off).transport, PooledWireTransport)
    assert PlannerService(off, device="cpu").chaos is None
    on = dataclasses.replace(off, service_chaos_profile="light",
                             service_chaos_seed=3)
    agent = RemotePlanner(on)
    assert isinstance(agent.transport, port_chaos.ChaosAgentTransport)
    assert agent.transport.pool is agent._wire_pool
    assert agent.transport.plan == port_chaos.ServiceFaultPlan.profile(
        "light", 3)
    svc = PlannerService(on, device="cpu")
    assert isinstance(svc.chaos, port_chaos.ServiceChaos)
    assert svc.chaos.plan == port_chaos.ServiceFaultPlan.profile("light", 3)


def test_half_closed_pooled_sockets_reconnect_without_a_fallback():
    cfg = ReschedulerConfig(resources=CONFIGS[2].resources,
                            planner_timeout=60.0)
    fleet = _fleet(1, cfg)
    server = ServiceServer(cfg, "127.0.0.1:0", batch_window_s=0.0,
                           device="cpu")
    server.start_background()
    try:
        agent = RemotePlanner(cfg, f"http://{server.address}", tenant="t0")
        agent.transport = port_chaos.ChaosAgentTransport(
            agent._wire_pool,
            port_chaos.ServiceFaultPlan(half_close_script=(2, 3)),
            pool=agent._wire_pool)
        before = metrics.service_snapshot()
        reports = [agent.plan(*fleet[0]) for _ in range(3)]
        after = metrics.service_snapshot()
    finally:
        server.close()
    assert [r.solver for r in reports] == ["remote"] * 3
    assert agent.transport.stats["half_close"] == 2
    assert after["wire_reconnects"] - before["wire_reconnects"] == 2
    assert after["remote_planner_fallback"] == before["remote_planner_fallback"]
    assert after["remote_planner_failover"] == before["remote_planner_failover"]


def test_a_failover_grafts_the_failed_attempt_as_a_wire_failover_span():
    import socket

    cfg = ReschedulerConfig(resources=CONFIGS[2].resources,
                            planner_timeout=60.0)
    fleet = _fleet(1, cfg)
    server = ServiceServer(cfg, "127.0.0.1:0", batch_window_s=0.0,
                           device="cpu")
    server.start_background()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead_port = s.getsockname()[1]
    s.close()
    try:
        agent = RemotePlanner(
            cfg, f"http://127.0.0.1:{dead_port},http://{server.address}",
            tenant="t0")
        before = metrics.service_snapshot()
        report = agent.plan(*fleet[0])
        after = metrics.service_snapshot()
    finally:
        server.close()
    assert report.solver == "remote"
    assert agent.last_endpoint == f"http://{server.address}"
    assert after["remote_planner_failover"] == (
        before["remote_planner_failover"] + 1)
    (sp,) = agent.last_trace.find("wire.failover")
    assert sp.attrs["error"] is True
    assert sp.attrs["endpoint"] == f"http://127.0.0.1:{dead_port}"


# --- the service ---------------------------------------------------------------


def _post(url, body):
    req = urllib.request.Request(
        f"{url}/v2/plan", data=body, method="POST",
        headers={"Content-Type": "application/octet-stream"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _corrupted_answers(package, seeds):
    if package == "port":
        server = ServiceServer(ReschedulerConfig(solver="numpy"),
                               "127.0.0.1:0", batch_window_s=0.0,
                               device="cpu")
        mod, body = port_chaos, wire.encode_plan_request("t", tiny_packed())
        decode = wire.decode_plan_reply
    else:
        server = ref_server.ServiceServer(RefConfig(solver="numpy"),
                                          "127.0.0.1:0", batch_window_s=0.0)
        mod = ref_chaos
        body = ref_wire.encode_plan_request("t", ref_tiny_packed())
        decode = ref_wire.decode_plan_reply
    server.start_background()
    url = f"http://{server.address}"
    out = []
    try:
        for seed in seeds:
            server.service.chaos = mod.ServiceChaos(
                mod.ServiceFaultPlan(seed=seed, request_corrupt_rate=1.0))
            status, raw = _post(url, body)
            if status == 200:
                reply = decode(raw)
                out.append((status, reply.index, reply.found,
                            reply.n_feasible, np.asarray(reply.row).tolist()))
            else:
                out.append((status,))
        server.service.chaos = None
        status, _ = _post(url, body)  # still serving, clean
        out.append(("after", status))
        out.append(("fatal", getattr(server.service, "fatal", None)))
    finally:
        server.close()
    return out


def test_corrupted_requests_answer_as_the_reference_and_never_crash():
    seeds = range(12)
    got = _corrupted_answers("port", seeds)
    assert got == _corrupted_answers("ref", seeds)
    statuses = [o[0] for o in got[:-2]]
    assert set(statuses) <= {200, 400} and 400 in statuses
    assert got[-2:] == [("after", 200), ("fatal", None)]


def _sick_script(package):
    """The JAX package's sick-phase test as one record: calibrate on the
    device path, a scripted sick phase flips the watchdog, the host path
    answers between probes, the phase ends and the probes recover."""
    mod, clock_cls = PACKAGES[package]
    clock = clock_cls()
    if package == "port":
        svc = PlannerService(ReschedulerConfig(solver="numpy"), clock=clock,
                             batch_window_s=0, device="cpu")
        packed, fl, snapshot = tiny_packed, flight, metrics.service_snapshot
    else:
        from k8s_spot_rescheduler_tpu.metrics import registry as ref_metrics

        svc = ref_server.PlannerService(RefConfig(solver="numpy"),
                                        clock=clock, batch_window_s=0)
        packed, fl = ref_tiny_packed, ref_flight
        snapshot = ref_metrics.service_snapshot
    hook_calls = []

    def device_hook(stacked, reqs):
        hook_calls.append(clock.now())
        T, K = stacked.slot_req.shape[0], stacked.slot_req.shape[2]
        return np.zeros((T, 3 + K), np.int32)

    svc.solve_hook = device_hook
    f0 = fl.RECORDER.counts()
    out = []

    def batch(seed):
        req = svc.submit_nowait("t", packed(seed=seed))
        assert svc.drain_once()
        out.append((seed, svc.healthz_snapshot()["device"], len(hook_calls),
                    req.reply is not None, req.error is not None))

    for i in range(DeviceHealthWatchdog.CALIBRATION_BATCHES + 1):
        batch(i)
    svc.chaos = mod.ServiceChaos(
        mod.ServiceFaultPlan(sick_phase=(1, 10**9, 2.0)), clock=clock)
    for i in range(svc.config.device_sick_threshold):
        batch(10 + i)
    out.append(("gauge", snapshot()["device_sick"]))
    svc._devhealth._last_probe = clock.now()  # close the probe window
    batch(30)
    svc.chaos.enabled = False
    for i in range(6):
        clock.advance(DeviceHealthWatchdog.PROBE_INTERVAL_S)
        batch(20 + i)
        if svc.healthz_snapshot()["device"] == "ok":
            break
    out.append(("gauge", snapshot()["device_sick"]))
    f1 = fl.RECORDER.counts()
    out.append(("flight", {k: f1.get(k, 0) - f0.get(k, 0)
                           for k in ("device-sick", "device-recovered")}))
    paths = [b["path"] for b in svc.batch_log] if package == "port" else None
    return out, paths


def test_sick_phase_on_the_cpu_takes_the_host_path_and_recovers():
    got, paths = _sick_script("port")
    want, _ = _sick_script("ref")
    assert got == want
    assert ("gauge", 1.0) in got and got[-2] == ("gauge", 0.0)
    assert got[-1] == ("flight", {"device-sick": 1, "device-recovered": 1})
    assert "host" in paths


def _cuda_service(clock):
    """A service configured for cuda whose tensors stay on the CPU: the
    batch cap is given, so no device memory is read."""
    svc = PlannerService(ReschedulerConfig(device_sick_threshold=3),
                         clock=clock, batch_window_s=0, device="cpu",
                         max_batch_tenants=8)
    svc.device = torch.device("cuda", 0)  # the hook stands in for the card
    return svc


def test_on_a_cuda_service_the_sick_phase_reports_and_batches_stay_on_the_card():
    clock = FakeClock()
    svc = _cuda_service(clock)
    calls = []

    def device_hook(stacked, reqs):
        calls.append(clock.now())
        T, K = stacked.slot_req.shape[0], stacked.slot_req.shape[2]
        return np.zeros((T, 3 + K), np.int32)

    svc.solve_hook = device_hook
    f0, m0 = flight.RECORDER.counts(), metrics.service_snapshot()
    for i in range(DeviceHealthWatchdog.CALIBRATION_BATCHES + 1):
        req = svc.submit_nowait("t", tiny_packed(seed=i))
        assert svc.drain_once() and req.reply is not None
    svc.chaos = port_chaos.ServiceChaos(
        port_chaos.ServiceFaultPlan(sick_phase=(1, 5, 2.0)), clock=clock)
    states = []
    for i in range(8):
        req = svc.submit_nowait("t", tiny_packed(seed=10 + i))
        assert svc.drain_once() and req.reply is not None
        states.append(svc.healthz_snapshot()["device"])
    assert "sick" in states and states[-1] == "ok"
    assert len(calls) == DeviceHealthWatchdog.CALIBRATION_BATCHES + 1 + 8
    assert [b["path"] for b in svc.batch_log] == ["device"] * len(calls)
    f1, m1 = flight.RECORDER.counts(), metrics.service_snapshot()
    assert f1.get("device-sick", 0) - f0.get("device-sick", 0) == 1
    assert f1.get("device-recovered", 0) - f0.get("device-recovered", 0) == 1
    assert m1["device_sick"] == m0["device_sick"] == 0
    assert svc.fatal is None


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_a_scripted_solve_error_is_no_device_fault_and_never_ends_the_service(
        device):
    clock = FakeClock()
    if device == "cuda":
        svc = _cuda_service(clock)
    else:
        svc = PlannerService(ReschedulerConfig(device_sick_threshold=3),
                             clock=clock, batch_window_s=0, device="cpu")
    svc.solve_hook = lambda stacked, reqs: np.zeros(
        (stacked.slot_req.shape[0], 3 + stacked.slot_req.shape[2]), np.int32)
    svc.chaos = port_chaos.ServiceChaos(
        port_chaos.ServiceFaultPlan(solve_error_script=(2,)), clock=clock)
    answers = []
    for i in range(4):
        req = svc.submit_nowait("t", tiny_packed(seed=i))
        assert svc.drain_once()
        answers.append((req.reply is not None, req.error is not None))
    assert answers == [(True, False), (False, True), (True, False),
                       (True, False)]
    assert svc.fatal is None and svc.chaos.stats["solve_error"] == 1
    # the watchdog noted the error (a sick verdict), then probes cleared it
    assert svc._devhealth.sick_total == 1
    if device == "cuda":
        assert not [b for b in svc.batch_log if b["path"] == "host"]
    metrics.update_service_device_sick(False)
    err = port_chaos.ServiceChaosError(
        "CUDA error: an illegal memory access was encountered")
    assert not is_device_fault(err)


# --- a fleet under the light profile -------------------------------------------


def test_fleet_under_light_chaos_keeps_every_selection():
    """4 agents on config-2 clusters plan through one service, their
    transports under ``ServiceFaultPlan.profile("light", 0)`` (resets,
    truncated replies, 5xx): every tick's selection equals the no-chaos
    solo plan (remote or the local oracle's fallback), nothing crashes,
    and the flight recorder counts each fallback and failover the
    metrics count."""
    cfg = ReschedulerConfig(resources=CONFIGS[2].resources,
                            planner_timeout=60.0, staged_chunk_lanes=0)
    fleet = _fleet(4, cfg)
    solo = TorchSolverPlanner(cfg, device="cpu")
    want = [_selection(solo.plan(*f)) for f in fleet]
    server = ServiceServer(cfg, "127.0.0.1:0", batch_window_s=0.0,
                           device="cpu")
    server.start_background()
    chaos_cfg = dataclasses.replace(cfg, service_chaos_profile="light",
                                    service_chaos_seed=0)
    f0, m0 = flight.RECORDER.counts(), metrics.service_snapshot()
    solvers = []
    try:
        agents = [RemotePlanner(dataclasses.replace(
            chaos_cfg, service_chaos_seed=i), f"http://{server.address}",
            tenant=f"t{i}") for i in range(4)]
        for _ in range(6):
            for i, agent in enumerate(agents):
                report = agent.plan(*fleet[i])
                solvers.append(report.solver)
                assert _selection(report) == want[i]
    finally:
        server.close()
    f1, m1 = flight.RECORDER.counts(), metrics.service_snapshot()
    injected = sum(sum(a.transport.stats.values()) for a in agents)
    assert injected > 0 and "remote" in solvers
    for kind, key in (("remote-planner-fallback", "remote_planner_fallback"),
                      ("failover", "remote_planner_failover")):
        assert f1.get(kind, 0) - f0.get(kind, 0) == m1[key] - m0[key], kind
    assert server.service.fatal is None

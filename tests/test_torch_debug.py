"""The port's debug surface, service window and agent transports on the
CPU, against the JAX package's.

- ``--debug-endpoints`` (``ReschedulerConfig.debug_endpoints``): off,
  ``/debug/trace`` and ``/debug/flight`` answer 404 on both services;
  on, they answer the same keys as the JAX service's, with the same
  redaction (tenant ids and identifier attributes hashed, structural
  attributes kept), and an unknown debug path is still 404.
- ``metrics/registry.reset_service_window`` clears what the JAX
  package's clears and keeps what it keeps, key by key of
  ``service_snapshot`` (counters by delta, gauges and maxima by value).
- ``PooledWireTransport.connection_count`` and the fresh-connection
  baseline ``RemotePlanner._transport_urllib`` answer as the JAX
  agent's do against the same service: one pooled connection across
  ticks and endpoints' reuse, the same decoded reply, and the same
  typed errors (400 detail, 503 Retry-After).

Tolerance: exact.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.io.synthetic import (
    CONFIGS as REF_CONFIGS,
    generate_cluster as ref_generate_cluster,
)
from k8s_spot_rescheduler_tpu.loop import flight as ref_flight
from k8s_spot_rescheduler_tpu.metrics import registry as ref_metrics
from k8s_spot_rescheduler_tpu.service import agent as ref_agent
from k8s_spot_rescheduler_tpu.service import server as ref_server
from k8s_spot_rescheduler_tpu.service import wire as ref_wire
from k8s_spot_rescheduler_tpu.utils.config import (
    ReschedulerConfig as RefConfig,
)
from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
    CONFIGS,
    generate_cluster,
)
from k8s_spot_rescheduler_tpu_torch.loop import flight
from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.service import agent
from k8s_spot_rescheduler_tpu_torch.service import server
from k8s_spot_rescheduler_tpu_torch.service import wire
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

torch.set_num_threads(1)

PACKAGES = {
    "port": (server, ReschedulerConfig, wire, flight, {"device": "cpu"},
             "torch"),
    "ref": (ref_server, RefConfig, ref_wire, ref_flight, {}, "numpy"),
}
TENANT = "team-a/cluster-7"
LABELS = {"on_demand_label": ReschedulerConfig().on_demand_node_label,
          "spot_label": ReschedulerConfig().spot_node_label}


def _serve(package: str, **knobs):
    srv_mod, cfg_cls, _, _, kw, solver = PACKAGES[package]
    srv = srv_mod.ServiceServer(
        cfg_cls(resources=CONFIGS[2].resources, solver=solver, **knobs),
        "127.0.0.1:0", batch_window_s=0.0, **kw)
    srv.start_background(scheduler=False)
    return srv


def _get(srv, path):
    try:
        with urllib.request.urlopen(f"http://{srv.address}{path}",
                                    timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _post_plan(package, srv, trace_id: str):
    """One wire plan of a tiny tenant (the same pack in both packages)."""
    _, _, wire_mod, _, _, _ = PACKAGES[package]
    gen = generate_cluster if package == "port" else ref_generate_cluster
    spec = (CONFIGS if package == "port" else REF_CONFIGS)[2]
    import dataclasses

    client = gen(dataclasses.replace(spec, n_on_demand=3, n_spot=3,
                                     n_pods=18), 5)
    store = client.columnar_store(spec.resources, **LABELS)
    packed, _ = store.pack(client.list_pdbs())
    body = wire_mod.encode_plan_request(TENANT, packed, trace_id=trace_id)
    req = urllib.request.Request(
        f"http://{srv.address}/v2/plan", data=body, method="POST",
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return wire_mod.decode_plan_reply(r.read())


@pytest.mark.parametrize("package", ("port", "ref"))
def test_debug_endpoints_off_answer_404(package):
    srv = _serve(package)
    try:
        for path in ("/debug/trace", "/debug/flight", "/debug/flight?dump=1"):
            assert _get(srv, path) == (404, {"error": "not found"}), path
        assert _get(srv, "/healthz")[0] == 200
    finally:
        srv.close()


def _debug_view(package):
    _, _, _, flight_mod, _, _ = PACKAGES[package]
    srv = _serve(package, debug_endpoints=True)
    try:
        reply = _post_plan(package, srv, trace_id="abc123")
        # an event carrying an identifier and a structural attribute
        flight_mod.note_event("orphan-taint-recovered", cause="debug probe",
                              tenant=TENANT, reason="max-inflight")
        trace = _get(srv, "/debug/trace")
        fl = _get(srv, "/debug/flight")
        dumped = _get(srv, "/debug/flight?dump=1")
        unknown = _get(srv, "/debug/nope")
    finally:
        srv.close()
    return reply, trace, fl, dumped, unknown


def test_debug_endpoints_on_answer_the_jax_services_keys_and_redaction():
    reply, trace, fl, dumped, unknown = _debug_view("port")
    ref_reply, ref_trace, ref_fl, ref_dumped, ref_unknown = _debug_view("ref")
    assert (reply.found, reply.index, reply.n_feasible) == (
        ref_reply.found, ref_reply.index, ref_reply.n_feasible)
    np.testing.assert_array_equal(reply.row, ref_reply.row)
    assert unknown == ref_unknown == (404, {"error": "not found"})
    assert trace[0] == ref_trace[0] == 200
    assert set(trace[1]) == set(ref_trace[1]) == {"last_tick",
                                                   "recent_requests"}
    got = trace[1]["recent_requests"][-1]
    want = ref_trace[1]["recent_requests"][-1]
    assert set(got) == set(want) == {"trace_id", "tenant", "spans"}
    assert got["trace_id"] == want["trace_id"] == "abc123"
    # the tenant id rides hashed, the same hash in both packages
    assert got["tenant"] == want["tenant"] == flight.redact_text(TENANT)
    assert got["tenant"] != TENANT
    assert [s["name"] for s in got["spans"]] == [
        s["name"] for s in want["spans"]]
    assert all(set(s) == {"name", "t0_ms", "dur_ms"} for s in got["spans"])
    assert fl[0] == ref_fl[0] == 200
    assert set(fl[1]) == set(ref_fl[1])
    event = [e for e in fl[1]["events"] if e["cause"] == "debug probe"][-1]
    ref_event = [e for e in ref_fl[1]["events"]
                 if e["cause"] == "debug probe"][-1]
    assert event["attrs"] == ref_event["attrs"]
    assert event["attrs"]["reason"] == "max-inflight"  # structural: kept
    assert event["attrs"]["tenant"] == flight.redact_text(TENANT)
    assert dumped[0] == ref_dumped[0] == 200
    assert set(dumped[1]) == set(ref_dumped[1]) and "dumped" in dumped[1]


def test_note_request_trace_keeps_the_last_32_redacted():
    srv = _serve("port", debug_endpoints=True)
    try:
        for i in range(40):
            srv.note_request_trace(f"t{i}", f"tenant-{i}",
                                   [("service.solve", 1.0, 2.5)])
        recent = srv.recent_request_traces()
    finally:
        srv.close()
    assert [r["trace_id"] for r in recent] == [f"t{i}" for i in range(8, 40)]
    assert recent[-1] == {
        "trace_id": "t39", "tenant": ref_flight.redact_text("tenant-39"),
        "spans": [{"name": "service.solve", "t0_ms": 1.0, "dur_ms": 2.5}]}


# --- the service window ------------------------------------------------------------


def _window_script(mod):
    mod.update_service_batch(12, 3, [("a", 5.0), ("b", 7.0), ("c", 900.0)],
                             occupancy=0.75)
    mod.update_service_batch(4, 1, [("a", 11.0)])
    mod.update_service_resync_ingest(3, 4096, admitted=True)
    mod.update_service_resync_ingest(0, 0)


def test_reset_service_window_equals_the_jax_package():
    snaps = {}
    for name, mod in (("port", metrics), ("ref", ref_metrics)):
        before = mod.service_snapshot()
        _window_script(mod)
        mid = mod.service_snapshot()
        mod.reset_service_window()
        after = mod.service_snapshot()
        snaps[name] = (before, mid, after, mod.service_queue_wait_summary())
    (before, mid, after, summary) = snaps["port"]
    (r_before, r_mid, r_after, r_summary) = snaps["ref"]
    assert set(after) == set(r_after)
    assert summary == r_summary == {"p50_ms": 0.0, "p99_ms": 0.0, "n": 0,
                                    "tenants": {}}
    cleared = ("queue_wait_p50_ms", "queue_wait_p99_ms", "tenant_queue_wait",
               "jain_served", "resync_ingest_inflight_max")
    for key in cleared:
        assert after[key] == r_after[key], key
    assert after["resync_ingest_inflight_max"] == 0
    assert after["tenant_queue_wait"] == {}
    # what the reset keeps: counters (by their deltas) and gauges (by
    # value), the batch run maxima included
    for key in after:
        if key in cleared:
            continue
        if key in ("requests", "delta_requests", "admission_shed"):
            assert after[key] == mid[key] and r_after[key] == r_mid[key], key
            continue
        assert after[key] == mid[key], key
        assert r_after[key] == r_mid[key], key
        if key in ("batch_lanes", "batch_tenants", "batch_occupancy",
                   "resync_ingest_inflight", "resync_ingest_ledger_bytes"):
            assert after[key] == r_after[key], key
    assert (mid["resync_ingest_admitted"] - before["resync_ingest_admitted"]
            == r_mid["resync_ingest_admitted"]
            - r_before["resync_ingest_admitted"] == 1)


# --- the agent's transports ------------------------------------------------------------------


def _agents_against(srv):
    url = f"http://{srv.address}"
    port_agent = agent.RemotePlanner(
        ReschedulerConfig(resources=CONFIGS[2].resources), url, tenant="t")
    ref_agent_ = ref_agent.RemotePlanner(
        RefConfig(resources=REF_CONFIGS[2].resources), url, tenant="t")
    return port_agent, ref_agent_


def test_connection_count_and_urllib_transport_equal_the_jax_agents():
    import dataclasses

    srv = _serve("port")
    try:
        port_agent, ref_agent_ = _agents_against(srv)
        spec = dataclasses.replace(CONFIGS[2], n_on_demand=3, n_spot=3,
                                   n_pods=18)
        ref_spec = dataclasses.replace(REF_CONFIGS[2], n_on_demand=3,
                                       n_spot=3, n_pods=18)
        client = generate_cluster(spec, 5)
        ref_client = ref_generate_cluster(ref_spec, 5)
        store = client.columnar_store(spec.resources, **LABELS)
        ref_store = ref_client.columnar_store(spec.resources, **LABELS)
        counts = []
        for a, st, c in ((port_agent, store, client),
                         (ref_agent_, ref_store, ref_client)):
            seen = [a._wire_pool.connection_count()]
            for _ in range(3):
                rep = a.plan(st, c.list_pdbs())
                assert rep.solver == "remote"
                seen.append(a._wire_pool.connection_count())
            counts.append(seen)
        assert counts[0] == counts[1] == [0, 1, 1, 1]

        packed, _ = store.pack(client.list_pdbs())
        body = wire.encode_plan_request("t2", packed)
        url = f"http://{srv.address}/v2/plan"
        hdrs = {"Content-Type": "application/octet-stream"}
        got = wire.decode_plan_reply(
            port_agent._transport_urllib(url, body, hdrs, 10.0))
        want = ref_wire.decode_plan_reply(
            ref_agent_._transport_urllib(url, body, hdrs, 10.0))
        assert (got.found, got.index, got.n_feasible) == (
            want.found, want.index, want.n_feasible)
        np.testing.assert_array_equal(got.row, want.row)
        assert port_agent._wire_pool.connection_count() == 1  # untouched

        errors = []
        for a, err_cls in ((port_agent, agent.RemoteCallError),
                           (ref_agent_, ref_agent.RemoteCallError)):
            with pytest.raises(err_cls) as bad:
                a._transport_urllib(url, b"not a wire frame", hdrs, 10.0)
            srv.max_inflight = 0
            try:
                with pytest.raises(err_cls) as busy:
                    a._transport_urllib(url, body, hdrs, 10.0)
            finally:
                srv.max_inflight = 16
            errors.append((str(bad.value), bad.value.retry_after,
                           str(busy.value).split(":")[0],
                           busy.value.retry_after > 0))
        assert errors[0] == errors[1]
        assert errors[0][0].startswith("HTTP 400") and errors[0][2] == "HTTP 503"
    finally:
        srv.close()

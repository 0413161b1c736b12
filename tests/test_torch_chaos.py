"""The port's kube fault layer (``io/chaos``) on the CPU against the JAX
package's.

- ``FaultPlan`` profiles and draws: the same plan and the same call
  sequence inject the same faults in both packages (outcome for outcome,
  ``stats`` for ``stats``), reads, writes and watch streams alike.
- The scripted faults: ``fail_n``, ``evict_429``, the quiesce switch, the
  refused columnar shortcut, and ``ChaosInterrupt`` as a
  ``BaseException``.
- Stream faults on the port's kube client against a ``StubApiServer``:
  a scripted 410, a drop and an open-but-silent stall, as the JAX
  package's client over the same stub sees them; a watch mirror under
  ``testing.WATCH_FAULTS`` re-lists natively and drains as the JAX
  package's fault-free run.
- The controller under ``FaultPlan.profile("heavy", 0)`` on
  ``device="cpu"`` drains, evicts, skips and counts tick by tick as the
  JAX package's on configs 1 and 2; the mid-drain crash heals on restart
  as the JAX package's does; the frozen config-1 run
  (``data/chaos_seed0.json``) equals a fresh run of both.
- The CLI: ``--chaos-*`` flags reach the config and wrap the client (the
  fake cluster on ``synthetic``, the kube client under the watch cache
  on ``kube``), and ``testing.CHAOS_CLI_ARGS`` ticks as the frozen JAX
  CLI run.

Tolerance: exact everywhere.
"""

import dataclasses
import logging
import re

import pytest
import torch

from k8s_spot_rescheduler_tpu.io import chaos as ref_chaos
from k8s_spot_rescheduler_tpu.io import kube as ref_kube
from k8s_spot_rescheduler_tpu.io import synthetic as ref_synthetic
from k8s_spot_rescheduler_tpu.models.cluster import Taint as RefTaint
from k8s_spot_rescheduler_tpu.utils.clock import FakeClock as RefClock
from k8s_spot_rescheduler_tpu_torch import testing
from k8s_spot_rescheduler_tpu_torch.cli.main import build_parser, config_from_args
from k8s_spot_rescheduler_tpu_torch.cli.main import main as port_main
from k8s_spot_rescheduler_tpu_torch.cli.main import start_watch_client
from k8s_spot_rescheduler_tpu_torch.io import chaos as port_chaos
from k8s_spot_rescheduler_tpu_torch.io import kube as port_kube
from k8s_spot_rescheduler_tpu_torch.io import native_ingest
from k8s_spot_rescheduler_tpu_torch.io import synthetic as port_synthetic
from k8s_spot_rescheduler_tpu_torch.io.cluster import EvictionError
from k8s_spot_rescheduler_tpu_torch.loop.controller import Rescheduler
from k8s_spot_rescheduler_tpu_torch.metrics import registry as port_metrics
from k8s_spot_rescheduler_tpu_torch.models.cluster import Taint
from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
    TorchSolverPlanner,
)
from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig
from tests.torch_port_fixtures import (
    reference_chaos_run,
    reference_crash_run,
    reference_kube_run,
)

torch.set_num_threads(1)

PACKAGES = {
    "port": (port_chaos, port_synthetic, Taint, FakeClock),
    "ref": (ref_chaos, ref_synthetic, RefTaint, RefClock),
}


# --- profiles and draws --------------------------------------------------------


def test_profiles_equal_the_reference():
    assert port_chaos.FaultPlan.PROFILES == ref_chaos.FaultPlan.PROFILES
    for name in port_chaos.FaultPlan.PROFILES:
        got = dataclasses.asdict(port_chaos.FaultPlan.profile(name, 3))
        want = dataclasses.asdict(ref_chaos.FaultPlan.profile(name, 3))
        assert got == want, name
    for mod in (port_chaos, ref_chaos):
        with pytest.raises(ValueError, match="unknown chaos profile"):
            mod.FaultPlan.profile("flaky")
    with pytest.raises(ValueError, match="chaos_profile"):
        ReschedulerConfig(chaos_profile="flaky")
    with pytest.raises(ValueError, match="chaos_watch_stall_rate"):
        ReschedulerConfig(chaos_watch_stall_rate=1.5)


class _Streams:
    """An inner client's raw watch stream: ``n`` numbered events."""

    def __init__(self, n=50):
        self.n = n

    def _stream(self, path, read_timeout=330.0):
        for i in range(self.n):
            yield {"type": "ADDED", "object": {"n": i}}


def _script(package: str, profile: str, seed: int, steps: int = 400):
    """A fixed, seeded call sequence over ``package``'s
    ``ChaosClusterClient`` on its own fake config-1 cluster: every read
    verb, the three writes and watch streams; returns each call's
    outcome, the fault stats and the cluster's evictions and taints."""
    chaos_mod, synthetic, taint_cls, _ = PACKAGES[package]
    fc = synthetic.generate_cluster(synthetic.CONFIGS[1], 0,
                                    reschedule_evicted=True)
    plan = dataclasses.replace(
        chaos_mod.FaultPlan.profile(profile, seed),
        watch_410_streams=(2,), watch_stall_rate=0.2,
        fail_n={"list_pdbs": 2}, latency_s={"get_pod": 0.5})
    chaos = chaos_mod.ChaosClusterClient(fc, plan, clock=fc.clock)
    fc._stream = _Streams()._stream
    nodes = sorted(fc.nodes)
    pods = sorted(fc.pods)
    out = []
    for i in range(steps):
        kind = i % 11
        try:
            if kind == 0:
                got = [n.name for n in chaos.list_ready_nodes()]
            elif kind == 1:
                got = [n.name for n in chaos.list_unready_nodes()]
            elif kind == 2:
                got = [p.uid for p in chaos.list_pods_on_node(
                    nodes[i % len(nodes)])]
            elif kind == 3:
                got = [p.uid for p in chaos.list_unschedulable_pods()]
            elif kind == 4:
                got = len(chaos.list_pdbs())
            elif kind == 5:
                ns, name = pods[i % len(pods)].split("/")
                pod = chaos.get_pod(ns, name)
                got = None if pod is None else pod.uid
            elif kind == 6:
                uid = pods[(7 * i) % len(pods)]
                pod = fc.pods.get(uid)
                if pod is not None:
                    chaos.evict_pod(pod, 30)
                got = uid
            elif kind == 7:
                chaos.add_taint(nodes[i % len(nodes)],
                                taint_cls("chaos-test", str(i), "NoSchedule"))
                got = None
            elif kind == 8:
                chaos.remove_taint(nodes[i % len(nodes)], "chaos-test")
                got = None
            elif kind == 9:
                got = sum(1 for _ in chaos._stream("/api/v1/pods?watch=1",
                                                   30.0))
            else:
                chaos.event("Node", nodes[0], "Normal", "Test", "m")
                got = None
            out.append((kind, "ok", got))
        except Exception as err:  # noqa: BLE001 — the outcome is the record
            out.append((kind, type(err).__name__, str(err)))
    taints = {n: sorted((t.key, t.value) for t in fc.nodes[n].taints)
              for n in nodes}
    return out, dict(chaos.stats), list(fc.evictions), taints, fc.clock.now()


@pytest.mark.parametrize("profile, seed", [("heavy", 0), ("heavy", 7),
                                           ("light", 3)])
def test_draws_equal_the_reference_for_the_same_call_sequence(profile, seed):
    got = _script("port", profile, seed)
    want = _script("ref", profile, seed)
    assert got == want
    outcomes = {o[1] for o in got[0]}
    assert {"ok", "ChaosError"} <= outcomes
    assert got[1].get("watch_410") == 1 and got[1].get("watch_stall", 0) > 0
    assert (got[1].get("stale_read", 0) > 0) == (profile == "heavy")


def test_scripted_fail_n_and_evict_429():
    fc = port_synthetic.generate_cluster(port_synthetic.CONFIGS[1], 0)
    pod = next(iter(fc.pods.values()))
    chaos = port_chaos.ChaosClusterClient(
        fc, port_chaos.FaultPlan(fail_n={"list_unschedulable_pods": 2},
                                 evict_429={pod.uid: 2}), clock=fc.clock)
    for _ in range(2):
        with pytest.raises(port_chaos.ChaosError, match="scripted"):
            chaos.list_unschedulable_pods()
    assert chaos.list_unschedulable_pods() == []
    for _ in range(2):
        with pytest.raises(EvictionError, match="429"):
            chaos.evict_pod(pod, 30)
    chaos.evict_pod(pod, 30)
    assert fc.evictions == [pod.uid]
    assert chaos.stats == {"list_unschedulable_pods": 2, "evict_429": 2}


def test_quiesce_interrupt_and_the_refused_mirror():
    fc = port_synthetic.generate_cluster(port_synthetic.CONFIGS[1], 0)
    chaos = port_chaos.ChaosClusterClient(
        fc, port_chaos.FaultPlan(error_rates={"list_pdbs": 1.0},
                                 interrupt_on_taint=1), clock=fc.clock)
    assert getattr(chaos, "columnar_store", None) is None
    assert chaos.clock is fc.clock  # everything else delegates
    with pytest.raises(port_chaos.ChaosError):
        chaos.list_pdbs()
    assert issubclass(port_chaos.ChaosInterrupt, BaseException)
    assert not issubclass(port_chaos.ChaosInterrupt, Exception)
    node = sorted(fc.nodes)[0]
    with pytest.raises(port_chaos.ChaosInterrupt):
        chaos.add_taint(node, Taint("k", "v", "NoSchedule"))
    assert [t.key for t in fc.nodes[node].taints][-1] == "k"  # applied
    chaos.enabled = False
    assert chaos.list_pdbs() == list(fc.pdbs)


# --- stream faults on the kube client ------------------------------------------


def _stream_outcomes(package, plan_kw):
    chaos_mod, _, _, clock_cls = PACKAGES[package]
    kube = port_kube if package == "port" else ref_kube
    spec = dataclasses.replace(port_synthetic.CONFIGS[1])
    stub = testing.StubApiServer.from_cluster(
        port_synthetic.generate_cluster(spec, 0), watch_slice=0.05)
    clock = clock_cls()
    try:
        chaos = chaos_mod.ChaosClusterClient(
            kube.KubeClusterClient(stub.url),
            chaos_mod.FaultPlan(seed=2, **plan_kw), clock=clock)
        for uid in sorted(stub.objects["pods"])[:6]:
            stub.push("pods", "MODIFIED", stub.objects["pods"][uid])
        out = []
        for _ in range(3):
            events = []
            try:
                for event in chaos._stream(
                        "/api/v1/pods?watch=1&resourceVersion=0"
                        "&timeoutSeconds=1", 7.0):
                    events.append(event.get("type"))
                    if event.get("type") == "ERROR":
                        events.append(event["object"]["code"])
                out.append(("end", events))
            except Exception as err:  # noqa: BLE001 — the outcome is the record
                out.append((type(err).__name__, events))
        return out, dict(chaos.stats), clock.now()
    finally:
        stub.close()


@pytest.mark.parametrize("plan_kw", [
    {"watch_410_streams": (1, 3)},
    {"watch_drop_rate": 0.5},
    {"watch_stall_rate": 1.0},
], ids=["410", "drop", "stall"])
def test_stream_faults_on_the_kube_client_equal_the_reference(plan_kw):
    got = _stream_outcomes("port", plan_kw)
    assert got == _stream_outcomes("ref", plan_kw)
    out, stats, slept = got
    if "watch_410_streams" in plan_kw:
        assert out[0] == ("end", ["ERROR", 410]) and out[2] == out[0]
        assert out[1][0] == "end" and len(out[1][1]) >= 6
        assert stats == {"watch_410": 2}
    elif "watch_drop_rate" in plan_kw:
        assert any(kind == "ConnectionResetError" for kind, _ in out)
        assert stats["watch_drop"] >= 1
    else:
        assert out == [("TimeoutError", [])] * 3 and slept == 21.0
        assert stats == {"watch_stall": 3}


@pytest.mark.skipif(native_ingest._compiler() is None,
                    reason="no C++ compiler: no native re-list to check")
def test_watch_faults_relist_natively_and_drain_as_the_reference(monkeypatch):
    """The port's watch mirror over a ``ChaosClusterClient`` with only
    ``testing.WATCH_FAULTS`` (two scripted 410s and dropped streams):
    re-lists happen and decode natively, and every tick equals the JAX
    package's fault-free run through the stub (config 1)."""
    name, config_id, ticks, horizon = testing.SMALL_KUBE_RUNS[0]
    spec = port_synthetic.CONFIGS[config_id]
    cfg = testing.controller_config(ReschedulerConfig, spec, horizon,
                                    "columnar")
    planner = TorchSolverPlanner(cfg, device="cpu")
    seen = testing.track_observations(planner)
    clock = FakeClock()
    parses = []
    for name in ("parse_pod_list", "parse_node_list"):
        parse = getattr(native_ingest, name)
        monkeypatch.setattr(native_ingest, name,
                            lambda data, parse=parse: parses.append(1)
                            or parse(data))
    plan = port_chaos.FaultPlan(seed=0, **testing.WATCH_FAULTS)
    chaos = []

    def start(kube_client):
        chaos.append(port_chaos.ChaosClusterClient(kube_client, plan,
                                                   clock=clock))
        return start_watch_client(chaos[0], cfg, clock)

    stub = testing.StubApiServer.from_cluster(
        port_synthetic.generate_cluster(spec, 0), watch_slice=0.05)
    try:
        got = testing.run_kube(
            stub, ticks, kube_cls=port_kube.KubeClusterClient,
            start_watching=start, clock=clock,
            make_rescheduler=lambda wc: Rescheduler(
                wc, planner, cfg, clock=clock, recorder=wc))
    finally:
        stub.close()
    assert chaos[0].stats["watch_410"] >= 1
    # the node and pod seeds and at least one re-list (the 410s hit two
    # of the three watchers' first streams, so a node or pod one)
    assert len(parses) >= 3
    assert seen and set(seen) == {"ColumnarObservation"}
    assert got == reference_kube_run(name, config_id, ticks, horizon)[
        "records"]


# --- the controller under chaos --------------------------------------------------


def _port_chaos_run(config_id, ticks, horizon, seed=0, profile="heavy"):
    spec = port_synthetic.CONFIGS[config_id]
    client = port_synthetic.generate_cluster(spec, seed,
                                             reschedule_evicted=True)
    digest = testing.cluster_digest(client)
    cfg = testing.controller_config(ReschedulerConfig, spec, horizon,
                                    "columnar")
    planner = TorchSolverPlanner(cfg, device="cpu")
    seen = testing.track_observations(planner)
    chaos = port_chaos.ChaosClusterClient(
        client, port_chaos.FaultPlan.profile(profile, seed),
        clock=client.clock)
    r = Rescheduler(chaos, planner, cfg, clock=client.clock, recorder=chaos)
    records = testing.chaos_ticks(r, chaos, ticks,
                                  port_metrics.robustness_snapshot)
    assert set(seen) <= {"NodeMap"}
    return {"config": config_id, "ticks": ticks, "schedule_horizon": horizon,
            "profile": profile, "digest": digest, "records": records,
            "stats": dict(sorted(chaos.stats.items()))}


@pytest.mark.parametrize("config_id, ticks", [(1, 10), (2, 3)])
def test_controller_under_heavy_chaos_equals_the_reference(config_id, ticks):
    got = _port_chaos_run(config_id, ticks, testing.CHAOS_HORIZON)
    want = reference_chaos_run(config_id, ticks, testing.CHAOS_HORIZON)
    assert got == want
    assert any(rec["skipped"] == "error" for rec in got["records"])
    if config_id == 1:
        assert any(rec["drained"] for rec in got["records"])


def test_frozen_chaos_runs_hang_together():
    """``data/chaos_seed0.json`` is what the JAX package does now on its
    small run, and the port does the same; its config-3 runs start
    from the cluster the port generates."""
    frozen = testing.load_chaos()
    runs = {name: (config_id, ticks)
            for name, config_id, ticks in testing.CHAOS_RUNS}
    assert set(frozen["runs"]) == set(runs)
    small = frozen["runs"]["heavy-config1"]
    assert reference_chaos_run(1, 10, testing.CHAOS_HORIZON) == small
    assert _port_chaos_run(1, 10, testing.CHAOS_HORIZON) == small
    digest = testing.cluster_digest(port_synthetic.generate_cluster(
        port_synthetic.CONFIGS[3], 0, reschedule_evicted=True))
    assert frozen["runs"]["heavy-config3"]["digest"] == digest
    assert frozen["crash"]["digest"] == digest
    assert frozen["crash"]["crashed"] and frozen["crash"]["healed"] == 1
    assert frozen["crash"]["orphaned"] and not frozen["crash"][
        "tainted_after_restart"]
    poll = frozen["poll"][testing.POLL_RUNS[0][0]]
    assert poll["digest"] == testing.cluster_digest(
        port_synthetic.generate_cluster(port_synthetic.CONFIGS[3], 0))
    assert frozen["cli"]["args"] == list(testing.CHAOS_CLI_ARGS)


def test_mid_drain_crash_recovers_on_restart_as_the_reference():
    config_id, ticks, horizon = 2, 2, testing.CHAOS_HORIZON
    spec = port_synthetic.CONFIGS[config_id]
    client = port_synthetic.generate_cluster(spec, 0, reschedule_evicted=True)
    cfg = testing.controller_config(ReschedulerConfig, spec, horizon,
                                    "columnar")
    chaos = port_chaos.ChaosClusterClient(
        client, port_chaos.FaultPlan(seed=0, interrupt_on_taint=1),
        clock=client.clock)
    got = testing.crash_run(
        client, chaos,
        lambda c: Rescheduler(c, TorchSolverPlanner(cfg, device="cpu"), cfg,
                              clock=client.clock, recorder=c),
        ticks, port_metrics.robustness_snapshot)
    want = reference_crash_run(config_id, ticks, horizon)
    assert got == {k: v for k, v in want.items()
                   if k not in ("config", "schedule_horizon", "digest")}
    assert got["crashed"] and got["healed"] == 1 and got["orphaned"]
    assert not got["evicted_before_restart"]
    assert got["records"][0]["drained"] == got["orphaned"]


# --- the CLI -------------------------------------------------------------------


def test_chaos_flags_reach_the_config():
    cfg = config_from_args(build_parser().parse_args([
        "--chaos-profile", "heavy", "--chaos-seed", "9",
        "--chaos-watch-stall-rate", "0.25"]))
    assert (cfg.chaos_profile, cfg.chaos_seed, cfg.chaos_watch_stall_rate) == (
        "heavy", 9, 0.25)
    assert config_from_args(build_parser().parse_args([])).chaos_profile == ""


def test_cli_under_chaos_ticks_as_the_frozen_reference(caplog, monkeypatch):
    caplog.set_level(logging.INFO, logger="spot_rescheduler_tpu")
    wrapped = []
    init = port_chaos.ChaosClusterClient.__init__

    def recording(self, inner, plan, **kw):
        wrapped.append((type(inner).__name__, plan))
        init(self, inner, plan, **kw)

    monkeypatch.setattr(port_chaos.ChaosClusterClient, "__init__", recording)
    assert port_main([*testing.CHAOS_CLI_ARGS, "--device", "cpu"]) == 0
    ticks = [m.group(1) for m in (re.search(r"(tick \d+: .*)$", msg)
                                  for msg in caplog.messages) if m]
    assert ticks == testing.load_chaos()["cli"]["ticks"]
    assert [w[0] for w in wrapped] == ["FakeCluster"]
    assert wrapped[0][1] == port_chaos.FaultPlan.profile("light", 0)


def test_cli_wraps_the_kube_client_under_the_watch_cache(monkeypatch):
    """On ``kube`` the CLI wraps the kube client (exotic ``--resources``
    turn its native decoder off) and the watch cache wraps the chaos
    client, so the watch streams pass the fault layer."""
    wrapped = []
    init = port_chaos.ChaosClusterClient.__init__

    def recording(self, inner, plan, **kw):
        wrapped.append((type(inner).__name__, plan, inner.use_native_ingest))
        init(self, inner, plan, **kw)

    monkeypatch.setattr(port_chaos.ChaosClusterClient, "__init__", recording)
    started = []
    import k8s_spot_rescheduler_tpu_torch.cli.main as cli

    def start(client, config, clock):
        started.append(type(client).__name__)
        return start_watch_client(client, config, clock)

    monkeypatch.setattr(cli, "start_watch_client", start)
    stub = testing.StubApiServer.from_cluster(
        port_synthetic.generate_cluster(port_synthetic.CONFIGS[1], 0))
    try:
        assert port_main([
            "--cluster", f"kube:{stub.url}", "--watch-cache", "true",
            "--ticks", "1", "--no-metrics-server", "--housekeeping-interval",
            "0s", "--device", "cpu", "--chaos-profile", "light",
            "--chaos-seed", "1", "--chaos-watch-stall-rate", "0.1",
            "--resources", "cpu,memory,nvidia.com/gpu"]) == 0
    finally:
        stub.close()
    assert [w[0] for w in wrapped] == ["KubeClusterClient"]
    assert wrapped[0][2] is False  # nvidia.com/gpu: Python decoders
    assert wrapped[0][1] == dataclasses.replace(
        port_chaos.FaultPlan.profile("light", 1), watch_stall_rate=0.1)
    assert started == ["ChaosClusterClient"]

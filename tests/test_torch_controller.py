"""The port's Planner surface, pipelined staged solve, controller and
CLI on the CPU against the JAX package.

- ``TorchSolverPlanner.plan``, ``plan_async`` and ``plan_schedule`` on
  ``device="cpu"`` give the ``DrainPlan``, the ``PlanReport`` counts and
  the ``DrainSchedule`` steps of ``SolverPlanner(solver="jax")``, and a
  schedule step that churn invalidates is invalidated for the same
  reason; with ``solver="numpy"`` both packages' host oracles agree;
- the pipelined ``StagedPlanner`` (chunk i+1 dispatched before chunk i
  is fetched) gives the selection and ``StagedStats`` of a plain
  one-chunk-at-a-time loop;
- on ``synthetic:1`` and ``synthetic:2`` the port's ``Rescheduler``
  drains the same nodes and evicts the same pods, tick by tick, as the
  reference's, with schedules on and off: on the columnar mirror (the
  default observe path, asserted on both sides) and on the object path
  (``use_columnar=False`` on both sides);
- through ``testing.StubApiServer`` serving config 1, the port's watch
  client and mirror drain as the reference's do through the same
  server;
- the small runs frozen in ``data/ticks_seed0.json`` equal a fresh run
  of the JAX package;
- the port's CLI exits 0 with the same drains, and still refuses the
  flags of later slices;
- a ``DrainSchedule`` is not built without its planner's device.

Tolerance: exact everywhere (node names, pod UIDs, integer counts).
"""

import logging
import re

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.io import synthetic as ref_synthetic
from k8s_spot_rescheduler_tpu.loop.controller import Rescheduler as RefRescheduler
from k8s_spot_rescheduler_tpu.models import cluster as ref_cluster
from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner
from k8s_spot_rescheduler_tpu.solver.fallback import with_repair
from k8s_spot_rescheduler_tpu.solver.ffd import plan_ffd as ref_plan_ffd
from k8s_spot_rescheduler_tpu.solver.select import (
    StagedPlanner as RefStagedPlanner,
)
from k8s_spot_rescheduler_tpu.utils.config import (
    ReschedulerConfig as RefConfig,
)
from k8s_spot_rescheduler_tpu_torch import testing
from k8s_spot_rescheduler_tpu_torch.cli.main import main as port_main
from k8s_spot_rescheduler_tpu_torch.cli.main import start_watch_client
from k8s_spot_rescheduler_tpu_torch.io import kube as port_kube
from k8s_spot_rescheduler_tpu_torch.io import synthetic as port_synthetic
from k8s_spot_rescheduler_tpu_torch.loop.controller import Rescheduler
from k8s_spot_rescheduler_tpu_torch.metrics import registry as port_metrics
from k8s_spot_rescheduler_tpu_torch.models import cluster as port_cluster
from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
from k8s_spot_rescheduler_tpu_torch.planner.schedule import DrainSchedule
from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
    TorchSolverPlanner,
)
from k8s_spot_rescheduler_tpu_torch.solver.fallback import union_program
from k8s_spot_rescheduler_tpu_torch.solver.select import (
    Selection,
    StagedPlanner,
    StagedStats,
    _lane_slice,
    selection_vector,
)
from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock
from k8s_spot_rescheduler_tpu_torch.utils.config import (
    ReschedulerConfig as PortConfig,
)
from tests.test_solver import _random_packed
from tests.test_torch_pack import _node_map
from tests.torch_port_fixtures import reference_kube_run, reference_run

torch.set_num_threads(1)


def _clusters(case: str):
    """Fresh (reference, port) FakeClusters and the spec of ``case``."""
    if case.startswith("config"):
        n = int(case[len("config"):])
        return (
            ref_synthetic.generate_cluster(ref_synthetic.CONFIGS[n], 0,
                                           reschedule_evicted=True),
            port_synthetic.generate_cluster(port_synthetic.CONFIGS[n], 0,
                                            reschedule_evicted=True),
            ref_synthetic.CONFIGS[n],
        )
    q = case[len("quality-"):]
    return (
        ref_synthetic.generate_quality_cluster(
            ref_synthetic.QUALITY_CONFIGS[q], 0
        ),
        port_synthetic.generate_quality_cluster(
            port_synthetic.QUALITY_CONFIGS[q], 0
        ),
        ref_synthetic.QUALITY_CONFIGS[q],
    )


def _plan_view(plan):
    if plan is None:
        return None
    return (plan.node.node.name, plan.candidate_index,
            [p.uid for p in plan.pods], dict(plan.assignments))


def _report_view(report):
    return (
        _plan_view(report.plan),
        report.n_candidates,
        report.n_feasible,
        report.chunks_solved,
        report.chunks_skipped,
        report.count_truncated,
        [_plan_view(p) for p in report.feasible_candidates],
        report.schedule_len,
        report.schedule_step,
    )


def _steps_view(steps):
    return [(s.index, s.n_feasible, np.asarray(s.row).tolist()) for s in steps]


def _planners(spec, horizon=6, solver="torch", **kw):
    resources = tuple(spec.resources)
    ref = SolverPlanner(RefConfig(
        resources=resources, solver="jax" if solver == "torch" else "numpy",
        schedule_horizon=horizon, **kw,
    ))
    port = TorchSolverPlanner(
        PortConfig(resources=resources, solver=solver,
                   schedule_horizon=horizon, **kw),
        device="cpu",
    )
    return ref, port


PLANNER_CASES = ["config1", "quality-affinity", "quality-contended"]


@pytest.mark.parametrize("solver", ["torch", "numpy"])
@pytest.mark.parametrize("case", PLANNER_CASES)
def test_plan_and_plan_async_match_the_reference(case, solver):
    ref_client, port_client, spec = _clusters(case)
    ref, port = _planners(spec, solver=solver)
    ref_obs = _node_map(ref_cluster, ref_client, ref.config)
    port_obs = _node_map(port_cluster, port_client, port.config)
    pdbs_r, pdbs_p = ref_client.list_pdbs(), port_client.list_pdbs()
    want = ref.plan(ref_obs, pdbs_r)
    got = port.plan(port_obs, pdbs_p)
    assert _report_view(got) == _report_view(want)
    assert got.solver == solver
    finish = port.plan_async(port_obs, pdbs_p)
    again = finish()
    assert _report_view(again) == _report_view(ref.plan_async(ref_obs, pdbs_r)())
    assert not again.full_repack  # the second tick of one pack: a delta
    assert port.fetches_total == 2
    assert port._pad_k == port.config.max_pods_per_node_hint


@pytest.mark.parametrize("solver", ["torch", "numpy"])
@pytest.mark.parametrize("case", PLANNER_CASES)
def test_plan_schedule_matches_the_reference(case, solver):
    """Same steps (the JAX package's host oracle for ``numpy``); step 0
    served from the cut's own observation; after a spot node vanishes,
    the next step is invalidated the same way."""
    ref_client, port_client, spec = _clusters(case)
    ref, port = _planners(spec, solver=solver)
    ref_obs = _node_map(ref_cluster, ref_client, ref.config)
    port_obs = _node_map(port_cluster, port_client, port.config)
    pdbs_r, pdbs_p = ref_client.list_pdbs(), port_client.list_pdbs()
    want = ref.plan_schedule(ref_obs, pdbs_r)
    got = port.plan_schedule(port_obs, pdbs_p)
    assert _steps_view(got.steps) == _steps_view(want.steps)
    assert port.schedule_lens == ref.schedule_lens
    assert got.device == port.device
    if not want.steps:
        assert _report_view(got.empty_report()) == _report_view(
            want.empty_report()
        )
        return
    r0_want = want.next_plan(ref_obs, pdbs_r)
    r0_got = got.next_plan(port_obs, pdbs_p)
    assert _report_view(r0_got) == _report_view(r0_want)
    # churn: the last spot node leaves both clusters
    gone = ref_obs.spot[-1].node.name
    ref_client.remove_node(gone)
    port_client.remove_node(gone)
    ref_obs = _node_map(ref_cluster, ref_client, ref.config)
    port_obs = _node_map(port_cluster, port_client, port.config)
    assert want.next_plan(ref_obs, pdbs_r) is None
    assert got.next_plan(port_obs, pdbs_p) is None
    assert want.invalidated and got.invalidated
    assert got.invalid_reason == want.invalid_reason


# --- the pipelined staged solve ---------------------------------------------


def _sequential_solve(staged, packed):
    """The staged solve one chunk at a time: each chunk fetched before
    the next is dispatched."""
    C, K = packed.slot_req.shape[:2]
    maybe = staged.dispatch_prefilter(packed).cpu().numpy()
    chunk = staged.chunk_lanes
    starts = list(range(0, C, chunk))
    runnable = [s for s in starts if maybe[s: s + chunk].any()]
    solved, n_feasible, found, row = 0, 0, -1, np.full(K, -1, np.int32)
    for start in runnable:
        size = min(chunk, C - start)
        vec = selection_vector(
            staged.solve_fn, _lane_slice(packed, start, size)
        ).cpu().numpy()
        solved += 1
        n_feasible += int(vec[2])
        if found < 0 and vec[1]:
            found, row = start + int(vec[0]), vec[3:]
            if staged.early_exit:
                break
    return (
        Selection(max(found, 0), found >= 0, n_feasible, row),
        StagedStats(solved, len(starts) - solved, int((~maybe).sum()),
                    found >= 0 and solved < len(runnable)),
    )


def _sel_view(sel):
    return (sel.index, bool(sel.found), sel.n_feasible,
            np.asarray(sel.row).tolist())


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("seed", range(3))
def test_pipelined_staged_solve_matches_one_chunk_at_a_time(
    seed, chunk, early_exit
):
    host = _random_packed(np.random.default_rng(1300 + seed))
    packed = to_device(host, "cpu")
    union = union_program(8, True, use_kernel=True)
    staged = StagedPlanner(union, chunk_lanes=chunk, early_exit=early_exit)
    sel, stats = staged.solve(packed)
    want_sel, want_stats = _sequential_solve(staged, packed)
    assert _sel_view(sel) == _sel_view(want_sel)
    assert stats == want_stats
    # and the JAX package's pipelined planner
    ref_sel, ref_stats = RefStagedPlanner(
        with_repair(ref_plan_ffd, 8), chunk_lanes=chunk, early_exit=early_exit
    ).solve(host)
    assert _sel_view(sel) == _sel_view(ref_sel)
    assert tuple(stats) == tuple(ref_stats)


# --- the controller and the CLI ---------------------------------------------


def _ref_run(case, horizon, ticks, observe):
    """The reference controller on ``case``: (records, the observation
    class names its planner packed from)."""
    ref_client, _, spec = _clusters(case)
    cfg = testing.controller_config(RefConfig, spec, horizon, observe)
    planner = SolverPlanner(cfg)
    seen = testing.track_observations(planner)
    r = RefRescheduler(ref_client, planner, cfg,
                       clock=ref_client.clock, recorder=ref_client)
    return testing.run_ticks(r, ref_client, ticks), seen


def _port_run(case, horizon, ticks, observe):
    _, port_client, spec = _clusters(case)
    cfg = testing.controller_config(PortConfig, spec, horizon, observe)
    planner = TorchSolverPlanner(cfg, device="cpu")
    seen = testing.track_observations(planner)
    r = Rescheduler(port_client, planner, cfg,
                    clock=port_client.clock, recorder=port_client)
    return testing.run_ticks(r, port_client, ticks), seen


@pytest.mark.parametrize("horizon", [32, 0], ids=["schedules", "horizon0"])
@pytest.mark.parametrize("case, ticks", [("config1", 4), ("config2", 3)])
def test_rescheduler_drains_as_the_reference(case, ticks, horizon):
    """The object path (``use_columnar=False``) on both sides; the
    reference's mirror drains the same nodes."""
    before = port_metrics.robustness_snapshot()["planner_fallback"]
    got, seen = _port_run(case, horizon, ticks, "objects")
    want, ref_seen = _ref_run(case, horizon, ticks, "objects")
    assert got == want
    assert set(seen) == set(ref_seen) == {"NodeMap"}
    assert any(rec["drained"] for rec in got)
    assert not any(rec["planner_fallback"] for rec in got)
    assert port_metrics.robustness_snapshot()["planner_fallback"] == before
    columnar, _ = _ref_run(case, horizon, ticks, "columnar")
    assert [r["drained"] for r in columnar] == [r["drained"] for r in got]


@pytest.mark.parametrize("horizon", [32, 0], ids=["schedules", "horizon0"])
@pytest.mark.parametrize("case, ticks", [("config1", 4), ("config2", 3)])
def test_rescheduler_drains_as_the_reference_on_the_mirror(case, ticks,
                                                           horizon):
    """The default observe path: both controllers plan every tick from
    the columnar mirror (``ColumnarObservation``), with the same drains
    and evicted pod UIDs tick by tick."""
    before = port_metrics.robustness_snapshot()["planner_fallback"]
    got, seen = _port_run(case, horizon, ticks, "columnar")
    want, ref_seen = _ref_run(case, horizon, ticks, "columnar")
    assert got == want
    assert seen and set(seen) == set(ref_seen) == {"ColumnarObservation"}
    assert any(rec["drained"] for rec in got)
    assert not any(rec["planner_fallback"] for rec in got)
    assert port_metrics.robustness_snapshot()["planner_fallback"] == before


@pytest.mark.parametrize("horizon", [32, 0], ids=["schedules", "horizon0"])
def test_rescheduler_drains_as_the_reference_through_the_stub(horizon):
    """Config 1 served by ``testing.StubApiServer``: the port's
    ``start_watch_client``, ``ColumnarFeed`` and controller against the
    reference's through the same kind of server, each tick after the
    mirror caught up with the server's events."""
    name, config_id, ticks, _ = testing.SMALL_KUBE_RUNS[0]
    spec = port_synthetic.CONFIGS[config_id]
    cfg = testing.controller_config(PortConfig, spec, horizon, "columnar")
    planner = TorchSolverPlanner(cfg, device="cpu")
    seen = testing.track_observations(planner)
    clock = FakeClock()
    stub = testing.StubApiServer.from_cluster(
        port_synthetic.generate_cluster(spec, 0))
    try:
        got = testing.run_kube(
            stub, ticks, kube_cls=port_kube.KubeClusterClient,
            start_watching=lambda kc: start_watch_client(kc, cfg, clock),
            clock=clock,
            make_rescheduler=lambda wc: Rescheduler(
                wc, planner, cfg, clock=clock, recorder=wc),
        )
    finally:
        stub.close()
    assert seen and set(seen) == {"ColumnarObservation"}
    want = reference_kube_run(name, config_id, ticks, horizon)["records"]
    assert got == want
    assert any(rec["drained"] for rec in got)
    assert not any(rec["planner_fallback"] for rec in got)


@pytest.mark.parametrize("run", [r[0] for r in (
    *testing.SMALL_RUNS, *testing.SMALL_KUBE_RUNS)])
def test_frozen_small_runs_match_a_fresh_reference_run(run):
    """``data/ticks_seed0.json`` is what the JAX package does now: its
    config 1-2 mirror and stub runs equal a fresh run."""
    frozen = testing.load_ticks()["runs"][run]
    small = {r[0]: r for r in testing.SMALL_RUNS}
    if run in small:
        fresh = reference_run(*small[run])
    else:
        fresh = reference_kube_run(
            *{r[0]: r for r in testing.SMALL_KUBE_RUNS}[run])
    assert fresh == frozen
    assert any(rec["drained"] for rec in frozen["records"])


def test_cli_drains_as_the_reference(caplog):
    caplog.set_level(logging.INFO, logger="spot_rescheduler_tpu")
    argv = [*testing.CLI_ARGS, "--device", "cpu"]
    assert port_main(argv) == 0
    drained = [
        m.group(1)
        for m in (re.search(r"tick \d+: drained=\[(.*?)\]", msg)
                  for msg in caplog.messages)
        if m
    ]
    want = testing.load_ticks()["cli"]["records"]
    assert drained == [
        ", ".join(repr(n) for n in rec["drained"]) for rec in want
    ]
    assert all(rec["drained"] for rec in want)
    total = port_metrics.robustness_snapshot()["planner_fallback"]
    assert f"planner_fallback_total={int(total)}" in caplog.messages


def test_cli_refuses_the_flags_of_later_slices():
    """The flags whose modules are not ported exit 2, and so does an
    unknown chaos profile; the kube source, the watch, the mirror and
    the lease are accepted (the drains through a stub server:
    ``tests/test_torch_kube.py``), and so are the planner service's and
    its agents' (``tests/test_torch_service.py``) and the fault layers'
    (``tests/test_torch_chaos.py``)."""
    for argv in (["--service-chaos-profile", "flaky"],
                 ["--chaos-profile", "flaky"], ["--mesh-shape", "2x2"],
                 ["--auto-shard", "true"], ["--solver-hbm-budget", "1"],
                 ["--carry-chunks", "2"], ["--debug-endpoints", "true"],
                 ["--trace-dir", "/tmp/t"], ["--jax-cache-dir", "/tmp/j"]):
        with pytest.raises(SystemExit) as exc:
            port_main(argv)
        assert exc.value.code == 2, argv
    from k8s_spot_rescheduler_tpu_torch.cli.main import (
        build_parser,
        config_from_args,
    )

    service = config_from_args(build_parser().parse_args([
        "--serve", "127.0.0.1:1", "--planner-url", "x",
        "--planner-urls", "x,y", "--planner-timeout", "1s",
        "--delta-wire-enabled", "true", "--service-batch-window", "1s",
        "--device-sick-threshold", "3",
    ]))
    assert (service.planner_urls, service.planner_timeout,
            service.service_batch_window) == ("x,y", 1.0, 1.0)

    args = build_parser().parse_args([
        "--cluster", "kube:http://127.0.0.1:1", "--watch-cache", "false",
        "--use-columnar", "false", "--running-in-cluster", "false",
        "--kubeconfig", "k", "--kube-retry-max", "2",
        "--kube-retry-base", "0.5", "--watch-progress-deadline", "30s",
        "--mirror-staleness-budget", "2m", "--resync-interval", "0s",
        "--leader-elect", "true", "--leader-elect-namespace", "ns",
        "--leader-elect-identity", "me",
        "--leader-elect-lease-duration", "20s",
    ])
    cfg = config_from_args(args)
    assert (cfg.use_columnar, cfg.running_in_cluster, cfg.kubeconfig,
            cfg.kube_retry_max, cfg.kube_retry_base,
            cfg.watch_progress_deadline, cfg.mirror_staleness_budget,
            cfg.resync_interval) == (False, False, "k", 2, 0.5, 30.0,
                                     120.0, 0.0)
    assert not args.watch_cache and args.leader_elect
    assert PortConfig().use_columnar


def test_drain_schedule_requires_its_planners_device():
    with pytest.raises(TypeError, match="device"):
        DrainSchedule([], None, None, pack_fn=lambda o, p: None,
                      solver_label="torch+schedule", horizon=32)


class _FailingPlanner(TorchSolverPlanner):
    """A planner whose every plan raises ``error``, reporting
    ``device`` as where it runs."""

    def __init__(self, config, device, error):
        super().__init__(config, device="cpu")
        self.device = torch.device(device)
        self.error = error

    def plan_async(self, observation, pdbs):
        raise self.error

    def plan_schedule(self, observation, pdbs):
        raise self.error


def _kernel_refusal():
    """The error a kernel wrapper raises when it refuses its inputs."""
    from k8s_spot_rescheduler_tpu_torch.ops import ffd_kernels

    host = testing.random_pack(np.random.default_rng(0), 2, 2, 3, 2)
    try:
        ffd_kernels.launch_raw(to_device(host, "cpu"), False)
    except ValueError as err:
        return err
    raise AssertionError("launch_raw accepted CPU tensors")


@pytest.mark.parametrize("horizon", [32, 0], ids=["schedules", "horizon0"])
@pytest.mark.parametrize("device, error, contained", [
    ("cuda", "kernel", False),
    ("cuda", "refusal", False),
    ("cuda", "cuda", False),
    ("cuda", "planner", True),
    ("cpu", "kernel", True),
], ids=["cuda-kernel", "cuda-refusal", "cuda-sync", "cuda-planner",
        "cpu-kernel"])
def test_kernel_fault_on_the_card_is_not_contained(device, error, contained,
                                                   horizon):
    """A fault of the card's kernels while the planner runs on a CUDA
    device propagates out of ``tick()``: the tick never moves to the
    host planner. Any other planner error is contained by the numpy
    planner, loudly, and the tick drains as the reference's does."""
    from k8s_spot_rescheduler_tpu_torch.ops import ffd_kernels

    err = {
        "kernel": ffd_kernels.KernelError("ffd kernel launch failed: x"),
        "refusal": _kernel_refusal(),
        "cuda": RuntimeError("CUDA error: an illegal memory access"),
        "planner": ValueError("a bug in the planner"),
    }[error]
    _, client, spec = _clusters("config1")
    cfg = testing.controller_config(PortConfig, spec, horizon, "columnar")
    r = Rescheduler(client, _FailingPlanner(cfg, device, err), cfg,
                    clock=client.clock, recorder=client)
    before = port_metrics.robustness_snapshot()["planner_fallback"]
    if not contained:
        with pytest.raises(type(err)) as exc:
            testing.run_ticks(r, client, 1)
        assert exc.value is err
        assert port_metrics.robustness_snapshot()["planner_fallback"] == before
        assert not client.evictions
        return
    got = testing.run_ticks(r, client, 1)
    assert got[0]["planner_fallback"] and got[0]["drained"]
    assert port_metrics.robustness_snapshot()["planner_fallback"] > before
    assert [rec["drained"] for rec in got] == [
        rec["drained"] for rec in _ref_run("config1", horizon, 1, "columnar")[0]
    ]


def test_metrics_store_and_its_exposition(monkeypatch):
    """The port's metrics live in process; ``serve`` needs
    ``prometheus_client`` only when called, and the exposition carries
    the reference's names and labels."""
    before = port_metrics.node_drain_count.value("Success", "od-x")
    port_metrics.update_node_drain_count("Success", "od-x")
    port_metrics.observe_tick_phase("observe", 0.02)
    assert port_metrics.node_drain_count.value("Success", "od-x") == before + 1
    prometheus_client = pytest.importorskip("prometheus_client")
    registry = prometheus_client.CollectorRegistry()
    registry.register(port_metrics._StoreCollector())
    text = prometheus_client.generate_latest(registry).decode()
    assert ('spot_rescheduler_node_drain_total{drain_state="Success",'
            'node="od-x"}') in text
    assert ('spot_rescheduler_tick_phase_duration_seconds_bucket{'
            'le="0.05",phase="observe"}') in text
    monkeypatch.setitem(__import__("sys").modules, "prometheus_client", None)
    with pytest.raises(ImportError):
        port_metrics.serve("localhost:0")

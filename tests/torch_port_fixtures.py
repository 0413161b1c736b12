"""Freeze full-size problems and the JAX package's answers for the port.

The PyTorch port (``k8s_spot_rescheduler_tpu_torch``) may not import the
JAX package, yet its chip smoke must run at the north-star shape and be
held against the reference. This script bridges the two once, on the
CPU: it packs ``io/synthetic.CONFIGS[n]`` (or ``CONTENDED``, below) at a
seed along the route ``bench.build_problem`` takes (generate -> columnar
mirror -> pack) and stores, beside the pack, what the JAX package
answers for it:

- ``selection``: ``make_fused_planner(with_repair(plan_ffd, 8))``, the
  unstaged selection vector ``[idx, found, n_feasible, row...]``;
- ``staged_selection``: ``StagedPlanner`` over the same union with the
  default ``chunk_lanes=256`` and early exit (what ``plan_async`` returns);
- ``schedule``: ``make_schedule_planner(..., 32)``, the ``[32, 3+K]``
  drain-schedule matrix;
- for ``CONTENDED`` also the lane-level answers of the union
  (``union_feasible``/``union_assignment``), of ``plan_repair`` alone
  (``repair_feasible``/``repair_assignment``), of the carry-streamed
  union ``with_repair_streamed(8, 4, carry_layout(pack))``
  (``stream_union_*``) and of ``plan_repair_chunked(rounds=8,
  spot_chunks=4, layout=carry_layout(pack))`` (``repair_chunked_*``).

Configs 3 and 4 are uncontended: first-fit proves every valid lane, so
repair never runs on them. ``CONTENDED`` is the quality suite's
anti-affinity pools (``io/synthetic.AffinitySpec``: swap, depth-2
interlock and depth-3 chain pools) widened to 512 pools, 512 on-demand
and about 1,100 spot nodes: greedy proves 154 of its 512 lanes and
repair 307 more, so the chip smoke checks repair on the card with it.

The ``ticks`` target runs the JAX package's controller instead: each
run of ``k8s_spot_rescheduler_tpu_torch/testing.CONTROLLER_RUNS``
(configs 3 and 4 at seed 0, schedules on and off, a 1 s drain delay,
through the object path and through the columnar mirror) and of
``testing.SMALL_RUNS`` (configs 1 and 2 on the mirror, which tier-1
re-runs to check the file); each run of ``testing.KUBE_RUNS`` and
``testing.SMALL_KUBE_RUNS`` through a ``testing.StubApiServer`` serving
the config, a watch client and its mirror; the CLI run of
``testing.CLI_ARGS``; and ``python -m k8s_spot_rescheduler_tpu
--cluster kube:<stub URL>`` with ``testing.KUBE_CLI_ARGS`` as a
subprocess. It writes each run's cluster digest and per-tick drains,
evicted pod UIDs and skip reasons to ``data/ticks_seed0.json``.

The ``service`` target runs the JAX package's planner service on the
fleet of ``testing.SERVICE_TENANTS`` (configs 3 and 4 at seeds 0-3) and
writes ``data/service_seed0.json`` (``reference_service``): digests,
pack fingerprints and rows, not packs, which the chip smoke rebuilds
from the seeds. It solves one tenant a batch to bound this CPU's memory
and takes about an hour.

The ``chaos`` target runs the JAX package under its fault layer
(``io/chaos``) and writes ``data/chaos_seed0.json`` (``freeze_chaos``):
the controller through a ``ChaosClusterClient`` under the ``heavy``
profile, the mid-drain crash and its restart, the CLI with
``testing.CHAOS_CLI_ARGS`` (a subprocess), and the controller on the
polling kube client through a stub (``testing.POLL_RUNS``).

Run from the repo root:

    JAX_PLATFORMS=cpu python -m tests.torch_port_fixtures 3 4 contended ticks
    JAX_PLATFORMS=cpu python -m tests.torch_port_fixtures service
    JAX_PLATFORMS=cpu python -m tests.torch_port_fixtures chaos

It writes ``k8s_spot_rescheduler_tpu_torch/data/<name>_seed<seed>.npz``
(``config3``, ``config4``, ``contended``). The port's tests check that
each frozen pack still equals a fresh one.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from k8s_spot_rescheduler_tpu_torch import testing
from k8s_spot_rescheduler_tpu_torch.models.tensors import save_npz

HORIZON = 32
DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "k8s_spot_rescheduler_tpu_torch",
    "data",
)


CONTENDED = "contended"


def contended_spec():
    """The contended problem: 512 anti-affinity quality pools."""
    from k8s_spot_rescheduler_tpu.io.synthetic import AffinitySpec

    return AffinitySpec(
        "quality-affinity-512g",
        n_groups=512,
        aswap_frac=0.4,
        interlock_frac=0.2,
        chain3_frac=0.1,
    )


def frozen_path(config_id, seed: int = 0) -> str:
    name = CONTENDED if config_id == CONTENDED else f"config{config_id}"
    return os.path.join(DATA_DIR, f"{name}_seed{seed}.npz")


def pack_config(config_id, seed: int = 0):
    """The numpy PackedCluster of synthetic config ``config_id`` (or
    ``CONTENDED``) at ``seed``, packed as ``bench.build_problem`` packs
    it."""
    from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS

    if config_id == CONTENDED:
        return pack_spec(contended_spec(), seed)
    return pack_spec(CONFIGS[config_id], seed)


def pack_spec(spec, seed: int = 0):
    """The numpy PackedCluster of a synthetic or quality spec at
    ``seed``: generate, attach the columnar mirror, pack."""
    from k8s_spot_rescheduler_tpu.io.synthetic import generate_quality_cluster
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig

    cfg = ReschedulerConfig(resources=spec.resources)
    client = generate_quality_cluster(spec, seed)
    store = client.columnar_store(
        cfg.resources,
        on_demand_label=cfg.on_demand_node_label,
        spot_label=cfg.spot_node_label,
    )
    packed, _ = store.pack(
        client.list_pdbs(), priority_threshold=cfg.priority_threshold
    )
    return packed


def jax_answers(packed, horizon: int = HORIZON) -> dict:
    """The JAX package's selection, staged selection and schedule for
    ``packed`` (the default union: first-fit, best-fit, 8 repair
    rounds)."""
    from k8s_spot_rescheduler_tpu.solver.fallback import with_repair
    from k8s_spot_rescheduler_tpu.solver.ffd import plan_ffd
    from k8s_spot_rescheduler_tpu.solver.schedule import make_schedule_planner
    from k8s_spot_rescheduler_tpu.solver.select import (
        StagedPlanner,
        make_fused_planner,
    )

    union = with_repair(plan_ffd, 8)
    selection = np.asarray(make_fused_planner(union)(packed), np.int32)
    sel, _ = StagedPlanner(union, chunk_lanes=256, early_exit=True).solve(
        packed
    )
    staged = np.concatenate(
        [
            np.array([sel.index, int(sel.found), sel.n_feasible], np.int32),
            np.asarray(sel.row, np.int32),
        ]
    )
    schedule = np.asarray(
        make_schedule_planner(union, horizon)(packed), np.int32
    )
    return {
        "selection": selection,
        "staged_selection": staged,
        "schedule": schedule,
    }


def jax_lane_answers(packed) -> dict:
    """The JAX package's per-lane union and repair results for
    ``packed``: feasible bool [C] and assignment int32 [C, K] of each."""
    from k8s_spot_rescheduler_tpu.solver.fallback import with_repair
    from k8s_spot_rescheduler_tpu.solver.ffd import plan_ffd
    from k8s_spot_rescheduler_tpu.solver.repair import plan_repair_jit

    union = with_repair(plan_ffd, 8)(packed)
    repair = plan_repair_jit(packed, rounds=8)
    return {
        "union_feasible": np.asarray(union.feasible, bool),
        "union_assignment": np.asarray(union.assignment, np.int32),
        "repair_feasible": np.asarray(repair.feasible, bool),
        "repair_assignment": np.asarray(repair.assignment, np.int32),
    }


STREAM_CHUNKS = 4


def jax_stream_lane_answers(packed) -> dict:
    """The JAX package's per-lane answers of the carry-streamed union and
    of the spot-chunked repair at ``STREAM_CHUNKS`` chunks and the
    pack's guarded layout."""
    import jax

    from k8s_spot_rescheduler_tpu.solver.carry import carry_layout
    from k8s_spot_rescheduler_tpu.solver.fallback import with_repair_streamed
    from k8s_spot_rescheduler_tpu.solver.repair import plan_repair_chunked_jit

    layout = carry_layout(packed)
    union = jax.jit(with_repair_streamed(8, STREAM_CHUNKS, layout))(packed)
    repair = plan_repair_chunked_jit(
        packed, rounds=8, spot_chunks=STREAM_CHUNKS, layout=layout
    )
    return {
        "stream_union_feasible": np.asarray(union.feasible, bool),
        "stream_union_assignment": np.asarray(union.assignment, np.int32),
        "repair_chunked_feasible": np.asarray(repair.feasible, bool),
        "repair_chunked_assignment": np.asarray(repair.assignment, np.int32),
    }


def freeze(config_id, seed: int = 0) -> str:
    packed = pack_config(config_id, seed)
    answers = jax_answers(packed)
    if config_id == CONTENDED:
        answers.update(jax_lane_answers(packed))
        answers.update(jax_stream_lane_answers(packed))
    os.makedirs(DATA_DIR, exist_ok=True)
    path = frozen_path(config_id, seed)
    save_npz(
        path,
        packed,
        config_id=np.asarray(config_id),
        seed=np.int32(seed),
        **answers,
    )
    return path


def reference_run(name: str, config_id: int, ticks: int, horizon: int,
                  observe: str, seed: int = 0) -> dict:
    """One controller run of the JAX package (``testing.CONTROLLER_RUNS``)
    on the CPU: the generated cluster's digest and the per-tick
    records; the planner must have packed from the observe path named."""
    from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS, generate_cluster
    from k8s_spot_rescheduler_tpu.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig

    spec = CONFIGS[config_id]
    client = generate_cluster(spec, seed, reschedule_evicted=True)
    digest = testing.cluster_digest(client)
    cfg = testing.controller_config(ReschedulerConfig, spec, horizon, observe)
    planner = SolverPlanner(cfg)
    seen = testing.track_observations(planner)
    r = Rescheduler(client, planner, cfg, clock=client.clock,
                    recorder=client)
    records = testing.run_ticks(r, client, ticks)
    want = "ColumnarObservation" if observe == "columnar" else "NodeMap"
    assert seen and set(seen) == {want}, (name, set(seen))
    return {
        "config": config_id,
        "ticks": ticks,
        "schedule_horizon": horizon,
        "observe": observe,
        "digest": digest,
        "records": records,
    }


def reference_kube_run(name: str, config_id: int, ticks: int, horizon: int,
                       seed: int = 0) -> dict:
    """One controller run of the JAX package through a
    ``testing.StubApiServer`` serving the config (``testing.KUBE_RUNS``):
    the CLI's ``start_watch_client``, its columnar mirror, a virtual
    clock."""
    from k8s_spot_rescheduler_tpu.cli.main import start_watch_client
    from k8s_spot_rescheduler_tpu.io.kube import KubeClusterClient
    from k8s_spot_rescheduler_tpu.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner
    from k8s_spot_rescheduler_tpu.utils.clock import FakeClock
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
        CONFIGS,
        generate_cluster,
    )

    spec = CONFIGS[config_id]
    client = generate_cluster(spec, seed)
    cfg = testing.controller_config(ReschedulerConfig, spec, horizon,
                                    "columnar")
    planner = SolverPlanner(cfg)
    seen = testing.track_observations(planner)
    clock = FakeClock()
    stub = testing.StubApiServer.from_cluster(client)
    try:
        records = testing.run_kube(
            stub, ticks, kube_cls=KubeClusterClient,
            start_watching=lambda kc: start_watch_client(kc, cfg, clock),
            clock=clock,
            make_rescheduler=lambda wc: Rescheduler(
                wc, planner, cfg, clock=clock, recorder=wc),
        )
    finally:
        stub.close()
    assert seen and set(seen) == {"ColumnarObservation"}, (name, set(seen))
    return {
        "config": config_id,
        "ticks": ticks,
        "schedule_horizon": horizon,
        "observe": "kube",
        "digest": testing.cluster_digest(client),
        "records": records,
    }


def reference_kube_cli_run(seed: int = 0) -> dict:
    """``python -m k8s_spot_rescheduler_tpu --cluster kube:<URL>`` with
    ``testing.KUBE_CLI_ARGS`` as a subprocess against a stub serving
    ``testing.KUBE_CLI_CONFIG``: the drains its log reports per tick and
    the pod UIDs the stub saw evicted."""
    import ast
    import re
    import subprocess

    from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
        CONFIGS,
        generate_cluster,
    )

    client = generate_cluster(CONFIGS[testing.KUBE_CLI_CONFIG], seed)
    stub = testing.StubApiServer.from_cluster(client)
    root = os.path.dirname(os.path.dirname(DATA_DIR))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "k8s_spot_rescheduler_tpu",
             "--cluster", f"kube:{stub.url}", *testing.KUBE_CLI_ARGS],
            cwd=root, env=dict(os.environ, PYTHONPATH=root,
                               JAX_PLATFORMS="cpu"),
            capture_output=True, text=True, timeout=600,
        )
    finally:
        stub.close()
    assert proc.returncode == 0, proc.stderr[-2000:]
    drained = [ast.literal_eval(m) for m in re.findall(r"tick \d+: drained=(\[.*?\])",
                                           proc.stderr)]
    return {
        "config": testing.KUBE_CLI_CONFIG,
        "args": list(testing.KUBE_CLI_ARGS),
        "digest": testing.cluster_digest(client),
        "drained": drained,
        "evicted": sorted(stub.evictions),
    }


def reference_cli_run(seed: int = 0) -> dict:
    """What the JAX package's CLI does with ``testing.CLI_ARGS``, in
    process: the same parser, cluster, planner and tick loop."""
    from k8s_spot_rescheduler_tpu.cli.main import build_parser, config_from_args
    from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS, generate_cluster
    from k8s_spot_rescheduler_tpu.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner

    args = build_parser().parse_args(list(testing.CLI_ARGS))
    cfg = config_from_args(args)
    client = generate_cluster(CONFIGS[1], seed, reschedule_evicted=True)
    r = Rescheduler(client, SolverPlanner(cfg), cfg, clock=client.clock,
                    recorder=client)
    return {
        "args": list(testing.CLI_ARGS),
        "digest": testing.cluster_digest(client),
        "records": testing.run_ticks(r, client, args.ticks),
    }


def freeze_ticks(seed: int = 0) -> str:
    """Write ``testing.TICKS_PATH``: every controller run of
    ``testing.CONTROLLER_RUNS`` and the CLI run, as the JAX package
    does them."""
    runs = {
        name: reference_run(name, config_id, ticks, horizon, observe, seed)
        for name, config_id, ticks, horizon, observe in (
            *testing.CONTROLLER_RUNS, *testing.SMALL_RUNS)
    }
    runs.update(
        (name, reference_kube_run(name, config_id, ticks, horizon, seed))
        for name, config_id, ticks, horizon in (
            *testing.KUBE_RUNS, *testing.SMALL_KUBE_RUNS)
    )
    out = {
        "seed": seed,
        "runs": runs,
        "cli": reference_cli_run(seed),
        "kube_cli": reference_kube_cli_run(seed),
    }
    with open(testing.TICKS_PATH, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    return testing.TICKS_PATH


def reference_chaos_run(config_id: int, ticks: int, horizon: int,
                        seed: int = 0, profile: str = "heavy") -> dict:
    """The JAX package's controller through a ``ChaosClusterClient``
    under ``FaultPlan.profile(profile, seed)`` over a fresh
    ``generate_cluster(CONFIGS[config_id], seed,
    reschedule_evicted=True)``: per tick the drain, evicted pod UIDs,
    skip reason and robustness counter deltas (``testing.chaos_ticks``),
    and the faults injected in all (``ChaosClusterClient.stats``). Chaos
    refuses the mirror, so every plan comes from the object path."""
    from k8s_spot_rescheduler_tpu.io.chaos import ChaosClusterClient, FaultPlan
    from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS, generate_cluster
    from k8s_spot_rescheduler_tpu.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu.metrics import registry as metrics
    from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig

    spec = CONFIGS[config_id]
    client = generate_cluster(spec, seed, reschedule_evicted=True)
    digest = testing.cluster_digest(client)
    cfg = testing.controller_config(ReschedulerConfig, spec, horizon,
                                    "columnar")
    planner = SolverPlanner(cfg)
    seen = testing.track_observations(planner)
    chaos = ChaosClusterClient(client, FaultPlan.profile(profile, seed),
                               clock=client.clock)
    r = Rescheduler(chaos, planner, cfg, clock=client.clock, recorder=chaos)
    records = testing.chaos_ticks(r, chaos, ticks,
                                  metrics.robustness_snapshot)
    assert set(seen) <= {"NodeMap"}, set(seen)
    return {
        "config": config_id,
        "ticks": ticks,
        "schedule_horizon": horizon,
        "profile": profile,
        "digest": digest,
        "records": records,
        "stats": dict(sorted(chaos.stats.items())),
    }


def reference_crash_run(config_id: int, ticks: int, horizon: int,
                        seed: int = 0) -> dict:
    """The JAX package's mid-drain crash (``testing.crash_run``) on a
    fresh ``generate_cluster(CONFIGS[config_id], seed,
    reschedule_evicted=True)``: ``FaultPlan(interrupt_on_taint=1)``,
    then a restarted controller with a fresh planner."""
    from k8s_spot_rescheduler_tpu.io.chaos import ChaosClusterClient, FaultPlan
    from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS, generate_cluster
    from k8s_spot_rescheduler_tpu.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu.metrics import registry as metrics
    from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig

    spec = CONFIGS[config_id]
    client = generate_cluster(spec, seed, reschedule_evicted=True)
    digest = testing.cluster_digest(client)
    cfg = testing.controller_config(ReschedulerConfig, spec, horizon,
                                    "columnar")
    chaos = ChaosClusterClient(
        client, FaultPlan(seed=seed, interrupt_on_taint=1), clock=client.clock)
    out = testing.crash_run(
        client, chaos,
        lambda c: Rescheduler(c, SolverPlanner(cfg), cfg, clock=client.clock,
                              recorder=c),
        ticks, metrics.robustness_snapshot,
    )
    return {"config": config_id, "schedule_horizon": horizon,
            "digest": digest, **out}


def reference_chaos_cli_run() -> dict:
    """``python -m k8s_spot_rescheduler_tpu`` with
    ``testing.CHAOS_CLI_ARGS`` as a subprocess: each tick's log line
    (``tick N: drained=[...] failed=[...]`` or ``tick N: skipped
    (...)``)."""
    import re
    import subprocess

    root = os.path.dirname(os.path.dirname(DATA_DIR))
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_spot_rescheduler_tpu",
         *testing.CHAOS_CLI_ARGS],
        cwd=root, env=dict(os.environ, PYTHONPATH=root, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return {
        "args": list(testing.CHAOS_CLI_ARGS),
        "ticks": re.findall(r"(tick \d+: .*)$", proc.stderr, re.M),
    }


def reference_poll_run(name: str, config_id: int, ticks: int, horizon: int,
                       seed: int = 0) -> dict:
    """The JAX package's controller on its polling ``KubeClusterClient``
    (no watch cache) through a ``testing.StubApiServer`` serving
    ``generate_cluster(CONFIGS[config_id], seed)``, on a virtual clock
    (``testing.run_kube_ticks`` without a tracker): every tick LISTs
    the stub and plans from the object path."""
    from k8s_spot_rescheduler_tpu.io.kube import KubeClusterClient
    from k8s_spot_rescheduler_tpu.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner
    from k8s_spot_rescheduler_tpu.utils.clock import FakeClock
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
        CONFIGS,
        generate_cluster,
    )

    spec = CONFIGS[config_id]
    client = generate_cluster(spec, seed)
    cfg = testing.controller_config(ReschedulerConfig, spec, horizon,
                                    "columnar")
    planner = SolverPlanner(cfg)
    seen = testing.track_observations(planner)
    clock = FakeClock()
    stub = testing.StubApiServer.from_cluster(client)
    try:
        kube = KubeClusterClient(stub.url)
        records = testing.run_kube_ticks(
            Rescheduler(kube, planner, cfg, clock=clock, recorder=kube),
            stub, None, clock, ticks)
    finally:
        stub.close()
    assert seen and set(seen) == {"NodeMap"}, (name, set(seen))
    return {
        "config": config_id,
        "ticks": ticks,
        "schedule_horizon": horizon,
        "observe": "kube-poll",
        "digest": testing.cluster_digest(client),
        "records": records,
    }


def freeze_chaos(seed: int = 0) -> str:
    """Write ``testing.CHAOS_PATH``: the fault layers' runs of the JAX
    package (``testing.CHAOS_RUNS``, the crash on ``CRASH_CONFIG``, the
    CLI with ``CHAOS_CLI_ARGS`` and ``POLL_RUNS``)."""
    out = {
        "seed": seed,
        "runs": {
            name: reference_chaos_run(config_id, ticks,
                                      testing.CHAOS_HORIZON, seed)
            for name, config_id, ticks in testing.CHAOS_RUNS
        },
        "crash": reference_crash_run(testing.CRASH_CONFIG,
                                     testing.CRASH_TICKS,
                                     testing.CHAOS_HORIZON, seed),
        "cli": reference_chaos_cli_run(),
        "poll": {
            name: reference_poll_run(name, config_id, ticks, horizon, seed)
            for name, config_id, ticks, horizon in testing.POLL_RUNS
        },
    }
    with open(testing.CHAOS_PATH, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    return testing.CHAOS_PATH


def reference_service(seed: int = 0) -> str:
    """Write ``testing.SERVICE_PATH``: the JAX package's planner service
    on the fleet of ``testing.SERVICE_TENANTS``. For each tenant, its
    fresh cluster's digest, the fingerprint of the pack its agent sends
    first (``testing.agent_pack``), the ``[3+K]`` row a single-plan
    batch answers (``PlannerService``, one tenant a batch: batched rows
    equal solo ones, so the cap only bounds this CPU's memory), the solo
    selection of the same pack (``make_fused_planner``), the
    ``[SERVICE_HORIZON, 3+K]`` schedule a schedule request answers, and
    ``SERVICE_TICKS`` controller ticks of a ``RemotePlanner`` agent
    through a ``ServiceServer`` on 127.0.0.1 (drains, evicted pod UIDs,
    skips), with no agent falling back."""
    from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS, generate_cluster
    from k8s_spot_rescheduler_tpu.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu.metrics import registry as metrics
    from k8s_spot_rescheduler_tpu.models.columnar import pack_fingerprint
    from k8s_spot_rescheduler_tpu.service.agent import RemotePlanner
    from k8s_spot_rescheduler_tpu.service.server import (
        PlannerService,
        ServiceServer,
    )
    from k8s_spot_rescheduler_tpu.solver.fallback import union_program
    from k8s_spot_rescheduler_tpu.solver.select import make_fused_planner
    from k8s_spot_rescheduler_tpu.utils.clock import FakeClock
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig

    fused = make_fused_planner(union_program(8, True))
    tenants = []
    server = None
    for name, config_id, tenant_seed in testing.SERVICE_TENANTS:
        spec = CONFIGS[config_id]
        if server is None:
            server = ServiceServer(
                testing.service_config(ReschedulerConfig, spec),
                "127.0.0.1:0", max_batch_tenants=1,
            )
            server.start_background()
        cfg = testing.service_config(
            ReschedulerConfig, spec,
            planner_url=f"http://{server.address}", planner_timeout=900.0,
        )
        client = generate_cluster(spec, tenant_seed, reschedule_evicted=True)
        digest = testing.cluster_digest(client)
        agent = RemotePlanner(cfg, tenant=name)
        packed = testing.agent_pack(agent, generate_cluster(spec, tenant_seed))
        svc = PlannerService(cfg, clock=FakeClock(), batch_window_s=0,
                             max_batch_tenants=1)
        plan = svc.submit_nowait(name, packed)
        sched = svc.submit_nowait(name, packed,
                                  schedule_horizon=testing.SERVICE_HORIZON)
        while svc.drain_once():
            pass
        reply = plan.reply
        row = [reply.index, int(reply.found), reply.n_feasible,
               *np.asarray(reply.row).tolist()]
        solo = np.asarray(fused(packed)).tolist()
        assert row == solo, (name, row[:3], solo[:3])
        fallback = metrics.service_snapshot()["remote_planner_fallback"]
        r = Rescheduler(client, agent, cfg, clock=client.clock,
                        recorder=client)
        records = testing.run_ticks(r, client, testing.SERVICE_TICKS)
        assert metrics.service_snapshot()["remote_planner_fallback"] == fallback
        tenants.append({
            "name": name,
            "config": config_id,
            "seed": tenant_seed,
            "digest": digest,
            "pack_fingerprint": pack_fingerprint(packed),
            "row": row,
            "solo": solo,
            "schedule": np.asarray(sched.reply.steps).tolist(),
            "records": records,
        })
        print(f"{name}: row {row[:3]}, "
              f"{sum(s[1] == 1 for s in tenants[-1]['schedule'])} schedule "
              f"steps, drained {[t['drained'] for t in records]}",
              file=sys.stderr)
    server.close()
    out = {
        "seed": seed,
        "horizon": testing.SERVICE_HORIZON,
        "ticks": testing.SERVICE_TICKS,
        "tenants": tenants,
    }
    with open(testing.SERVICE_PATH, "w") as f:
        json.dump(out, f)
        f.write("\n")
    return testing.SERVICE_PATH


def main(argv) -> int:
    for arg in argv or ["3"]:
        if arg == "ticks":
            path = freeze_ticks()
        elif arg == "service":
            path = reference_service()
        elif arg == "chaos":
            path = freeze_chaos()
        else:
            path = freeze(arg if arg == CONTENDED else int(arg))
        print(f"{path}: {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

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

The ``bench`` target runs the JAX package's bench rows and writes
``data/bench_seed0.json`` (``freeze_bench``): the quality and boundary
configs drained to exhaustion (ILP, drains, evicted pod UIDs; the
numpy solver checked equal), the config-5 and constrained replays'
counts, the chain-depth counters and ``--quality-scale`` at config 3;
and the root ``bench.py``'s single-device modes: the tick
``--replay-device-only`` harvests at 300 events (written by the
reference's own harvest to ``data/replay_harvest_seed0.npz``) with the
reference union's selection on it, ``--carry-wall`` on config 3 at 4
chunks and at the ladder's count, ``--smoke``'s ticks and
``--pallas-smoke``'s parity row, and ``--chaos`` and ``--watch-soak`` at
300 ticks; and its service-side modes: ``serve_smoke``'s counts, wire
bytes and solo selections, ``sched_smoke``'s stats and schedule cut,
``fleet_chaos_smoke``'s counts and flight deltas, and
``fleet_twin.induce_shed_edges``'s per-reason deltas (no wall time);
and the latency mode's memory guard: the root ``bench.py``'s
``_run_latency`` under the forced budgets of ``testing.
BENCH_GUARD_CASES`` (``freeze_bench_guard``: the keys that name the
program it ran, and its selection; run alone, as it forces
``testing.SHARDED_DEVICES`` virtual JAX devices);
its parts (``bench:quality``, ``bench:replay``, ``bench:chain``,
``bench:scale``, ``bench:harvest``, ``bench:carry``, ``bench:smoke``,
``bench:soak``, ``bench:serve``, ``bench:sched``, ``bench:fleet``,
``bench:edges``, ``bench:guard``) may run in parallel processes.

Run from the repo root:

    JAX_PLATFORMS=cpu python -m tests.torch_port_fixtures 3 4 contended ticks
    JAX_PLATFORMS=cpu python -m tests.torch_port_fixtures service
    JAX_PLATFORMS=cpu python -m tests.torch_port_fixtures chaos
    JAX_PLATFORMS=cpu python -m tests.torch_port_fixtures bench

It writes ``k8s_spot_rescheduler_tpu_torch/data/<name>_seed<seed>.npz``
(``config3``, ``config4``, ``contended``). The port's tests check that
each frozen pack still equals a fresh one.
"""

from __future__ import annotations

import argparse
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


def _counts(stats: dict) -> dict:
    """A replay's stats without its times (``replan_ms_*``)."""
    return {k: v for k, v in stats.items() if not k.startswith("replan_ms")}


def reference_quality(spec, seed: int, solver: str = "jax") -> dict:
    """One quality config as ``bench.py --quality`` runs it: the ILP of
    its fresh pack, then the ``ffd`` and ``shipped`` variants each
    drained to exhaustion from a fresh cluster, with that client's
    evicted pod UIDs."""
    from k8s_spot_rescheduler_tpu.bench.quality import (
        drain_to_exhaustion,
        ilp_max_drains,
        pack_quality,
    )
    from k8s_spot_rescheduler_tpu.io.synthetic import generate_quality_cluster
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig

    row = {"ilp": ilp_max_drains(pack_quality(spec, seed))}
    for variant, knobs in (
        ("ffd", dict(fallback_best_fit=False, repair_rounds=0)),
        ("shipped", {}),
    ):
        client = generate_quality_cluster(spec, seed, reschedule_evicted=True)
        row[variant] = drain_to_exhaustion(client, ReschedulerConfig(
            solver=solver, resources=spec.resources, **knobs))
        row[f"{variant}_evictions"] = list(client.evictions)
    return row


def freeze_bench_quality(seed: int) -> dict:
    """Every ``QUALITY_CONFIGS`` and ``BOUNDARY_CONFIGS`` entry on the
    JAX package's default solver, each checked against the numpy solver
    (the JAX bench's own rows plan on it): same drains, same evictions."""
    from k8s_spot_rescheduler_tpu.io.synthetic import (
        BOUNDARY_CONFIGS,
        QUALITY_CONFIGS,
    )

    out = {}
    for group, configs in (("quality", QUALITY_CONFIGS),
                           ("boundary", BOUNDARY_CONFIGS)):
        out[group] = {}
        for name, spec in configs.items():
            row = reference_quality(spec, seed)
            oracle = reference_quality(spec, seed, solver="numpy")
            assert oracle == row, (name, oracle, row)
            out[group][name] = row
            print(f"{group} {name}: ILP {row['ilp']} ffd {row['ffd']} "
                  f"shipped {row['shipped']} (numpy the same)",
                  file=sys.stderr)
    return out


def freeze_bench_replay(seed: int) -> dict:
    """The config-5 replay and the constrained one, as ``bench.py
    --config 5 [--constrained]`` runs them: their count fields."""
    from k8s_spot_rescheduler_tpu.bench.replay import run_replay
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig

    out = {}
    for name, events, constrained in (
        ("replay", testing.BENCH_REPLAY_EVENTS, False),
        ("constrained", testing.BENCH_CONSTRAINED_EVENTS, True),
    ):
        stats = run_replay(ReschedulerConfig(), n_events=events, seed=seed,
                           constrained=constrained)
        out[name] = {"events": events, "stats": _counts(stats)}
        print(f"{name}: {stats}", file=sys.stderr)
    return out


def _classify(packed) -> dict:
    from k8s_spot_rescheduler_tpu.bench.chain_depth import classify_packed

    return dict(classify_packed(packed))


def _analyze_config(group: str, name: str, seed: int) -> dict:
    from k8s_spot_rescheduler_tpu.bench.chain_depth import analyze_quality_runs
    from k8s_spot_rescheduler_tpu.io import synthetic

    configs = getattr(synthetic, group)
    counts = analyze_quality_runs(seeds=[seed], configs={name: configs[name]})
    return dict(counts[name])


def freeze_bench_chain(seed: int, workers: int = 7) -> dict:
    """The chain-depth counters as ``bench.py --chain-depth`` gathers
    them: the organic quality configs, the constrained replay and the
    chain3 control (the JAX analyzer plans on numpy). The same sums as
    ``analyze_quality_runs`` and ``analyze_replay``, spread over
    ``workers`` processes: each config's run is one task, and the
    constrained replay runs here with a tap that keeps each tick's
    problem (the analyzer's own id-deduplication) and classifies them
    in the workers (``classify_packed`` is a function of the problem
    alone, and the counts add up in any order). Hours in one process:
    the per-lane ILP takes about a second on each of the ~8,000 lanes
    the repair search leaves unproven."""
    import concurrent.futures
    import multiprocessing
    from collections import Counter

    from k8s_spot_rescheduler_tpu.bench.replay import run_replay
    from k8s_spot_rescheduler_tpu.io.synthetic import (
        BOUNDARY_CONFIGS,
        QUALITY_CONFIGS,
    )
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig

    packs, last = [], [None]

    def tap(packed):
        if packed is None or id(packed) == last[0]:
            return
        last[0] = id(packed)
        packs.append(packed)

    with concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        runs = {
            (group, name): pool.submit(_analyze_config, group, name, seed)
            for group, configs in (("QUALITY_CONFIGS", QUALITY_CONFIGS),
                                   ("BOUNDARY_CONFIGS", BOUNDARY_CONFIGS))
            for name in configs
        }
        run_replay(ReschedulerConfig(solver="numpy"),
                   n_events=testing.BENCH_CONSTRAINED_EVENTS, seed=seed,
                   constrained=True, on_packed=tap)
        print(f"constrained replay: {len(packs)} problems to classify",
              file=sys.stderr, flush=True)
        replay = Counter()
        for counts in pool.map(_classify, packs, chunksize=4):
            replay.update(counts)
        organic = {name: runs[("QUALITY_CONFIGS", name)].result()
                   for name in QUALITY_CONFIGS}
        control = {name: runs[("BOUNDARY_CONFIGS", name)].result()
                   for name in BOUNDARY_CONFIGS}
    organic["constrained-replay"] = dict(replay)
    print(f"chain depth: {organic} control {control}", file=sys.stderr)
    return {"organic": organic, "control": control}


def freeze_bench_scale(seed: int) -> dict:
    """``bench.py --quality-scale --config BENCH_SCALE_CONFIG --scale
    BENCH_SCALE`` on the JAX solver: the LP bound of the fresh pack, and
    the controller draining to exhaustion with 256 drains a tick and
    32-step schedules."""
    from k8s_spot_rescheduler_tpu.bench.quality import (
        drain_to_exhaustion,
        lp_upper_bound,
    )
    from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS, generate_cluster
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import (
        evictions_digest,
        scaled_spec,
    )

    scale = testing.BENCH_SCALE
    spec = scaled_spec(CONFIGS[testing.BENCH_SCALE_CONFIG], scale)
    bound = lp_upper_bound(pack_spec(spec, seed))
    cfg = ReschedulerConfig(
        resources=spec.resources, max_drains_per_tick=256,
        plan_schedule_enabled=True, schedule_horizon=HORIZON,
    )
    client = generate_cluster(spec, seed, reschedule_evicted=True)
    stats: dict = {}
    achieved = drain_to_exhaustion(client, cfg, max_ticks=200,
                                   planner_stats=stats)
    out = {
        "config": testing.BENCH_SCALE_CONFIG,
        "scale": scale,
        "bound": bound,
        "achieved": achieved,
        "fetches_total": int(stats["fetches_total"]),
        "schedule_lens": [int(n) for n in stats["schedule_lens"]],
        "evictions": len(client.evictions),
        "evictions_sha256": evictions_digest(client.evictions),
    }
    print(f"quality-scale: {out}", file=sys.stderr)
    return out


def _root_bench():
    """The repo's root ``bench.py`` as a module."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import bench

    return bench


def _root_row(fn, *args) -> dict:
    """Run a root ``bench.py`` mode function and return the one JSON row
    it prints (its progress goes to stderr)."""
    import contextlib
    import io

    once = _root_bench()._emit_once  # emit prints one row a process
    if once.locked():
        once.release()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def reference_harvest(n_events: int, seed: int, cache: str) -> tuple:
    """The host half of ``bench.py --replay-device-only --events
    n_events --harvest-cache cache``: the reference's own harvest, which
    writes ``cache`` (a fresh one: an existing file is removed first),
    with its device half replaced by a capture. Returns (harvest, replay
    stats)."""
    root_bench = _root_bench()
    captured = {}

    def capture(args, harvest, stats):
        captured.update(harvest=harvest, stats=stats)
        return 0

    if os.path.exists(cache):
        os.remove(cache)
    saved = root_bench._replay_device_protocol
    root_bench._replay_device_protocol = capture
    try:
        root_bench.run_replay_device_only(argparse.Namespace(
            events=n_events, seed=seed, harvest_cache=cache))
    finally:
        root_bench._replay_device_protocol = saved
    return captured["harvest"], captured["stats"]


def reference_union_selection(packed) -> list:
    """The device half's answer in the reference: the shipped fused
    union ``make_fused_planner(with_repair(plan_ffd, rounds))`` on the
    harvested tick, its selection vector."""
    from k8s_spot_rescheduler_tpu.solver.fallback import with_repair
    from k8s_spot_rescheduler_tpu.solver.ffd import plan_ffd
    from k8s_spot_rescheduler_tpu.solver.select import make_fused_planner
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig

    fused = make_fused_planner(
        with_repair(plan_ffd, ReschedulerConfig().repair_rounds))
    return np.asarray(fused(packed), np.int32).tolist()


def freeze_bench_harvest(seed: int) -> dict:
    """``--replay-device-only`` at ``BENCH_HARVEST_EVENTS`` events: the
    harvested tick, written to ``HARVEST_PATH`` in the reference's cache
    format, and the reference's union selection on it."""
    harvest, stats = reference_harvest(
        testing.BENCH_HARVEST_EVENTS, seed, testing.HARVEST_PATH)
    packed = harvest["packed"]
    selection = reference_union_selection(packed)
    C, K, R = packed.slot_req.shape
    out = {
        "events": testing.BENCH_HARVEST_EVENTS,
        "unproven": int(harvest["unproven"]),
        "bf_only": bool(harvest["bf_only"]),
        "tick_shape": {"C": int(C), "K": int(K),
                       "S": int(packed.spot_free.shape[0]), "R": int(R)},
        "selection": selection,
        "feasible": int(selection[2]),
        "replay_ticks": int(stats["ticks"]),
    }
    print(f"harvest: {out['tick_shape']} unproven {out['unproven']} "
          f"bf_only {out['bf_only']} feasible {out['feasible']}",
          file=sys.stderr)
    return out


CARRY_KEYS = ("carry_chunks", "carry_plane_bytes", "feasible_lanes",
              "valid_lanes")


def reference_carry_wall(config_id: int, scale: float, chunks: int,
                         seed: int) -> dict:
    """``bench.py --carry-wall`` (one repeat; ``chunks`` 0 = the
    ladder's count): its count fields and its bucket key."""
    row = _root_row(_root_bench().run_carry_wall, argparse.Namespace(
        config=config_id, scale=scale, seed=seed, carry_chunks=chunks,
        repeats=1, solver=None), "carry_union_wall_ms", "ms")
    out = {k: row[k] for k in CARRY_KEYS}
    (out["bucket"],) = row["twin_calibration"]
    return out


def freeze_bench_carry(seed: int) -> dict:
    """``--carry-wall --config BENCH_CARRY_CONFIG`` at
    ``BENCH_CARRY_CHUNKS`` chunks and at the ladder's count."""
    out = {"config": testing.BENCH_CARRY_CONFIG, "scale": 1.0}
    for key, chunks in (("pinned", testing.BENCH_CARRY_CHUNKS),
                        ("ladder", 0)):
        out[key] = reference_carry_wall(testing.BENCH_CARRY_CONFIG, 1.0,
                                        chunks, seed)
        print(f"carry-wall {key}: {out[key]}", file=sys.stderr)
    return out


def reference_smoke(seed: int) -> dict:
    """``bench.py --smoke``'s pipeline without its audit subprocesses:
    five incremental ticks of the JAX planner on the smoke cluster, each
    tick's upload bytes (the reference pads a delta to power-of-two
    lengths), delta lanes, repack flag and staged chunks."""
    import dataclasses

    from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS

    root_bench = _root_bench()
    spec = dataclasses.replace(CONFIGS[2], name="bench-smoke",
                               n_on_demand=64, n_spot=64, n_pods=600)
    _, _, _, client, store, pdbs = root_bench.build_problem(2, seed, spec=spec)
    _, reports, _, _ = root_bench.run_incremental_ticks(
        client, store, pdbs, spec, "jax", n_ticks=5, churn=3,
        staged_chunk_lanes=16)
    return {
        "upload_bytes": [int(r.upload_bytes) for r in reports],
        "delta_pack_lanes": [int(r.delta_pack_lanes) for r in reports],
        "full_repack": [bool(r.full_repack) for r in reports],
        "chunks_solved": [int(r.chunks_solved) for r in reports],
        "chunks_skipped": [int(r.chunks_skipped) for r in reports],
    }


def freeze_bench_smoke(seed: int) -> dict:
    """``--smoke``'s ticks and ``--pallas-smoke``'s parity row (the
    Pallas kernel interpreted on the CPU)."""
    out = reference_smoke(seed)
    parity = _root_bench().pallas_parity_smoke(seed=seed)
    out["pallas"] = {k: parity[k] for k in ("ok", "cases", "checks",
                                            "chunk_counts", "mismatches")}
    print(f"smoke: {out}", file=sys.stderr)
    return out


def freeze_bench_soak(seed: int) -> dict:
    """``--chaos`` and ``--watch-soak`` at ``BENCH_SOAK_TICKS`` ticks:
    every count of the chaos row, and the watch soak's stats and
    violations."""
    root_bench = _root_bench()
    n = testing.BENCH_SOAK_TICKS
    row = _root_row(root_bench.run_chaos, argparse.Namespace(
        chaos_ticks=n, seed=seed), "chaos_soak_completed_ticks", "count")
    chaos = {k: v for k, v in row.items()
             if k not in ("metric", "unit", "vs_baseline", "wall_s",
                          "backend_attestation")}
    stats, violations = root_bench.watch_soak(n, seed)
    out = {"ticks": n, "chaos": chaos,
           "watch": {"stats": stats, "violations": violations}}
    print(f"soak: {out}", file=sys.stderr)
    return out


def reference_selections(spec, n: int, seed: int, cfg) -> list:
    """Each of ``n`` tenants' (``generate_cluster(spec, seed + i)``) solo
    selection on the JAX package's ``SolverPlanner`` under ``cfg``, as
    [found, node, [[pod uid, spot node], ...]], and its valid lanes."""
    from k8s_spot_rescheduler_tpu.io.synthetic import generate_cluster
    from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner

    solo = SolverPlanner(cfg)
    out, lanes = [], []
    for i in range(n):
        client = generate_cluster(spec, seed + i)
        store = client.columnar_store(
            cfg.resources, on_demand_label=cfg.on_demand_node_label,
            spot_label=cfg.spot_node_label)
        pdbs = client.list_pdbs()
        report = solo.plan(store, pdbs)
        if report.plan is None:
            out.append([False, None, []])
        else:
            out.append([True, report.plan.node.node.name,
                        sorted([k, v] for k, v in
                               report.plan.assignments.items())])
        lanes.append(int(np.asarray(store.pack(pdbs)[0].cand_valid).sum()))
    return out, lanes


SERVE_KEYS = ("n_tenants", "full_tick_bytes", "quiet_tick_bytes",
              "churn_tick_bytes", "resync_tick_bytes", "delta_applied",
              "delta_resyncs", "wire_reuse", "wire_reconnects",
              "wire_pooled_conns", "remote_fallbacks", "solo_lanes_max",
              "mismatches", "delta_mismatches", "trace_violations",
              "wire_ok", "reuse_ticks")


def freeze_bench_serve(seed: int) -> dict:
    """``bench.serve_smoke`` (``testing.BENCH_SERVE_TENANTS`` tenants, the
    reference's 100 pooled + 25 fresh reuse ticks): its counts and wire
    bytes, and each tenant's solo selection and lanes. Its co-batching
    maxima and every time are left out (they depend on thread timing)."""
    import dataclasses

    from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig

    n = testing.BENCH_SERVE_TENANTS
    result = _root_bench().serve_smoke(n_tenants=n, seed=seed)
    out = {k: result[k] for k in SERVE_KEYS}
    out["fresh_ticks"] = testing.BENCH_SERVE_REUSE[1]
    assert out["reuse_ticks"] == testing.BENCH_SERVE_REUSE[0]
    spec = dataclasses.replace(CONFIGS[2], name="serve-smoke",
                               n_on_demand=8, n_spot=8, n_pods=80)
    out["selections"], out["solo_lanes"] = reference_selections(
        spec, n, seed, ReschedulerConfig(resources=spec.resources,
                                         solver="jax"))
    print(f"serve: {out}", file=sys.stderr)
    return out


def freeze_bench_sched(seed: int) -> dict:
    """``bench.sched_smoke``: its stats and violations, and the JAX
    package's local ``plan_schedule`` cut of its service case as
    [[index, n_feasible, *row], ...]."""
    from k8s_spot_rescheduler_tpu.io.synthetic import (
        QUALITY_CONFIGS,
        generate_quality_cluster,
    )
    from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig

    stats, violations = _root_bench().sched_smoke(seed)
    spec = next(iter(QUALITY_CONFIGS.values()))
    cfg = ReschedulerConfig(solver="numpy", resources=spec.resources,
                            plan_schedule_enabled=True, schedule_horizon=6)
    client = generate_quality_cluster(spec, seed, reschedule_evicted=True)
    store = client.columnar_store(
        cfg.resources, on_demand_label=cfg.on_demand_node_label,
        spot_label=cfg.spot_node_label)
    handle = SolverPlanner(cfg).plan_schedule(store, client.list_pdbs())
    out = dict(stats)
    out["violations"] = violations
    out["schedule_cut"] = [
        [int(s.index), int(s.n_feasible), *(int(v) for v in s.row)]
        for s in handle.steps]
    print(f"sched: {out}", file=sys.stderr)
    return out


def freeze_bench_fleet(seed: int) -> dict:
    """``bench.fleet_chaos_smoke`` (``testing.BENCH_FLEET_AGENTS``
    agents): every field but ``failover_ms``, and each tenant's solo
    selection."""
    import dataclasses

    from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig

    n = testing.BENCH_FLEET_AGENTS
    result = _root_bench().fleet_chaos_smoke(n_agents=n, seed=seed)
    out = {k: v for k, v in result.items() if k != "failover_ms"}
    spec = dataclasses.replace(CONFIGS[2], name="fleet-chaos",
                               n_on_demand=6, n_spot=6, n_pods=48)
    out["selections"], _ = reference_selections(
        spec, n, seed, ReschedulerConfig(resources=spec.resources,
                                         solver="numpy"))
    print(f"fleet: {out}", file=sys.stderr)
    return out


def freeze_bench_edges(seed: int) -> dict:
    """``bench/fleet_twin.induce_shed_edges``: the per-reason metric and
    flight deltas and each probe's outcome."""
    from k8s_spot_rescheduler_tpu.bench.fleet_twin import induce_shed_edges

    out = induce_shed_edges(seed=seed)
    print(f"edges: {out}", file=sys.stderr)
    return out


def reference_latency_row(config_id: int, n_devices: int, budget: int,
                          solver: str = "jax", ticks: bool = True,
                          seed: int = 0) -> tuple:
    """The root ``bench.py``'s latency row (``_run_latency``, one repeat,
    ``backend_note`` set so the device-only chain is skipped) on config
    ``config_id`` over the first ``n_devices`` JAX devices, with
    ``solver/memory.device_hbm_budget`` forced to ``budget``. Returns
    (row, the selection vector of its last solve). ``ticks=False``
    replaces its steady incremental ticks by a stub tick (their keys then
    drop out): the guard's keys and the selection do not read them."""
    import types

    import jax

    import k8s_spot_rescheduler_tpu.solver.select as ref_select
    from k8s_spot_rescheduler_tpu.solver import memory as ref_memory

    bench = _root_bench()
    real_devices = jax.devices()
    saved = (jax.devices, ref_memory.device_hbm_budget, bench.emit,
             ref_select.decode_selection, bench.run_incremental_ticks)
    rows, selections, in_ticks = [], [], []

    def decode(vec):
        sel = saved[3](vec)
        if not in_ticks:  # the bench's own solves, not its planner's
            selections.append([int(sel.index), int(sel.found),
                               int(sel.n_feasible),
                               *(int(v) for v in sel.row)])
        return sel

    def run_ticks(*args, **kwargs):
        if not ticks:
            report = types.SimpleNamespace(
                upload_bytes=-1, delta_pack_lanes=-1, chunks_solved=0,
                chunks_skipped=0, repair_chunks=0)
            return [0.0, 0.0], [report], [0.0], []
        in_ticks.append(True)
        try:
            return saved[4](*args, **kwargs)
        finally:
            in_ticks.clear()

    jax.devices = lambda *a, **k: real_devices[:n_devices]
    ref_memory.device_hbm_budget = lambda device=None: budget
    bench.emit = rows.append
    ref_select.decode_selection = decode
    bench.run_incremental_ticks = run_ticks
    try:
        args = argparse.Namespace(config=config_id, scale=1.0, seed=seed,
                                  repeats=1, solver=solver)
        bench._run_latency(args, "drain_plan_ms", "ms", "run on the CPU")
    finally:
        (jax.devices, ref_memory.device_hbm_budget, bench.emit,
         ref_select.decode_selection, bench.run_incremental_ticks) = saved
    return rows[-1], selections[-1]


def root_guard_keys(row: dict) -> dict:
    """``testing.GUARD_KEYS`` of a root ``bench.py`` latency row in the
    port's terms: the executed tier (the rung its ``scale_note`` names,
    "2d" under the sharded solver, else "single"), and ``solver``
    ("jax" and "pallas" are the port's "torch"; None inside the
    budget)."""
    import re

    note = row.get("scale_note", "")
    rung = re.search(r"executing the dispatch ladder's verdict: (\S+) ", note)
    solver = row.get("solver")
    return {
        "tier": (rung.group(1) if rung
                 else "2d" if solver == "sharded" else "single"),
        "carry_chunks": row["carry_chunks"],
        "carry_bytes": row["carry_bytes"],
        "repair_unavailable": row["repair_unavailable"],
        "solver": "torch" if solver in ("jax", "pallas") else solver,
    }


def freeze_bench_guard(seed: int) -> dict:
    """The root ``bench.py``'s latency row under a forced budget for each
    of ``testing.BENCH_GUARD_CASES`` (its steady ticks stubbed): the
    budget, the guard's keys (``root_guard_keys``), ``scale_note`` and
    the selection. Needs at least ``testing.SHARDED_DEVICES`` JAX
    devices."""
    from k8s_spot_rescheduler_tpu.solver import memory as ref_memory

    out, packs = {}, {}
    for tag, config_id, n, budget, solver in testing.BENCH_GUARD_CASES:
        if config_id not in packs:
            packs[config_id] = pack_config(config_id, seed)
        if isinstance(budget, str):
            budget = rung_budget(budget, packs[config_id], n)
        row, selection = reference_latency_row(
            config_id, n, budget,
            solver="sharded" if solver == "sharded" else "jax",
            ticks=False, seed=seed)
        if "scale_note" not in row:
            raise ValueError(f"{tag}: budget {budget} is inside the guard")
        shapes = ref_memory.packed_shapes(packs[config_id])
        out[tag] = {"config": config_id, "devices": n, "budget": int(budget),
                    "solver": solver, "keys": root_guard_keys(row),
                    "scale_note": row["scale_note"], "selection": selection,
                    "shape": dict(zip("CKSRWA", map(int, shapes)))}
        print(f"guard {tag}: {out[tag]['keys']} {row['scale_note']}",
              file=sys.stderr)
    return out


BENCH_PARTS = {
    "quality": freeze_bench_quality,
    "replay": freeze_bench_replay,
    "chain": freeze_bench_chain,
    "scale": freeze_bench_scale,
    "harvest": freeze_bench_harvest,
    "carry": freeze_bench_carry,
    "smoke": freeze_bench_smoke,
    "soak": freeze_bench_soak,
    "serve": freeze_bench_serve,
    "sched": freeze_bench_sched,
    "fleet": freeze_bench_fleet,
    "edges": freeze_bench_edges,
    "guard": freeze_bench_guard,
}


def freeze_bench(parts=tuple(BENCH_PARTS), seed: int = testing.BENCH_SEED) -> str:
    """Write (or update) ``testing.BENCH_PATH``: the JAX package's bench
    rows of ``parts`` (default all), each part under its own key. Parts
    may run in parallel processes (``bench:quality``, ...): the file is
    read, updated and written under an exclusive lock."""
    import fcntl

    for part in parts:
        row = BENCH_PARTS[part](seed)
        with open(testing.BENCH_PATH + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            out = {"seed": seed}
            if os.path.exists(testing.BENCH_PATH):
                out = testing.load_bench()
            out[part] = row
            with open(testing.BENCH_PATH, "w") as f:
                json.dump(out, f, indent=1, sort_keys=True)
                f.write("\n")
    return testing.BENCH_PATH


def sharded_controller_pack(seed: int = 0):
    """Config 3's pack as the controller's planner packs it: the columnar
    mirror with ``testing.SHARDED_SLOTS`` pod slots (the default
    ``max_pods_per_node_hint``), C=2560 K=64 S=2560."""
    from k8s_spot_rescheduler_tpu.io.synthetic import (
        CONFIGS,
        generate_quality_cluster,
    )
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig

    spec = CONFIGS[3]
    cfg = ReschedulerConfig(resources=spec.resources)
    client = generate_quality_cluster(spec, seed)
    store = client.columnar_store(
        cfg.resources,
        on_demand_label=cfg.on_demand_node_label,
        spot_label=cfg.spot_node_label,
    )
    packed, _ = store.pack(
        client.list_pdbs(),
        priority_threshold=cfg.priority_threshold,
        pad_slots=testing.SHARDED_SLOTS,
    )
    return packed


def rung_budget(kind: str, packed, n_devices: int) -> int:
    """A ``solver_hbm_budget`` at which the ladder (``solver/memory.
    pick_tier`` over ``n_devices``, repair wanted, the pack's exact carry
    layout) lands on tier ``kind``: for "cand-carry" with more than one
    carry chunk, so the blocks' first-fit is kernel B3."""
    from k8s_spot_rescheduler_tpu.solver import carry, memory

    C, K, S, R, W, A = memory.packed_shapes(packed)
    cpb = carry.plane_bytes(carry.carry_layout(packed), R, A)
    lane = -(-C // n_devices)
    est = memory.estimate_union_hbm_bytes
    candidates = [est(C, K, S, R, W, A) - 1, 1]
    n = 1
    while -(-S // n) >= memory.MIN_REPAIR_CHUNK:
        candidates += [
            est(lane, K, S, R, W, A, repair_spot_chunks=n),
            est(lane, K, S, R, W, A, repair_spot_chunks=n) - 1,
            est(lane, K, S, R, W, A, repair_spot_chunks=n, carry_chunks=n,
                carry_plane_bytes=cpb),
        ]
        n *= 2
    for budget in sorted(set(candidates), reverse=True):
        tier = memory.pick_tier(C, K, S, R, W, A, n_devices=n_devices,
                                budget_bytes=budget, carry_plane_bytes=cpb)
        if tier.kind == kind and (kind != "cand-carry"
                                  or tier.carry_chunks > 1):
            return int(budget)
    raise ValueError(f"no budget lands {packed_shapes_str(packed)} on {kind}")


def packed_shapes_str(packed) -> str:
    from k8s_spot_rescheduler_tpu.solver import memory

    return "C=%d K=%d S=%d R=%d W=%d A=%d" % memory.packed_shapes(packed)


def reference_rung(packed, rung_kind: str, mesh_shape, budget: int) -> dict:
    """The JAX package's ``SolverPlanner`` at ``budget`` (and
    ``mesh_shape``) on ``packed``: its dispatch decision and the
    selection vector of the program it dispatched."""
    from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig

    planner = SolverPlanner(ReschedulerConfig(
        solver_hbm_budget=budget, mesh_shape=tuple(mesh_shape)))
    fused, label, dropped, repair_chunks, carry_chunks, carry_bytes = (
        planner._maybe_shard(packed))
    if fused is planner._fused:
        raise ValueError(f"budget {budget} did not reroute ({label})")
    return {
        "selection": np.asarray(fused(packed), np.int32),
        "label": np.asarray(label),
        "dispatch": np.asarray(
            [int(dropped), repair_chunks, carry_chunks, carry_bytes],
            np.int64),
        "budget": np.int64(budget),
        "kind": np.asarray(rung_kind),
    }


def reference_rung_lanes(packed, kind: str, mesh_shape) -> dict:
    """The JAX package's lanes on ``packed`` of the 2-D union
    (``plan_ffd_sharded`` first-fit ∪ best-fit over ``mesh_shape``) or
    of the carry tier (``plan_union_cand_sharded``, 8 repair rounds,
    ``STREAM_CHUNKS`` carry chunks under the pack's carry layout)."""
    import functools

    import jax

    from k8s_spot_rescheduler_tpu.parallel.mesh import (
        make_cand_mesh,
        make_mesh,
    )
    from k8s_spot_rescheduler_tpu.parallel.sharded_ffd import (
        plan_ffd_sharded,
        plan_union_cand_sharded,
    )
    from k8s_spot_rescheduler_tpu.solver.carry import carry_layout
    from k8s_spot_rescheduler_tpu.solver.fallback import with_best_fit_fallback

    if kind == "2d":
        solve = with_best_fit_fallback(
            functools.partial(plan_ffd_sharded, make_mesh(tuple(mesh_shape))))
    else:
        solve = functools.partial(
            plan_union_cand_sharded, make_cand_mesh(), rounds=8,
            carry_chunks=STREAM_CHUNKS, carry_layout=carry_layout(packed))
    res = jax.jit(solve)(packed)
    return {"feasible": np.asarray(res.feasible, bool),
            "assignment": np.asarray(res.assignment, np.int32)}


def reference_sharded_cli_run(seed: int = 0) -> dict:
    """What the JAX package's CLI does with ``testing.SHARDED_CLI_ARGS``,
    in process (``reference_cli_run``'s route)."""
    from k8s_spot_rescheduler_tpu.cli.main import build_parser, config_from_args
    from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS, generate_cluster
    from k8s_spot_rescheduler_tpu.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner

    args = build_parser().parse_args(list(testing.SHARDED_CLI_ARGS))
    cfg = config_from_args(args)
    client = generate_cluster(CONFIGS[3], seed, reschedule_evicted=True)
    r = Rescheduler(client, SolverPlanner(cfg), cfg, clock=client.clock,
                    recorder=client)
    return {
        "args": list(testing.SHARDED_CLI_ARGS),
        "digest": testing.cluster_digest(client),
        "records": testing.run_ticks(r, client, args.ticks),
    }


def reference_scale_smoke() -> dict:
    """The root ``bench.py --scale-smoke`` row."""
    import types

    bench = _root_bench()
    return _root_row(bench.run_scale_smoke, types.SimpleNamespace(),
                     "scale_smoke_20x_shape_proof_s", "s")


def freeze_sharded(seed: int = 0) -> str:
    """Write ``testing.SHARDED_PATH``: config 3's controller pack and the
    JAX package's answers on it at every rung of ``testing.
    SHARDED_RUNGS`` (``reference_rung``, with the budget that lands on
    it), the contended pack's and the harvested tick's selections and
    lanes at ``testing.SHARDED_PACK_RUNGS``, the sharded CLI run's
    records and the scale-smoke row (JSON). Runs on
    ``testing.SHARDED_DEVICES`` virtual CPU devices, as the chip smoke's
    planner lays its mesh over that many."""
    import jax

    n = len(jax.devices())
    if n != testing.SHARDED_DEVICES:
        raise RuntimeError(f"{n} JAX devices, not {testing.SHARDED_DEVICES}: "
                           "run `python -m tests.torch_port_fixtures sharded` "
                           "alone")
    from k8s_spot_rescheduler_tpu_torch.models.tensors import load_npz

    packed = sharded_controller_pack(seed)
    out = {}
    for name, kind, mesh_shape in testing.SHARDED_RUNGS:
        budget = rung_budget(kind, packed, n)
        for k, v in reference_rung(packed, kind, mesh_shape, budget).items():
            out[f"config3_{name}_{k}"] = v
    sources = {"contended": frozen_path(CONTENDED, seed),
               "harvest": testing.HARVEST_PATH}
    from k8s_spot_rescheduler_tpu.models.tensors import PackedCluster

    for pack_name in testing.SHARDED_PACKS:
        host = PackedCluster(*load_npz(sources[pack_name])[0])
        for name, kind, mesh_shape in testing.SHARDED_PACK_RUNGS:
            budget = rung_budget(kind, host, n)
            rung = reference_rung(host, kind, mesh_shape, budget)
            rung.update(reference_rung_lanes(host, kind, mesh_shape))
            for k, v in rung.items():
                out[f"{pack_name}_{name}_{k}"] = v
    out["cli"] = np.asarray(json.dumps(reference_sharded_cli_run(seed)))
    out["scale_smoke"] = np.asarray(json.dumps(reference_scale_smoke(),
                                               sort_keys=True))
    os.makedirs(DATA_DIR, exist_ok=True)
    save_npz(testing.SHARDED_PATH, packed, seed=np.int32(seed),
             devices=np.int32(n), **out)
    return testing.SHARDED_PATH


def main(argv) -> int:
    if {"sharded", "bench:guard"} & set(argv or ()):
        # before jax is imported: the mesh of the chip smoke's planner
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count="
              f"{testing.SHARDED_DEVICES}").strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
    for arg in argv or ["3"]:
        if arg == "sharded":
            path = freeze_sharded()
        elif arg == "ticks":
            path = freeze_ticks()
        elif arg == "service":
            path = reference_service()
        elif arg == "chaos":
            path = freeze_chaos()
        elif arg == "bench" or arg.startswith("bench:"):
            path = freeze_bench(arg.split(":")[1:] or tuple(BENCH_PARTS))
        else:
            path = freeze(arg if arg == CONTENDED else int(arg))
        print(f"{path}: {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

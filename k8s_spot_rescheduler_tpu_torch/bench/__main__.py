"""The port's benchmark driver: ``python -m k8s_spot_rescheduler_tpu_torch.bench``.

The port's counterpart of the repo's root ``bench.py`` for these modes,
with that file's metric names (``metric_for``), so the rows of the two
packages compare:

- ``--config 1-4`` (default 3): drain-plan latency. Generate the
  synthetic config, observe and pack it through the columnar mirror
  (median of 5 packs), upload it, then solve+fetch the union (first-fit
  and best-fit as kernels B1/B2 on the card, repair) with the host clock
  around each synchronised call (median of ``--repeats``), the full tick
  (pack + upload + solve + fetch), the steady incremental tick of
  ``TorchSolverPlanner.plan`` through the resident cache, and the
  device-only estimate of ``bench/protocol``. Metric
  ``drain_plan_ms_config3_50kpods_5knodes`` and its siblings. The
  planner has one device here, so the memory ladder answers "single".
- ``--config 5 [--constrained] --events N``: the spot-interruption
  replay (``bench/replay``). Metrics ``replay_replan_ms_p50_1k_events``
  and ``replay_constrained_replan_ms_p50_1k_events``.
- ``--quality``: every ``QUALITY_CONFIGS`` entry x seeds, variants
  ``ffd`` and ``shipped``, drained to exhaustion against the ILP oracle.
  Metric ``nodes_freed_vs_ilp_oracle_ratio`` (the worst shipped ratio).
- ``--quality-boundary``: the chain3 boundary. Metric
  ``repair_boundary_chain3_ratio``.
- ``--quality-scale``: the controller drains ``--config`` (3 or 4) at
  ``--scale`` to exhaustion, 256 drains a tick and
  ``--schedule-horizon``-step schedules, against ``lp_upper_bound``,
  with the fetch bound checked. Metric
  ``nodes_freed_vs_lp_bound_ratio_config3``.
- ``--chain-depth``: the chain-depth demand table (``bench/
  chain_depth``) over the organic runs (quality configs and the
  constrained replay at ``--events``) and the chain3 control. Metric
  ``chain_depth_demand_deeper_lanes_organic``; exit 1 when the control
  registers no ``deeper`` lane.
- ``--replay-device-only [--harvest-cache PATH]``: the constrained-replay
  tick (``--events``) where greedy leaves the most lanes unproven, on
  the shipped union by the device-only protocol (``bench/
  replay_device``). Metric ``replay_constrained_device_only_ms``; exit 1
  when no tick fires best-fit.
- ``--carry-wall [--carry-chunks N]``: the carry-streamed union (B3/B4,
  repair) at ``--config`` x ``--scale`` (``bench/carry_wall``). Metric
  ``carry_union_wall_ms_config3_x1`` and its siblings.
- ``--scale-smoke``: the dispatch ladder at the 20x shapes (1M pods,
  100k nodes) over 8 devices at the default budget, shape only, no
  solve (``bench/scale_smoke``): repair stays live, the estimate fits,
  B3 and B4 have launch geometries at the lane block. Metric
  ``scale_smoke_20x_shape_proof_s``.
- ``--smoke``: five ticks of the incremental pipeline on a small
  cluster; exit 1 unless the delta tick uploads fewer bytes than the
  first full pack (``bench/smoke``). Metric
  ``bench_smoke_delta_upload_bytes``.
- ``--pallas-smoke``: kernel B4 against the plain streamed best-fit at
  chunk counts 2, 3 and 5 and the oracle, B1 against the oracle, on
  three small packs (``bench/smoke``). Metric ``pallas_parity_wall_s``.
- ``--chaos [--chaos-ticks N]`` and ``--watch-soak [--watch-soak-ticks
  N]``: the control loop under the seeded fault layers on a virtual
  clock, held to its robustness and freshness invariants (``bench/
  soak``). Metrics ``chaos_soak_completed_ticks`` and
  ``watch_soak_completed_ticks``; exit 1 on any violation.
- ``--serve-smoke [--tenants N]``: ``N`` (at least 4) tenants solo and
  through a ``ServiceServer`` over HTTP, the delta-wire ticks and the
  pooled-reuse phase (``bench/service_smoke``). Metric
  ``serve_smoke_agent_plan_ms``.
- ``--sched-smoke``: drain schedules locally, over the wire and across a
  failover (``bench/service_smoke``). Metric
  ``sched_smoke_fetches_total``.
- ``--fleet-chaos``: agents x two replicas through the six scripted
  failure phases (``bench/fleet_chaos``). Metric
  ``fleet_chaos_failover_ms``.
- ``--fleet-twin-smoke``, ``--fleet-twin`` and ``--storm-smoke``
  ``[--tenants N] [--twin-calibration FILE]``: tenant twins against two
  replicas on a virtual clock (``bench/fleet_twin``); the smokes add the
  per-reason shed-edge induction. ``--twin-calibration`` reads the
  ``twin_calibration`` tables of ``--carry-wall`` rows
  (``load_twin_calibration``; a file without one is an error). Metrics
  ``fleet_twin_smoke_capacity_tenants_per_device``,
  ``fleet_twin_capacity_tenants_per_device`` and
  ``storm_smoke_resync_converge_ticks``.

Every mode plans with ``solver="torch"`` on ``--device`` (``cuda`` by
default), but for the host half of ``--replay-device-only``, which
replays on the numpy oracle as the reference does. There is no
fallback: without a card and without ``--device cpu`` the bench exits
1 with the error ``device.resolve_device`` raises and prints no row; a
fault of the card's kernels ends the run.
Progress goes to stderr, then ONE JSON line to stdout. Each row carries
``backend_attestation`` (the device that solved, the card's name and
``nvidia-smi`` name and power limit, ``device_sick``, and the planner
and remote-planner fallbacks of this run) and ``launches``, the kernel
launches of this run (``ops/ffd_kernels.LAUNCHES``). ``--trace-dir DIR``
wraps the timed region in ``utils/tracing.device_trace`` and names the
Chrome trace in the row (``trace_file``).

Run e.g.::

    python -m k8s_spot_rescheduler_tpu_torch.bench --config 3
    python -m k8s_spot_rescheduler_tpu_torch.bench --device cpu --config 1
    python -m k8s_spot_rescheduler_tpu_torch.bench --device cpu --config 5 --events 20
    python -m k8s_spot_rescheduler_tpu_torch.bench --device cpu --quality
    python -m k8s_spot_rescheduler_tpu_torch.bench --carry-wall --carry-chunks 4
    python -m k8s_spot_rescheduler_tpu_torch.bench --device cpu --chaos
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import shutil
import subprocess
import sys
import time

import numpy as np

TARGET_MS = 200.0  # BASELINE.json's drain-plan target


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m k8s_spot_rescheduler_tpu_torch.bench")
    ap.add_argument("--config", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the planner runs: cuda (default; fails "
                         "without a card) or cpu")
    ap.add_argument("--quality", action="store_true",
                    help="nodes freed against the ILP oracle over the "
                         "quality configs")
    ap.add_argument("--quality-boundary", action="store_true",
                    help="the published chain3 repair boundary")
    ap.add_argument("--quality-scale", action="store_true",
                    help="--config 3|4 drained to exhaustion against the "
                         "LP/Hall upper bound")
    ap.add_argument("--chain-depth", action="store_true",
                    help="chain-depth demand table (chain3 control)")
    ap.add_argument("--sweep", type=int, default=1,
                    help="seeds [seed, seed+sweep) for the quality modes")
    ap.add_argument("--events", type=int, default=1000,
                    help="events of the --config 5 replay (and of the "
                         "--chain-depth constrained replay)")
    ap.add_argument("--constrained", action="store_true",
                    help="with --config 5: the full-predicate replay")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply the config's node/pod counts")
    ap.add_argument("--schedule-horizon", type=int, default=32,
                    help="drain-schedule horizon of --quality-scale "
                         "(0 = per-drain fetches)")
    ap.add_argument("--trace-dir", default="",
                    help="wrap the timed region in a torch.profiler "
                         "trace written here")
    ap.add_argument("--replay-device-only", action="store_true",
                    help="harvest the constrained-replay tick where "
                         "best-fit and repair fire and run the device-"
                         "only chain protocol on it")
    ap.add_argument("--harvest-cache", default="",
                    help="with --replay-device-only: reuse or store the "
                         "harvested tick at this .npz path")
    ap.add_argument("--carry-wall", action="store_true",
                    help="wall clock of the carry-streamed union (B3/B4, "
                         "repair) at --config x --scale")
    ap.add_argument("--carry-chunks", type=int, default=0,
                    help="with --carry-wall: pin the carry chunk count "
                         "(0 = the 20x ladder verdict's count)")
    ap.add_argument("--scale-smoke", action="store_true",
                    help="shape-only 20x proof: the dispatch ladder at "
                         "1M pods / 100k nodes over 8 devices, the "
                         "estimator breakdown and B3/B4 launch "
                         "geometries at the lane block (no solve)")
    ap.add_argument("--smoke", action="store_true",
                    help="five incremental ticks on a small cluster; the "
                         "delta tick must ship fewer bytes than the first "
                         "full pack")
    ap.add_argument("--pallas-smoke", action="store_true",
                    help="kernel B4 against the plain streamed best-fit "
                         "at chunk counts 2, 3, 5 and the oracle, B1 "
                         "against the oracle (plain versions only with "
                         "--device cpu)")
    ap.add_argument("--chaos", action="store_true",
                    help="chaos soak: the control loop under the seeded "
                         "kube fault layer and two scripted planner "
                         "crashes, held to the robustness invariants")
    ap.add_argument("--chaos-ticks", type=int, default=300,
                    help="ticks of the --chaos soak")
    ap.add_argument("--watch-soak", action="store_true",
                    help="freshness soak: the watch protocol under "
                         "stalls, drops, scripted 410s and one mirror "
                         "corruption, held to the freshness invariants")
    ap.add_argument("--watch-soak-ticks", type=int, default=300,
                    help="ticks of the --watch-soak run")
    ap.add_argument("--serve-smoke", action="store_true",
                    help="N tenants solo and through the planner service "
                         "over HTTP: bit-identical selections, co-batching, "
                         "delta-wire bytes and pooled-socket reuse")
    ap.add_argument("--tenants", type=int, default=4,
                    help="tenant count for --serve-smoke and --fleet-chaos "
                         "(at least 4) and for the fleet twin modes")
    ap.add_argument("--sched-smoke", action="store_true",
                    help="drain schedules: local parity and fetch bound, "
                         "churn invalidation, wire bit-identity, failover "
                         "with a schedule in flight")
    ap.add_argument("--fleet-chaos", action="store_true",
                    help="agents x 2 replicas through healthy, half-close, "
                         "corrupt-delta, wire-chaos, sick-device and "
                         "replica kill/restart phases")
    ap.add_argument("--fleet-twin-smoke", action="store_true",
                    help="64 tenant twins x 2 replicas, ~20 simulated "
                         "minutes, plus the shed-edge induction")
    ap.add_argument("--fleet-twin", action="store_true",
                    help="512 tenant twins x 2 replicas through one "
                         "simulated hour: the capacity curve")
    ap.add_argument("--storm-smoke", action="store_true",
                    help=">= 32 tenant twins x 2 replicas through the "
                         "restart storm, plus the shed-edge induction")
    ap.add_argument("--twin-calibration", default="",
                    help="a file of --carry-wall JSON rows: the fleet "
                         "twin charges their measured per-bucket solve "
                         "seconds instead of the modelled cost")
    return ap


def metric_for(args) -> tuple:
    """(metric name, unit) of this invocation: the root ``bench.py``'s
    ``_metric_for`` for the same flags."""
    if args.chaos:
        return "chaos_soak_completed_ticks", "count"
    if args.watch_soak:
        return "watch_soak_completed_ticks", "count"
    if args.smoke:
        return "bench_smoke_delta_upload_bytes", "bytes"
    if args.scale_smoke:
        return "scale_smoke_20x_shape_proof_s", "s"
    if args.serve_smoke:
        return "serve_smoke_agent_plan_ms", "ms"
    if args.sched_smoke:
        return "sched_smoke_fetches_total", "count"
    if args.fleet_chaos:
        return "fleet_chaos_failover_ms", "ms"
    if args.fleet_twin_smoke:
        return "fleet_twin_smoke_capacity_tenants_per_device", "tenants"
    if args.fleet_twin:
        return "fleet_twin_capacity_tenants_per_device", "tenants"
    if args.storm_smoke:
        return "storm_smoke_resync_converge_ticks", "ticks"
    if args.pallas_smoke:
        return "pallas_parity_wall_s", "s"
    if args.carry_wall:
        return (
            "carry_union_wall_ms_config%d_x%g" % (args.config, args.scale),
            "ms",
        )
    if args.quality:
        return "nodes_freed_vs_ilp_oracle_ratio", "ratio"
    if args.quality_boundary:
        return "repair_boundary_chain3_ratio", "ratio"
    if args.chain_depth:
        return "chain_depth_demand_deeper_lanes_organic", "count"
    if args.replay_device_only:
        return "replay_constrained_device_only_ms", "ms"
    if args.quality_scale:
        return (
            "nodes_freed_vs_lp_bound_ratio_config%d" % args.config,
            "ratio",
        )
    if args.config == 5:
        if args.constrained:
            return "replay_constrained_replan_ms_p50_1k_events", "ms"
        return "replay_replan_ms_p50_1k_events", "ms"
    suffix = "_x%g" % args.scale if args.scale != 1.0 else ""
    if args.config in (3, 4):
        return (
            "drain_plan_ms_config%d_50kpods_5knodes%s" % (args.config, suffix),
            "ms",
        )
    return "drain_plan_ms_config%d%s" % (args.config, suffix), "ms"


def load_twin_calibration(path: str) -> dict:
    """Per-bucket measured solve costs from a file of bench JSON rows
    (``--carry-wall`` rows carry a ``twin_calibration`` table: bucket key
    -> {"solve_s": measured seconds}). Later lines win on key
    collisions; lines that are not JSON are skipped (bench output
    interleaves logs with rows). A missing file, or one without a
    table, is an error: a calibrated fleet run must not fall back to the
    modelled cost line unnoticed."""
    table: dict = {}
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue
            cal = row.get("twin_calibration") if isinstance(row, dict) else None
            if isinstance(cal, dict):
                for key, cost in cal.items():
                    if isinstance(cost, dict) and "solve_s" in cost:
                        table[str(key)] = {"solve_s": float(cost["solve_s"])}
    if not table:
        raise ValueError(
            f"no twin_calibration tables found in {path!r} "
            f"(expected --carry-wall JSON rows)"
        )
    return table


# --- attestation and the one JSON line ------------------------------------


def _counters() -> dict:
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics

    return {
        "planner_fallbacks": metrics.robustness_snapshot()["planner_fallback"],
        "remote_planner_fallbacks":
            metrics.service_snapshot()["remote_planner_fallback"],
    }


def nvidia_smi() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    "" where there is no ``nvidia-smi``."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return ""
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError) as err:
        return f"unavailable: {err}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def backend_attestation(device, base: dict) -> dict:
    """Which device solved, and whether anything in this run left it:
    the card's name (``torch.cuda.get_device_name``) and ``nvidia-smi``
    name and power limit, the service watchdog's sick gauge, and the
    planner and remote-planner fallbacks since ``base``
    (``_counters()`` at the run's start)."""
    import torch

    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics

    out: dict = {}
    if device.type == "cuda":
        out["solve_backend"] = f"cuda/{torch.cuda.get_device_name(device)}"
        out["n_devices"] = torch.cuda.device_count()
    else:
        out["solve_backend"] = "cpu"
        out["n_devices"] = 1
    smi = nvidia_smi()
    if smi:
        out["nvidia_smi"] = smi
    out["device_sick"] = bool(metrics.service_snapshot()["device_sick"])
    now = _counters()
    for key, value in now.items():
        out[key] = int(value - base[key])
    return out


def drop_non_finite(obj):
    """Strictly valid JSON: dict entries holding NaN/inf are omitted,
    list elements become null."""
    if isinstance(obj, dict):
        return {
            k: drop_non_finite(v)
            for k, v in obj.items()
            if not (isinstance(v, float) and not math.isfinite(v))
        }
    if isinstance(obj, (list, tuple)):
        return [
            None
            if isinstance(v, float) and not math.isfinite(v)
            else drop_non_finite(v)
            for v in obj
        ]
    return obj


def emit(row: dict) -> None:
    print(json.dumps(drop_non_finite(row)), flush=True)


def progress(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def evictions_digest(evictions) -> str:
    """sha256 of the evicted pod UIDs in order, one a line (a row's
    compact stand-in for the list)."""
    return hashlib.sha256("\n".join(evictions).encode()).hexdigest()


# --- latency (configs 1-4) --------------------------------------------------


def scaled_spec(base, scale: float):
    """A config's node/pod counts times ``scale`` (1.0 = unchanged)."""
    if scale == 1.0:
        return base
    return dataclasses.replace(
        base,
        name=f"{base.name}-x{scale:g}",
        n_on_demand=int(base.n_on_demand * scale),
        n_spot=int(base.n_spot * scale),
        n_pods=int(base.n_pods * scale),
    )


def build_problem(spec, seed: int = 0, pack_repeats: int = 1):
    """Generate the synthetic cluster and pack it through the columnar
    mirror (the production observe path). The pack time is the median
    over ``pack_repeats`` packs of the attached mirror, the steady
    per-tick observe+pack. Returns (packed, pack_seconds, generate
    seconds, client, store, pdbs)."""
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import generate_cluster
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    cfg = ReschedulerConfig(resources=spec.resources)
    t0 = time.perf_counter()
    client = generate_cluster(spec, seed)
    t1 = time.perf_counter()
    store = client.columnar_store(
        cfg.resources,
        on_demand_label=cfg.on_demand_node_label,
        spot_label=cfg.spot_node_label,
    )
    pdbs = client.list_pdbs()
    t2 = time.perf_counter()
    pack_times = []
    for _ in range(max(1, pack_repeats)):
        t_p = time.perf_counter()
        packed, _ = store.pack(pdbs, priority_threshold=cfg.priority_threshold)
        pack_times.append(time.perf_counter() - t_p)
    pack_s = float(np.median(pack_times))
    progress(
        f"generate {t1 - t0:.1f}s  ingest(once) {t2 - t1:.2f}s  "
        f"columnar observe+pack {pack_s * 1e3:.1f} ms "
        f"(median of {len(pack_times)})  "
        f"shapes C={packed.slot_req.shape[0]} K={packed.slot_req.shape[1]} "
        f"S={packed.spot_free.shape[0]} R={packed.slot_req.shape[2]}"
    )
    return packed, pack_s, t1 - t0, client, store, pdbs


def _synced(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_incremental_ticks(client, store, pdbs, spec, device, n_ticks: int,
                          churn: int = 5, staged_chunk_lanes=None):
    """The production per-tick pipeline: ``TorchSolverPlanner.plan`` on
    the mirror, each tick's pack diffed into the resident cache, the
    staged early-exit solve (``staged_chunk_lanes`` lanes a chunk, the
    config's default when None), one small fetch; ``churn`` pod removals
    between ticks. Each tick runs under its own trace
    (``utils/tracing.tick_trace``), as the control loop runs it. Returns
    (tick ms, reports, mirror-sync ms, traces); tick 0 is the cold full
    upload."""
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.utils import tracing
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    cfg = ReschedulerConfig(resources=spec.resources)
    if staged_chunk_lanes is not None:
        cfg = dataclasses.replace(cfg, staged_chunk_lanes=staged_chunk_lanes)
    planner = TorchSolverPlanner(cfg, device=device)
    uids = iter(list(client.pods))
    tick_ms, reports, sync_ms, traces = [], [], [], []
    for i in range(n_ticks):
        if i:
            t_s = time.perf_counter()
            for _ in range(churn):
                uid = next(uids, None)
                if uid is not None:
                    client._remove_pod(uid)
            sync_ms.append((time.perf_counter() - t_s) * 1e3)
        t0 = time.perf_counter()
        with tracing.tick_trace() as trace:
            reports.append(planner.plan(store, pdbs))
        traces.append(trace)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    return tick_ms, reports, sync_ms, traces


def run_latency(args, device, metric: str, unit: str) -> tuple:
    from k8s_spot_rescheduler_tpu_torch.bench import protocol
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import CONFIGS
    from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
    from k8s_spot_rescheduler_tpu_torch.solver import carry as solver_carry
    from k8s_spot_rescheduler_tpu_torch.solver import memory as solver_memory
    from k8s_spot_rescheduler_tpu_torch.solver.fallback import union_program
    from k8s_spot_rescheduler_tpu_torch.solver.repair import DEFAULT_ROUNDS
    from k8s_spot_rescheduler_tpu_torch.solver.select import (
        decode_selection,
        make_fused_planner,
    )
    from k8s_spot_rescheduler_tpu_torch.utils import tracing

    spec = scaled_spec(CONFIGS[args.config], args.scale)
    packed, pack_s, gen_s, client, store, pdbs = build_problem(
        spec, args.seed, pack_repeats=5
    )
    # the dispatch ladder over the bench's one device: always "single"
    # (the mesh tiers: chip smoke phase 13, bench --scale-smoke)
    shapes = solver_memory.packed_shapes(packed)
    layout = solver_carry.carry_layout(packed)
    tier = solver_memory.pick_tier(
        *shapes,
        n_devices=1,
        budget_bytes=solver_memory.device_hbm_budget(device),
        wants_repair=True,
        carry_plane_bytes=solver_carry.plane_bytes(
            layout, shapes[3], shapes[5]
        ),
    )
    fused = make_fused_planner(
        union_program(DEFAULT_ROUNDS, True, use_kernel=True)
    )

    _synced(device)
    t0 = time.perf_counter()
    device_packed = to_device(packed, device)
    _synced(device)
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sel = decode_selection(fused(device_packed))
    first_s = time.perf_counter() - t0

    times = []
    with tracing.device_trace() as trace:
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            sel = decode_selection(fused(device_packed))
            times.append(time.perf_counter() - t0)

    # the full tick from a fresh host pack: upload -> solve -> one fetch
    e2e = []
    for _ in range(max(3, args.repeats // 2)):
        t0 = time.perf_counter()
        sel = decode_selection(fused(to_device(packed, device)))
        e2e.append(time.perf_counter() - t0)

    protocol_rec = protocol.run_protocol(fused, device_packed)
    tick_ms, tick_reports, sync_ms, _ = run_incremental_ticks(
        client, store, pdbs, spec, device,
        n_ticks=max(4, min(8, args.repeats)),
    )
    tick_report = tick_reports[-1]
    steady_ms = float(np.median(tick_ms[1:]))
    value_ms = float(np.median(times) * 1e3)
    e2e_ms = float(np.median(e2e) * 1e3)
    n_cand = int(np.asarray(packed.cand_valid).sum())
    progress(
        f"first call {first_s:.2f}s  upload {upload_s * 1e3:.2f} ms  "
        f"solve+fetch median {value_ms:.3f} ms (min {min(times) * 1e3:.3f}, "
        f"max {max(times) * 1e3:.3f})  with-upload {e2e_ms:.3f} ms  "
        f"full tick (pack+upload+solve+fetch) {pack_s * 1e3 + e2e_ms:.1f} ms  "
        f"steady incremental tick {steady_ms:.3f} ms "
        f"(delta {tick_report.upload_bytes} B)  device-only "
        f"{protocol_rec['device_only_ms']} ms/solve  feasible "
        f"{sel.n_feasible}/{n_cand} candidates, first={sel.index}  "
        f"tier {tier.kind}"
    )
    row = {
        "metric": metric,
        "value": round(value_ms, 3),
        "unit": unit,
        "vs_baseline": round(TARGET_MS / value_ms, 3),
        "device": str(device),
        "generate_s": round(gen_s, 3),
        "pack_ms": round(pack_s * 1e3, 3),
        "upload_ms": round(upload_s * 1e3, 3),
        "first_call_s": round(first_s, 3),
        "solve_fetch_ms_min": round(min(times) * 1e3, 3),
        "with_upload_ms": round(e2e_ms, 3),
        "full_tick_ms": round(pack_s * 1e3 + e2e_ms, 3),
        "steady_tick_ms": round(steady_ms, 3),
        "sync_ms": round(float(np.median(sync_ms)), 3),
        "delta_upload_bytes": int(tick_report.upload_bytes),
        "delta_pack_lanes": int(tick_report.delta_pack_lanes),
        "chunks_solved": int(tick_report.chunks_solved),
        "chunks_skipped": int(tick_report.chunks_skipped),
        "device_only": protocol_rec,
        "tier": tier.kind,
        "carry_chunks": int(tier.carry_chunks),
        "carry_bytes": int(tier.carry_bytes),
        "repair_unavailable": int(tier.repair_unavailable),
        "candidates": n_cand,
        "n_feasible": int(sel.n_feasible),
        "first_candidate": int(sel.index),
        "selection": [int(sel.index), int(sel.found), int(sel.n_feasible),
                      *(int(v) for v in sel.row)],
        "shape": dict(zip("CKSRWA", (int(v) for v in shapes))),
    }
    if trace.path:
        row["trace_file"] = trace.path
    return 0, row


# --- replay (config 5) -------------------------------------------------------


def run_replay_bench(args, device, metric: str, unit: str) -> tuple:
    from k8s_spot_rescheduler_tpu_torch.bench.replay import run_replay
    from k8s_spot_rescheduler_tpu_torch.utils import tracing
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    t0 = time.perf_counter()
    with tracing.device_trace() as trace:
        stats = run_replay(
            ReschedulerConfig(solver="torch"), n_events=args.events,
            seed=args.seed, constrained=args.constrained, device=device,
        )
    wall = time.perf_counter() - t0
    progress(f"replay ({wall:.1f} s): {stats}")
    p50 = stats["replan_ms_p50"]
    row = {
        "metric": metric,
        "value": round(p50, 3),
        "unit": unit,
        "vs_baseline": round(TARGET_MS / max(p50, 1e-9), 3),
        "replan_ms_p99": round(stats["replan_ms_p99"], 3),
        "stranded_by_drain": stats["stranded_by_drain"],
        "drained_nodes": stats["drained_nodes"],
        "stats": stats,
    }
    if args.constrained:
        row["unplaceable_pods_gauge"] = stats["unplaceable_pods_gauge"]
    if trace.path:
        row["trace_file"] = trace.path
    return 0, row


# --- quality -----------------------------------------------------------------


def quality_row(spec, seed: int, device, variants=("ffd", "shipped")) -> dict:
    """One config at one seed: the ILP of its fresh pack and each
    variant drained to exhaustion from a fresh cluster on ``device``
    (``ffd``: first-fit alone; ``shipped``: first-fit ∪ best-fit ∪
    repair), with the count and digest of each run's evictions."""
    from k8s_spot_rescheduler_tpu_torch.bench.quality import (
        drain_to_exhaustion,
        ilp_max_drains,
        pack_quality,
    )
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
        generate_quality_cluster,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    t0 = time.perf_counter()
    row = {"ilp": ilp_max_drains(pack_quality(spec, seed)), "seed": seed}
    row["ilp_s"] = round(time.perf_counter() - t0, 3)
    knobs = {"ffd": dict(fallback_best_fit=False, repair_rounds=0),
             "shipped": {}}
    for variant in variants:
        client = generate_quality_cluster(spec, seed, reschedule_evicted=True)
        t0 = time.perf_counter()
        row[variant] = drain_to_exhaustion(
            client,
            ReschedulerConfig(solver="torch", resources=spec.resources,
                              **knobs[variant]),
            device=device,
        )
        row[f"{variant}_s"] = round(time.perf_counter() - t0, 3)
        row[f"{variant}_ratio"] = (
            round(row[variant] / row["ilp"], 4) if row["ilp"] else 1.0
        )
        row[f"{variant}_evictions"] = len(client.evictions)
        row[f"{variant}_evictions_sha256"] = evictions_digest(client.evictions)
    return row


def run_quality(args, device, metric: str, unit: str) -> tuple:
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import QUALITY_CONFIGS

    rows, worst = {}, 1.0
    for name, spec in QUALITY_CONFIGS.items():
        for s in range(args.seed, args.seed + max(1, args.sweep)):
            row = quality_row(spec, s, device)
            worst = min(worst, row["shipped_ratio"])
            rows[f"{name}/{s}"] = row
            progress(
                f"quality {name} seed {s}: ILP {row['ilp']}  pure-FFD "
                f"{row['ffd']} ({row['ffd_ratio']:.3f})  shipped "
                f"{row['shipped']} ({row['shipped_ratio']:.3f})  "
                f"[ILP {row['ilp_s']} s, drains {row['ffd_s']} + "
                f"{row['shipped_s']} s]"
            )
    progress(f"worst shipped ratio: {worst:.4f}")
    return 0, {
        "metric": metric,
        "value": round(worst, 4),
        "unit": unit,
        "vs_baseline": round(worst / 0.95, 4),
        "rows": rows,
    }


def run_quality_boundary(args, device, metric: str, unit: str) -> tuple:
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import BOUNDARY_CONFIGS

    rows, worst = {}, 1.0
    for name, spec in BOUNDARY_CONFIGS.items():
        for s in range(args.seed, args.seed + max(1, args.sweep)):
            row = quality_row(spec, s, device, variants=("shipped",))
            worst = min(worst, row["shipped_ratio"])
            rows[f"{name}/{s}"] = row
            progress(
                f"boundary {name} seed {s}: ILP {row['ilp']}  shipped "
                f"{row['shipped']} ({row['shipped_ratio']:.3f})"
            )
    return 0, {
        "metric": metric,
        "value": round(worst, 4),
        "unit": unit,
        "vs_baseline": None,
        "note": "published depth-2 chained-repair boundary "
                "(three-link chains)",
        "rows": rows,
    }


def run_quality_scale(args, device, metric: str, unit: str) -> tuple:
    """The LP/Hall upper bound (``bench/quality.lp_upper_bound``) against
    the controller draining ``--config`` to exhaustion in multi-drain
    mode. Achieved/bound UNDERSTATES true quality (the bound relaxes
    per-node bins and anti-affinity)."""
    from k8s_spot_rescheduler_tpu_torch.bench.quality import (
        drain_to_exhaustion,
        lp_upper_bound,
    )
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
        CONFIGS,
        generate_cluster,
    )
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    spec = scaled_spec(CONFIGS[args.config], args.scale)
    packed = build_problem(spec, args.seed)[0]
    t0 = time.perf_counter()
    bound = lp_upper_bound(packed)
    t_bound = time.perf_counter() - t0
    if bound is None:
        return 1, {"metric": metric, "value": None, "unit": unit,
                   "error": "lp_upper_bound failed (linprog unsuccessful)"}
    progress(
        f"LP/Hall upper bound ({spec.name}, seed {args.seed}): {bound} "
        f"drainable of {int(np.asarray(packed.cand_valid).sum())} "
        f"candidates ({t_bound:.1f}s)"
    )
    horizon = max(0, int(args.schedule_horizon))
    cfg = ReschedulerConfig(
        solver="torch",
        resources=spec.resources,
        max_drains_per_tick=256,
        plan_schedule_enabled=horizon > 0,
        schedule_horizon=horizon or 32,
    )
    client = generate_cluster(spec, args.seed, reschedule_evicted=True)
    inv0 = metrics.robustness_snapshot()["schedule_invalidated"]
    stats: dict = {}
    t0 = time.perf_counter()
    achieved = drain_to_exhaustion(
        client, cfg, max_ticks=200, planner_stats=stats, device=device
    )
    t_drain = time.perf_counter() - t0
    inv = int(metrics.robustness_snapshot()["schedule_invalidated"] - inv0)
    ratio = achieved / bound if bound else 1.0
    fetches = int(stats["fetches_total"])
    lens = [int(n) for n in stats["schedule_lens"]]
    progress(
        f"achieved {achieved} drains in {t_drain:.1f}s ({fetches} planner "
        f"fetches, {len(lens)} schedule cuts); achieved/bound {ratio:.3f}"
    )
    row = {
        "metric": metric,
        "value": round(ratio, 4),
        "unit": unit,
        "vs_baseline": round(ratio / 0.95, 4),
        "bound": bound,
        "achieved": achieved,
        "scale": args.scale,
        "fetches_total": fetches,
        "schedule_lens": lens,
        "schedule_horizon": horizon,
        "schedule_invalidated": inv,
        "bound_s": round(t_bound, 3),
        "sched_wall_s": round(t_drain, 3),
        "evictions": len(client.evictions),
        "evictions_sha256": evictions_digest(client.evictions),
    }
    if lens:
        row["schedule_len_p50"] = float(np.percentile(lens, 50))
        row["schedule_len_p95"] = float(np.percentile(lens, 95))
    if horizon > 0:
        # churn-free sweep: every invalidation adds one fetch
        fetch_bound = math.ceil(max(achieved, 1) / cfg.schedule_horizon) + 2
        fetch_bound += inv
        row["fetch_bound"] = fetch_bound
        if fetches > fetch_bound:
            row["error"] = (
                f"fetches_total {fetches} > ceil(drains/horizon)+2 = "
                f"{fetch_bound}: the O(1)-fetch claim failed"
            )
            return 1, row
    return 0, row


# --- chain depth ---------------------------------------------------------------

CHAIN_KEYS = ("greedy", "depth1", "depth2", "deeper", "infeasible",
              "ilp-failed")


def run_chain_depth(args, device, metric: str, unit: str) -> tuple:
    from k8s_spot_rescheduler_tpu_torch.bench.chain_depth import (
        analyze_quality_runs,
        analyze_replay,
    )
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import BOUNDARY_CONFIGS

    seeds = range(args.seed, args.seed + max(1, args.sweep))
    organic = analyze_quality_runs(seeds=seeds, device=device)
    organic["constrained-replay"] = analyze_replay(
        n_events=args.events, seed=args.seed, constrained=True,
        device=device,
    )
    control = analyze_quality_runs(
        seeds=seeds, configs=BOUNDARY_CONFIGS, device=device
    )
    progress("chain-depth demand (lane-ticks by minimal proving mechanism):")
    for name, counts in {**organic, **{
        f"[control] {k}": v for k, v in control.items()
    }}.items():
        progress(f"  {name}: " + "  ".join(
            f"{k}={counts.get(k, 0)}" for k in CHAIN_KEYS))
    deeper_organic = sum(c.get("deeper", 0) for c in organic.values())
    deeper_control = sum(c.get("deeper", 0) for c in control.values())
    row = {
        "metric": metric,
        "value": int(deeper_organic),
        "unit": unit,
        "vs_baseline": 1.0 if deeper_organic == 0 else 0.0,
        "control_deeper": int(deeper_control),
        "replay_events": args.events,
        "organic": {k: dict(v) for k, v in organic.items()},
        "control": {k: dict(v) for k, v in control.items()},
    }
    if deeper_control == 0:
        # a dead positive control voids the organic zero
        row["vs_baseline"] = 0.0
        row["error"] = ("positive control (chain3) registered no depth-3 "
                        "demand; instrument suspect")
        return 1, row
    return 0, row


# --- entry ----------------------------------------------------------------------


def run(argv=None) -> tuple:
    """Parse ``argv``, run the mode on its device and return (exit code,
    row) without printing the row. Raises RuntimeError (from
    ``device.resolve_device``) for ``cuda`` without a card."""
    from k8s_spot_rescheduler_tpu_torch.device import resolve_device
    from k8s_spot_rescheduler_tpu_torch.ops import ffd_kernels
    from k8s_spot_rescheduler_tpu_torch.utils import tracing

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    metric, unit = metric_for(args)
    base = _counters()
    launches0 = dict(ffd_kernels.LAUNCHES)
    if args.trace_dir:
        tracing.enable_profiler(args.trace_dir)
    try:
        if args.chaos:
            from k8s_spot_rescheduler_tpu_torch.bench.soak import run_chaos

            mode = run_chaos
        elif args.watch_soak:
            from k8s_spot_rescheduler_tpu_torch.bench.soak import (
                run_watch_soak,
            )

            mode = run_watch_soak
        elif args.smoke:
            from k8s_spot_rescheduler_tpu_torch.bench.smoke import run_smoke

            mode = run_smoke
        elif args.scale_smoke:
            from k8s_spot_rescheduler_tpu_torch.bench.scale_smoke import (
                run_scale_smoke,
            )

            mode = run_scale_smoke
        elif args.serve_smoke or args.sched_smoke:
            from k8s_spot_rescheduler_tpu_torch.bench import service_smoke

            mode = (service_smoke.run_serve_smoke if args.serve_smoke
                    else service_smoke.run_sched_smoke)
        elif args.fleet_chaos:
            from k8s_spot_rescheduler_tpu_torch.bench.fleet_chaos import (
                run_fleet_chaos,
            )

            mode = run_fleet_chaos
        elif args.fleet_twin_smoke or args.fleet_twin or args.storm_smoke:
            from k8s_spot_rescheduler_tpu_torch.bench import fleet_twin

            mode = (fleet_twin.run_fleet_twin_smoke if args.fleet_twin_smoke
                    else fleet_twin.run_fleet_twin if args.fleet_twin
                    else fleet_twin.run_storm_smoke)
        elif args.pallas_smoke:
            from k8s_spot_rescheduler_tpu_torch.bench.smoke import (
                run_pallas_smoke,
            )

            mode = run_pallas_smoke
        elif args.carry_wall:
            from k8s_spot_rescheduler_tpu_torch.bench.carry_wall import (
                run_carry_wall,
            )

            mode = run_carry_wall
        elif args.quality:
            mode = run_quality
        elif args.quality_boundary:
            mode = run_quality_boundary
        elif args.chain_depth:
            mode = run_chain_depth
        elif args.replay_device_only:
            from k8s_spot_rescheduler_tpu_torch.bench.replay_device import (
                run_replay_device_only,
            )

            mode = run_replay_device_only
        elif args.quality_scale:
            mode = run_quality_scale
        elif args.config == 5:
            mode = run_replay_bench
        else:
            mode = run_latency
        t0 = time.perf_counter()
        rc, row = mode(args, device, metric, unit)
        # the fleet twin rows keep their own (the fleet loop's) wall
        row.setdefault("wall_s", round(time.perf_counter() - t0, 3))
    finally:
        if args.trace_dir:
            tracing.disable_profiler()
    row["launches"] = {
        k: v - launches0.get(k, 0) for k, v in ffd_kernels.LAUNCHES.items()
    }
    row["backend_attestation"] = backend_attestation(device, base)
    return rc, row


def main(argv=None) -> int:
    from k8s_spot_rescheduler_tpu_torch.device import resolve_device

    args = build_parser().parse_args(argv)
    try:
        resolve_device(args.device)
        if args.twin_calibration:
            # a calibrated fleet run without a table fails before it runs
            load_twin_calibration(args.twin_calibration)
    except (RuntimeError, ValueError, OSError) as err:
        print(f"Error: {err}", file=sys.stderr)
        return 1
    rc, row = run(argv)
    emit(row)
    return rc


if __name__ == "__main__":
    sys.exit(main())

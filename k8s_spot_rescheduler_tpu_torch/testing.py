"""Seeded host packs for holding the kernels against the plain versions.

``random_pack`` is the one random-pack generator of the port's tests and
``chip_smoke.py``. ``overlay_stress_packs`` builds on it the packs that
stress kernels B1/B2's touched-spot overlay; each is a numpy
``PackedCluster`` made from ``seed``, and the tests and ``chip_smoke.py``
hold the kernels against ``solver/ffd.plan_ffd`` on every one of them:

- ``one_spot``: many pods on one spot (large ``max_pods``, three spots),
  so one overlay entry takes every commit;
- ``k130``: K=130 slots, the int16-count packs' K, so a lane's overlay
  and slot rows span five warp-widths;
- ``ragged_spots``: S=97, a last window of one spot;
- ``ragged_lanes``: C=2,567 lanes, not a multiple of any lane count a
  block takes on an H100 (``launch_geometry``);
- ``invalid_blocks``: two valid lanes of 600, so whole blocks hold only
  invalid lanes;
- ``later_window``: the only other fit lies in window 2, behind a spot of
  window 0 that earlier slots touched until it is full (by room,
  capacity or affinity, one lane each).

And the packs that stress kernel B4's narrow overlay, whose entries hold
the delta carry in the ``carry_layout`` dtypes (``STRESS_LAYOUTS`` names
each one's layout):

- ``k_distinct``: K=48 slots that share an affinity bit, so a lane
  touches K distinct spots and its entries span two warp-widths;
- ``dcount_guard``: K=127 pods re-hit the one spot that fits until
  ``dcount`` reaches int8's guard, 127;
- ``used_int16_edge`` / ``used_uint16_edge``: a lane's requests on one
  spot sum to 32,767 / 65,535, the top of the int16 / uint16 ``used``;
- ``aff_bit7`` / ``aff_bit15`` / ``aff_bit31``: affinity bits up to
  bit 7 / 15 / 31, the top bit of a uint8 / uint16 / uint32 ``daff``
  (bit 31 is a negative int32 word on the card).

``CONTROLLER_RUNS``, ``controller_config``, ``cluster_digest`` and
``run_ticks`` drive a controller over a synthetic cluster tick by tick,
through the object path or the columnar mirror, and record what each
tick did. ``KUBE_RUNS`` and ``run_kube_ticks`` do the same through a
watched API server: ``StubApiServer`` serves a synthetic cluster over
HTTP on 127.0.0.1 (list, watch, eviction, taint patch, events, leases)
as ``encode_node``/``encode_pod``/``encode_pdb`` write it, and
``MirrorTracker`` lets a tick wait until the watch mirror has applied
every event the server sent. They are duck-typed over the package, so
``tests/torch_port_fixtures.py`` runs the JAX package's controller
through them to freeze its drains (``data/ticks_seed0.json``) and
``chip_smoke.py`` holds the port's against those.

``past_smem_pack`` is a contended-like pack (S=1,152 spots, R=2, W=17
taint words, A=2) with K=2,200 slots a lane: one lane's state passes an
H100 block's shared memory for B1-B4 alike, so the kernels carve their
lanes from the device-memory workspace.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from k8s_spot_rescheduler_tpu_torch.models.cluster import TO_BE_DELETED_TAINT
from k8s_spot_rescheduler_tpu_torch.models.tensors import PackedCluster


def random_bits(rng, shape, p: float = 0.3, top: int = 32):
    """uint32 words with one random bit below ``top`` set, each with
    probability ``p``, else 0."""
    return (
        (np.uint32(1) << rng.integers(0, top, shape).astype(np.uint32))
        * (rng.random(shape) < p)
    ).astype(np.uint32)


def random_pack(rng, C: int, K: int, S: int, R: int, W: int = 1, A: int = 2,
                *, req_max: int = 60, max_pods: int = 12) -> PackedCluster:
    """A random host pack over every predicate, drawn from the numpy
    generator ``rng``, with integral capacities from a small range so
    best-fit ties are common."""
    return PackedCluster(
        slot_req=rng.integers(0, req_max, (C, K, R)).astype(np.float32) * 10,
        slot_valid=rng.random((C, K)) < 0.8,
        slot_tol=rng.integers(0, 4, (C, K, W)).astype(np.uint32),
        slot_aff=random_bits(rng, (C, K, A)),
        cand_valid=rng.random((C,)) < 0.9,
        spot_free=rng.integers(-10, 150, (S, R)).astype(np.float32) * 10,
        spot_count=rng.integers(0, 5, (S,)).astype(np.int32),
        spot_max_pods=rng.integers(1, max_pods, (S,)).astype(np.int32),
        spot_taints=rng.integers(0, 4, (S, W)).astype(np.uint32),
        spot_ok=rng.random((S,)) < 0.9,
        spot_aff=random_bits(rng, (S, A)),
    )


def _one_spot(rng) -> PackedCluster:
    C, K, S, R = 16, 64, 3, 2
    base = random_pack(rng, C, K, S, R, req_max=8)
    return base._replace(
        slot_aff=np.zeros((C, K, 2), np.uint32),
        slot_valid=rng.random((C, K)) < 0.95,
        spot_free=np.array([[5000, 5000], [3000, 4000], [8000, 8000]],
                           np.float32),
        spot_count=np.array([0, 3, 1], np.int32),
        spot_max_pods=np.array([1000, 1000, 40], np.int32),
        spot_taints=np.zeros((S, 1), np.uint32),
        spot_ok=np.ones((S,), bool),
        spot_aff=np.zeros((S, 2), np.uint32),
    )


def _later_window() -> PackedCluster:
    """Spot 5 (window 0) takes two pods of 50; spot 70 (window 2) takes
    ten. Lane 0 fills spot 5 by room, lane 1 by capacity (requests of
    60), lane 2 by affinity (every slot carries bit 1), lane 3 by room
    again with small pods."""
    C, K, S, R, W, A = 4, 4, 96, 2, 1, 2
    free = np.zeros((S, R), np.float32)
    free[5] = 100
    free[70] = 500
    max_pods = np.full((S,), 10, np.int32)
    max_pods[5] = 2
    req = np.full((C, K, R), 50, np.float32)
    req[1] = 60
    req[2:] = 10
    aff = np.zeros((C, K, A), np.uint32)
    aff[2, :, 0] = 2
    return PackedCluster(
        slot_req=req,
        slot_valid=np.ones((C, K), bool),
        slot_tol=np.zeros((C, K, W), np.uint32),
        slot_aff=aff,
        cand_valid=np.ones((C,), bool),
        spot_free=free,
        spot_count=np.zeros((S,), np.int32),
        spot_max_pods=max_pods,
        spot_taints=np.zeros((S, W), np.uint32),
        spot_ok=np.ones((S,), bool),
        spot_aff=np.zeros((S, A), np.uint32),
    )


def _k_distinct(rng) -> PackedCluster:
    """Every slot carries affinity bit 3 and no spot does: each pod needs
    a spot no earlier pod of its lane took. Lane 0's 48 slots are all
    valid and 48 spots fit every pod."""
    C, K, S = 12, 48, 200
    base = random_pack(rng, C, K, S, 2, req_max=10)
    valid = base.slot_valid.copy()
    valid[0] = True
    free = base.spot_free.copy()
    free[:K] = 2000.0
    ok = base.spot_ok.copy()
    ok[:K] = True
    return base._replace(
        slot_valid=valid,
        slot_aff=np.full((C, K, 2), 8, np.uint32) * np.array([1, 0],
                                                              np.uint32),
        spot_aff=np.zeros((S, 2), np.uint32),
        spot_taints=np.zeros((S, 1), np.uint32),
        spot_count=np.zeros((S,), np.int32),
        spot_max_pods=np.full((S,), 50, np.int32),
        spot_free=free,
        spot_ok=ok,
    )


def _one_spot_fits(rng, C: int, K: int, S: int, R: int, req: float,
                   spot: int) -> PackedCluster:
    """C lanes of K pods requesting ``req`` of every resource, lane 0's
    all valid; only ``spot`` takes any (room for K more, free for exactly
    K), the other spots each ruled out by ok, capacity, room or taint."""
    base = random_pack(rng, C, K, S, R)
    valid = base.slot_valid.copy()
    valid[0] = True
    free = np.full((S, R), K * req, np.float32)
    ok = np.ones((S,), bool)
    count = np.full((S,), 3, np.int32)
    max_pods = np.full((S,), 3 + K, np.int32)
    taints = np.zeros((S, 1), np.uint32)
    for s in range(S):
        if s == spot:
            continue
        rule = s % 4
        if rule == 0:
            ok[s] = False
        elif rule == 1:
            free[s] = req - 10.0
        elif rule == 2:
            max_pods[s] = 3
        else:
            taints[s] = 4  # no slot tolerates bit 2
    return base._replace(
        slot_req=np.full((C, K, R), req, np.float32),
        slot_valid=valid,
        slot_tol=np.zeros((C, K, 1), np.uint32),
        slot_aff=np.zeros((C, K, 2), np.uint32),
        spot_free=free,
        spot_count=count,
        spot_max_pods=max_pods,
        spot_taints=taints,
        spot_ok=ok,
        spot_aff=np.zeros((S, 2), np.uint32),
    )


def _aff_bits(rng, top: int) -> PackedCluster:
    """Affinity words of bits 0..``top`` (at least one ``top``), few
    spots with room for many pods, so pods sharing a bit spread over the
    spots a lane touched."""
    C, K, S = 24, 12, 40
    base = random_pack(rng, C, K, S, 2, req_max=6, max_pods=30)
    aff = random_bits(rng, (C, K, 2), p=0.6, top=top + 1)
    aff[0, 0, 0] = np.uint32(1) << top
    aff[:, ::2, 1] = np.uint32(1) << top  # half the pods share the top bit
    spot_aff = random_bits(rng, (S, 2), p=0.2, top=top + 1)
    return base._replace(
        slot_aff=aff,
        spot_aff=spot_aff,
        spot_ok=np.ones((S,), bool),
        spot_free=np.abs(base.spot_free) + 400.0,
    )


# the carry layout (used, count, aff) each B4 stress pack is built for
STRESS_LAYOUTS = {
    "k_distinct": ("int16", "int8", "uint8"),
    "dcount_guard": ("int16", "int8", "uint8"),
    "used_int16_edge": ("int16", "int8", "uint8"),
    "used_uint16_edge": ("uint16", "int8", "uint8"),
    "aff_bit7": ("int16", "int8", "uint8"),
    "aff_bit15": ("int16", "int8", "uint16"),
    "aff_bit31": ("int16", "int8", "uint32"),
}


def overlay_stress_packs(seed: int = 0) -> dict:
    """{name: host pack} of the overlay's corner cases (module doc)."""
    rng = np.random.default_rng(seed)
    invalid = random_pack(rng, 600, 8, 300, 4)
    cand = np.zeros((600,), bool)
    cand[[0, 599]] = True
    return {
        "one_spot": _one_spot(rng),
        "k130": random_pack(rng, 24, 130, 200, 4, req_max=24, max_pods=40),
        "ragged_spots": random_pack(rng, 40, 8, 97, 3),
        "ragged_lanes": random_pack(rng, 2567, 8, 300, 4),
        "invalid_blocks": invalid._replace(cand_valid=cand),
        "later_window": _later_window(),
        "k_distinct": _k_distinct(rng),
        "dcount_guard": _one_spot_fits(rng, 6, 127, 40, 2, 200.0, 37),
        "used_int16_edge": _one_spot_fits(rng, 6, 7, 70, 4, 4681.0, 45),
        "used_uint16_edge": _one_spot_fits(rng, 6, 5, 70, 4, 13107.0, 66),
        "aff_bit7": _aff_bits(rng, 7),
        "aff_bit15": _aff_bits(rng, 15),
        "aff_bit31": _aff_bits(rng, 31),
    }


PAST_SMEM_SHAPE = (48, 2200, 1152, 2, 17, 2)  # C, K, S, R, W, A


def past_smem_pack(seed: int = 0) -> PackedCluster:
    """The contended-like pack of ``PAST_SMEM_SHAPE`` (module doc): half
    the slots valid, spot taints and affinity bits sparse, so most slots
    pass the 17 taint words and each lane places a thousand pods before
    it fails or proves (first-fit proves most lanes, best-fit few)."""
    C, K, S, R, W, A = PAST_SMEM_SHAPE
    rng = np.random.default_rng(seed)
    base = random_pack(rng, C, K, S, R, W, A, max_pods=16)
    return base._replace(
        slot_valid=rng.random((C, K)) < 0.5,
        slot_aff=random_bits(rng, (C, K, A), p=0.01),
        spot_taints=random_bits(rng, (S, W), p=0.02, top=8),
    )


# --- controller runs ------------------------------------------------------------

# (name, synthetic config, ticks, schedule_horizon, observe): the
# controller runs frozen from the JAX package and checked on the card,
# each from a fresh ``generate_cluster(CONFIGS[config], seed,
# reschedule_evicted=True)``; ``observe`` is "objects" (the object path,
# ``use_columnar=False``) or "columnar" (the mirror, the default)
CONTROLLER_RUNS = (
    ("config3", 3, 5, 32, "objects"),
    ("config3-horizon0", 3, 3, 0, "objects"),
    ("config4", 4, 3, 32, "objects"),
    ("config3-columnar", 3, 5, 32, "columnar"),
    ("config3-horizon0-columnar", 3, 3, 0, "columnar"),
    ("config4-columnar", 4, 3, 32, "columnar"),
)
# (name, synthetic config, ticks, schedule_horizon): the runs through a
# ``StubApiServer`` serving the config, a watch client and its columnar
# mirror (``run_kube_ticks``)
KUBE_RUNS = (("config3-kube", 3, 3, 0),)
# the small runs of the frozen file that tier-1 re-runs from the JAX
# package (``tests/test_torch_controller.py``): columnar and kube
SMALL_RUNS = (
    ("config1-columnar", 1, 4, 32, "columnar"),
    ("config2-columnar", 2, 3, 0, "columnar"),
)
SMALL_KUBE_RUNS = (("config1-kube", 1, 3, 32),)
# the CLI run: ``--cluster synthetic:1`` with these flags
CLI_ARGS = ("--cluster", "synthetic:1", "--ticks", "3", "--no-metrics-server",
            "--node-drain-delay", "1s")
# the kube CLI run: ``--cluster kube:<stub URL>`` serving synthetic
# config ``KUBE_CLI_CONFIG`` at seed 0, with these flags; the
# housekeeping interval is real time, two ticks a drain delay apart
KUBE_CLI_CONFIG = 1
KUBE_CLI_ARGS = ("--watch-cache", "true", "--ticks", "2",
                 "--no-metrics-server", "--housekeeping-interval", "2s",
                 "--node-drain-delay", "1s")
TICKS_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data", "ticks_seed0.json"
)


# the planner service's fleet: (tenant, synthetic config, seed), each
# tenant an agent planning its own fake cluster through the service;
# ``tests/torch_port_fixtures.py service`` freezes what the JAX
# package's service answers for it into ``SERVICE_PATH``
SERVICE_TENANTS = tuple(
    (f"config{config_id}-seed{seed}", config_id, seed)
    for config_id in (3, 4) for seed in range(4)
)
SERVICE_HORIZON = 32  # the frozen schedule batch's horizon
SERVICE_TICKS = 2  # agent ticks per tenant through the service
SERVICE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data", "service_seed0.json"
)

# the mesh tiers (chip smoke phase 13), frozen from the JAX package on
# ``SHARDED_DEVICES`` virtual CPU devices into ``SHARDED_PATH``
# (``tests/torch_port_fixtures.py sharded``): config 3's controller pack
# (``SHARDED_SLOTS`` pod slots) through each rung of the dispatch ladder
# (name, the ladder's tier kind, ``mesh_shape``), the contended pack and
# the harvested tick through the 2-D tier and the carry tier
# (``SHARDED_PACKS``), the CLI with ``SHARDED_CLI_ARGS`` and the root
# ``bench.py --scale-smoke`` row
SHARDED_DEVICES = 4
SHARDED_SLOTS = 64
SHARDED_RUNGS = (
    ("cand", "cand", (1, 1)),
    ("cand-chunked", "cand-chunked", (1, 1)),
    ("cand-carry", "cand-carry", (1, 1)),
    ("2d-4x1", "2d", (4, 1)),
    ("2d-2x2", "2d", (2, 2)),
)
SHARDED_PACKS = ("contended", "harvest")
SHARDED_PACK_RUNGS = (("2d-2x2", "2d", (2, 2)), ("cand-carry", "cand-carry", (1, 1)))
SHARDED_CLI_ARGS = ("--cluster", "synthetic:3", "--ticks", "3", "--solver",
                    "sharded", "--mesh-shape", "1x1", "--no-metrics-server",
                    "--node-drain-delay", "1s")
SHARDED_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data", "sharded_seed0.npz"
)

# the fault layers' runs (``io/chaos``), frozen from the JAX package into
# ``CHAOS_PATH`` (``tests/torch_port_fixtures.py chaos``), each from a
# fresh ``generate_cluster(CONFIGS[config], seed,
# reschedule_evicted=True)`` with schedules on (horizon
# ``CHAOS_HORIZON``): ``CHAOS_RUNS`` (name, config, ticks) through a
# ``ChaosClusterClient`` under ``FaultPlan.profile("heavy", seed)``; the
# mid-drain crash on ``CRASH_CONFIG`` (``FaultPlan(interrupt_on_taint=
# 1)``), then ``CRASH_TICKS`` ticks of a restarted controller on the
# bare cluster; the CLI with ``CHAOS_CLI_ARGS``; and ``POLL_RUNS``, the
# controller on the polling kube client (no watch cache) through a
# ``StubApiServer`` (``run_kube_ticks`` without a tracker). ``WATCH_FAULTS`` is the plan with only watch
# faults that the watched kube run must survive unchanged.
CHAOS_RUNS = (("heavy-config3", 3, 5), ("heavy-config1", 1, 10))
CHAOS_HORIZON = 32
CRASH_CONFIG = 3
CRASH_TICKS = 3
CHAOS_CLI_ARGS = (*CLI_ARGS, "--chaos-profile", "light", "--chaos-seed", "0")
POLL_RUNS = (("config3-poll", 3, 2, 0),)
WATCH_FAULTS = {"watch_410_streams": (1, 3), "watch_drop_rate": 0.05}
# the robustness counters a chaos tick records the deltas of
COUNTERS = ("planner_fallback", "orphaned_taints_recovered",
            "schedule_invalidated")
CHAOS_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data", "chaos_seed0.json"
)


# the bench's rows (``python -m k8s_spot_rescheduler_tpu_torch.bench``),
# frozen from the JAX package into ``BENCH_PATH`` (``tests/
# torch_port_fixtures.py bench``) at ``BENCH_SEED``: every quality and
# boundary config drained to exhaustion, the config-5 replay at
# ``BENCH_REPLAY_EVENTS`` events and the constrained one at
# ``BENCH_CONSTRAINED_EVENTS``, the chain-depth counters, and
# ``--quality-scale`` on config ``BENCH_SCALE_CONFIG`` at
# ``BENCH_SCALE``
BENCH_SEED = 0
BENCH_REPLAY_EVENTS = 1000
BENCH_CONSTRAINED_EVENTS = 300
BENCH_SCALE_CONFIG = 3
BENCH_SCALE = 1.0
BENCH_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data", "bench_seed0.json"
)
# the root bench.py's single-device modes, frozen into the same file:
# the constrained-replay tick ``--replay-device-only`` harvests at
# ``BENCH_HARVEST_EVENTS`` events, stored as the reference's harvest
# cache at ``HARVEST_PATH``; ``--carry-wall`` on config
# ``BENCH_CARRY_CONFIG`` at ``BENCH_CARRY_CHUNKS`` chunks and at the
# ladder's count; ``--smoke``, ``--pallas-smoke``; ``--chaos`` and
# ``--watch-soak`` at ``BENCH_SOAK_TICKS`` ticks
BENCH_HARVEST_EVENTS = 300
HARVEST_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data",
    "replay_harvest_seed0.npz",
)
BENCH_CARRY_CONFIG = 3
BENCH_CARRY_CHUNKS = 4
BENCH_SOAK_TICKS = 300
# the root bench.py's service-side modes, frozen into the same file:
# ``serve_smoke`` (4 tenants; its pooled-reuse phase at the reference's
# 100 + 25 ticks), ``sched_smoke``, ``fleet_chaos_smoke`` (4 agents)
# and ``fleet_twin.induce_shed_edges``: counts, bytes and selections,
# never wall times
BENCH_SERVE_TENANTS = 4
BENCH_SERVE_REUSE = (100, 25)
BENCH_FLEET_AGENTS = 4
# the latency mode's memory guard, frozen into the same file under
# "guard" from the root bench.py's ``_run_latency``: (tag, config,
# devices, budget, solver), the budget in bytes or the rung a budget is
# found for on the bench's pack (``tests/torch_port_fixtures.
# rung_budget``); one device past the budget (chip smoke phase 10) and
# the cand, cand-carry and 2-D rungs over 4 devices (phase 13). The 2-D
# row is config 1's: the 2-D solve is a host loop of torch ops a slot and
# shard, ~0.2 s a call at config 3 on the card, and the row's device-only
# chain makes 255 calls
BENCH_GUARD_CASES = (
    ("one-device", 3, 1, 600_000_000, "torch"),
    ("cand", 3, SHARDED_DEVICES, "cand", "torch"),
    ("cand-carry", 3, SHARDED_DEVICES, "cand-carry", "torch"),
    ("2d", 1, SHARDED_DEVICES, "2d", "sharded"),
)
# the keys of a latency row that name the program it ran
GUARD_KEYS = ("tier", "carry_chunks", "carry_bytes", "repair_unavailable",
              "solver")


def load_bench(path: str | None = None) -> dict:
    """The frozen bench rows (``tests/torch_port_fixtures.py bench``),
    from ``BENCH_PATH`` by default."""
    with open(path or BENCH_PATH) as f:
        return json.load(f)


def controller_config(config_cls, spec, horizon: int, observe: str):
    """The controller runs' configuration, of either package's
    ``ReschedulerConfig`` class: the spec's resources, a 1 s drain delay
    (a drain each 10 s tick), ``horizon`` (0 = schedules off) and the
    observe path: ``"objects"`` turns ``use_columnar`` off, anything
    else leaves the mirror on (its default)."""
    return config_cls(
        node_drain_delay=1.0,
        resources=tuple(spec.resources),
        schedule_horizon=horizon,
        use_columnar=observe != "objects",
    )


def service_config(config_cls, spec, **overrides):
    """An agent's configuration for the service fleet, of either
    package's ``ReschedulerConfig`` class: ``controller_config`` on the
    mirror with schedules off (each tick sends one single-plan request),
    with ``overrides`` (the planner URL and timeout)."""
    return dataclasses.replace(
        controller_config(config_cls, spec, 0, "columnar"), **overrides
    )


def agent_pack(planner, client):
    """The pack an agent ``planner`` (either package's ``RemotePlanner``)
    sends for fake cluster ``client`` on its first tick: the cluster's
    columnar mirror packed through the planner's high-water pads
    (``planner/base.pack_observation``)."""
    cfg = planner.config
    store = client.columnar_store(
        cfg.resources,
        on_demand_label=cfg.on_demand_node_label,
        spot_label=cfg.spot_node_label,
    )
    packed, _ = planner._pack_observation(store, client.list_pdbs())
    return packed


def cluster_digest(client) -> str:
    """sha256 of a fake cluster's nodes and pods in their order: node
    names, pod UIDs, each pod's node and requests."""
    h = hashlib.sha256()
    for node in client.nodes.values():
        h.update(f"N {node.name}\n".encode())
    for pod in client.pods.values():
        req = sorted((k, int(v)) for k, v in pod.requests.items())
        h.update(f"P {pod.uid} {pod.node_name} {req}\n".encode())
    return h.hexdigest()


def run_ticks(rescheduler, client, ticks: int) -> list:
    """Drive ``ticks`` housekeeping ticks as the CLI does (sleep the
    effective interval on the cluster's virtual clock, then tick); one
    record a tick: the nodes drained, the pod UIDs evicted (sorted: the
    drain evicts a node's pods from a thread pool, in no fixed order),
    the skip reason ("" when the tick ran) and whether the fallback
    planner ran."""
    return [tick_once(rescheduler, client) for _ in range(ticks)]


def tick_once(rescheduler, client) -> dict:
    """One tick of ``run_ticks`` and its record."""
    client.clock.sleep(rescheduler.effective_interval())
    seen = len(client.evictions)
    res = rescheduler.tick()
    return {
        "drained": list(res.drained),
        "evicted": sorted(client.evictions[seen:]),
        "skipped": res.skipped,
        "planner_fallback": bool(res.planner_fallback),
    }


def chaos_ticks(rescheduler, client, ticks: int, snapshot) -> list:
    """``run_ticks`` with each tick's robustness counter deltas
    (``COUNTERS``) and the ``degraded`` gauge after it, read by
    ``snapshot`` (either package's ``metrics.robustness_snapshot``).
    ``client`` is a fake cluster or a ``ChaosClusterClient`` over one."""
    out = []
    for _ in range(ticks):
        before = snapshot()
        rec = tick_once(rescheduler, client)
        after = snapshot()
        rec["counters"] = {k: int(after[k] - before[k]) for k in COUNTERS}
        rec["degraded"] = int(after["degraded"])
        out.append(rec)
    return out


def tainted_nodes(client) -> list:
    """Names of the fake cluster's nodes that carry the ToBeDeleted
    taint, sorted."""
    return sorted(
        name for name, node in client.nodes.items()
        if any(t.key == TO_BE_DELETED_TAINT for t in node.taints)
    )


def crash_run(client, chaos_client, make_rescheduler, ticks: int,
              snapshot) -> dict:
    """The mid-drain crash (either package's classes): a controller
    (``make_rescheduler(chaos_client)``) over ``chaos_client``, whose
    plan raises ``ChaosInterrupt`` right after the first taint, ticks
    once; then a restarted controller (``make_rescheduler(client)``) on
    the bare cluster ``client`` heals the orphaned taint at start-up and
    ticks ``ticks`` times. Records the crash, the orphans, the heal
    count and the later ticks (``chaos_ticks``)."""
    r = make_rescheduler(chaos_client)
    client.clock.sleep(r.effective_interval())
    crashed = False
    try:
        r.tick()
    except BaseException as err:  # noqa: BLE001 — either package's ChaosInterrupt, re-raised otherwise
        if type(err).__name__ != "ChaosInterrupt":
            raise
        crashed = True
    orphaned = tainted_nodes(client)
    evicted = sorted(client.evictions)
    before = snapshot()
    restarted = make_rescheduler(client)
    healed = snapshot()["orphaned_taints_recovered"] - before[
        "orphaned_taints_recovered"]
    return {
        "crashed": crashed,
        "orphaned": orphaned,
        "evicted_before_restart": evicted,
        "healed": int(healed),
        "tainted_after_restart": tainted_nodes(client),
        "records": chaos_ticks(restarted, client, ticks, snapshot),
    }


def load_chaos(path: str | None = None) -> dict:
    """The frozen fault-layer runs (``tests/torch_port_fixtures.py
    chaos``), from ``CHAOS_PATH`` by default."""
    with open(path or CHAOS_PATH) as f:
        return json.load(f)


def load_ticks(path: str | None = None) -> dict:
    """The frozen controller runs (``tests/torch_port_fixtures.py
    ticks``), from ``TICKS_PATH`` by default."""
    with open(path or TICKS_PATH) as f:
        return json.load(f)


# --- the API server: encoders, stub, mirror tracking -------------------------

# ``PodSpec.anti_affinity_group`` has no field in the pod API: it encodes
# as its equivalent, a pod label and a hostname anti-affinity term over
# that label in every namespace
GROUP_LABEL = "spot-rescheduler.test/anti-affinity-group"
ALL_NAMESPACES = ("*",)  # predicates/selectors.ALL_NAMESPACES


def _quantity(name: str, value: int) -> str:
    return f"{int(value)}m" if name == "cpu" else str(int(value))


def _selector(sel) -> dict:
    """A canonical selector (tuple of (key, op, values)) as a
    LabelSelector."""
    exprs = []
    for key, op, values in sel:
        e = {"key": key, "operator": op}
        if op not in ("Exists", "DoesNotExist"):
            e["values"] = list(values)
        exprs.append(e)
    return {"matchExpressions": exprs}


def _term(term, topology_key: str) -> dict:
    namespaces, sel = term
    out = {"topologyKey": topology_key, "labelSelector": _selector(sel)}
    if tuple(namespaces) == ALL_NAMESPACES:
        out["namespaceSelector"] = {}
    else:
        out["namespaces"] = list(namespaces)
    return out


def encode_node(node, uid: str = "") -> dict:
    """A node API object that ``io/kube.decode_node`` reads back as
    ``node``."""
    return {
        "metadata": {"name": node.name, "uid": uid or f"node-{node.name}",
                     "labels": dict(node.labels)},
        "spec": {
            "taints": [{"key": t.key, "value": t.value, "effect": t.effect}
                       for t in node.taints],
            "unschedulable": bool(node.unschedulable),
        },
        "status": {
            "allocatable": {k: _quantity(k, v)
                            for k, v in node.allocatable.items()},
            "conditions": [{"type": "Ready",
                            "status": "True" if node.ready else "False"}],
        },
    }


def encode_pod(pod, uid: str = "") -> dict:
    """A pod API object that ``io/kube.decode_pod`` reads back as
    ``pod``, for every field ``io/synthetic`` sets (``GROUP_LABEL`` for
    the anti-affinity group)."""
    labels = dict(pod.labels)
    anti_host = list(pod.anti_affinity_match)
    if pod.anti_affinity_group:
        labels[GROUP_LABEL] = pod.anti_affinity_group
        anti_host.append(
            (ALL_NAMESPACES,
             ((GROUP_LABEL, "In", (pod.anti_affinity_group,)),))
        )
    affinity = {}
    anti = ([_term(t, "kubernetes.io/hostname") for t in anti_host]
            + [_term(t, "topology.kubernetes.io/zone")
               for t in pod.anti_affinity_zone_match])
    if anti:
        affinity["podAntiAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": anti}
    paff = ([_term(t, "kubernetes.io/hostname")
             for t in pod.pod_affinity_match]
            + [_term(t, "topology.kubernetes.io/zone")
               for t in pod.pod_affinity_zone_match])
    if paff:
        affinity["podAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": paff}
    if pod.node_affinity:
        terms = []
        for term in pod.node_affinity:
            exprs, fields = [], []
            for key, op, values in term:
                if op in ("FieldIn", "FieldNotIn"):
                    fields.append({"key": key, "operator": op[5:],
                                   "values": list(values)})
                    continue
                e = {"key": key, "operator": op}
                if values:
                    e["values"] = list(values)
                exprs.append(e)
            terms.append({"matchExpressions": exprs, "matchFields": fields})
        affinity["nodeAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": {
                "nodeSelectorTerms": terms}}
    spec = {
        "nodeName": pod.node_name,
        "priority": int(pod.priority),
        "containers": [{"name": "main", "resources": {"requests": {
            k: _quantity(k, v) for k, v in pod.requests.items()}}}],
        "tolerations": [{"key": t.key, "value": t.value,
                         "operator": t.operator, "effect": t.effect}
                        for t in pod.tolerations],
        "nodeSelector": dict(pod.node_selector),
    }
    if affinity:
        spec["affinity"] = affinity
    if pod.spread_constraints:
        spec["topologySpreadConstraints"] = [
            {"topologyKey": topo, "maxSkew": int(skew),
             "whenUnsatisfiable": "DoNotSchedule",
             "labelSelector": _selector(sel)}
            for topo, skew, sel in pod.spread_constraints
        ]
    return {
        "metadata": {
            "name": pod.name, "namespace": pod.namespace,
            "uid": uid or f"pod-{pod.namespace}-{pod.name}",
            "labels": labels, "annotations": dict(pod.annotations),
            "ownerReferences": [{"kind": r.kind, "name": r.name,
                                 "controller": bool(r.controller)}
                                for r in pod.owner_refs],
        },
        "spec": spec,
        "status": {"phase": pod.phase},
    }


def encode_pdb(pdb, uid: str = "") -> dict:
    """A PodDisruptionBudget API object that ``io/kube.decode_pdb`` reads
    back as ``pdb``: the match-nothing selector as a nil selector, the
    empty (select-all) one as ``{}``."""
    from k8s_spot_rescheduler_tpu_torch.predicates.selectors import (
        MATCH_NOTHING,
    )

    sel = pdb.match_labels
    selector = (None if tuple(sel) == MATCH_NOTHING
                else _selector(sel) if sel else {})
    return {
        "metadata": {"name": pdb.name, "namespace": pdb.namespace,
                     "uid": uid or f"pdb-{pdb.namespace}-{pdb.name}"},
        "spec": {"selector": selector},
        "status": {"disruptionsAllowed": int(pdb.disruptions_allowed)},
    }


_LIST_PATHS = {
    "/api/v1/nodes": "nodes",
    "/api/v1/pods": "pods",
    "/apis/policy/v1/poddisruptionbudgets": "pdbs",
}
_LEASES = "/apis/coordination.k8s.io/v1/namespaces/"


class _Server(ThreadingHTTPServer):
    # the drain's eviction fan-out opens up to 32 connections at once: a
    # listen backlog of socketserver's default 5 drops their SYNs, and
    # each dropped one waits out TCP's 1 s retransmission timeout
    request_queue_size = 128
    daemon_threads = True


class StubApiServer:
    """An API server stub on 127.0.0.1 over the objects it holds.

    LIST (nodes, pods, PDBs, and empty PVC/PV lists), WATCH from a
    resourceVersion (every event after it, from an event log with one
    global version counter, then new events as they come; an idle stream
    closes after ``watch_slice`` seconds, as a server's timeout does),
    pod and node GET, the eviction subresource (the pod is deleted at
    once, a DELETED event with a fresh version), merge-patched node taints
    (a MODIFIED event), events, and Lease GET/POST/PUT with
    resourceVersion compare-and-swap. ``expire()`` compacts the event
    log, so a watch from an older version gets 410 Gone and re-lists;
    ``bookmark`` sends a BOOKMARK. Evicted pods are not re-created: the
    stub has no scheduler."""

    def __init__(self, watch_slice: float = 0.25) -> None:
        self.watch_slice = float(watch_slice)
        self.objects = {"nodes": {}, "pods": {}, "pdbs": {}}
        # (resource, namespace, name) -> uid, for the GETs by name
        self._uids = {}
        self.rv = 10
        self.last_event_rv = {r: 0 for r in self.objects}
        self.log = {r: [] for r in self.objects}  # [(rv, event)]
        self.compacted = 0  # a watch from below this version gets 410
        self.evictions = []  # evicted pod UIDs (namespace/name)
        self.patches = []  # (node name, taints)
        self.events = []
        self.leases = {}
        self.list_count = {r: 0 for r in self.objects}
        self._cond = threading.Condition()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, obj, code=200):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self):
                length = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(length) or b"{}")

            def do_GET(self):
                parsed = urlparse(self.path)
                qs = parse_qs(parsed.query)
                resource = _LIST_PATHS.get(parsed.path)
                if resource is not None:
                    if qs.get("watch"):
                        since = int(qs.get("resourceVersion", ["0"])[0] or 0)
                        return self._watch(resource, since)
                    return self._send(stub._list(resource))
                if parsed.path in ("/api/v1/persistentvolumeclaims",
                                   "/api/v1/persistentvolumes"):
                    return self._send({"items": []})
                obj = stub._get(parsed.path)
                return self._send(obj or {"kind": "Status", "code": 404},
                                  200 if obj else 404)

            def _watch(self, resource, since):
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                sent = since
                while True:
                    with stub._cond:
                        if sent < stub.compacted:
                            events = [{"type": "ERROR", "object": {
                                "kind": "Status", "code": 410,
                                "reason": "Expired",
                                "message": "too old resource version"}}]
                        else:
                            events = [e for rv, e in stub.log[resource]
                                      if rv > sent]
                        if not events and not stub._cond.wait(
                                stub.watch_slice):
                            return  # idle: the server closes the stream
                    for event in events:
                        self.wfile.write((json.dumps(event) + "\n").encode())
                        if event["type"] == "ERROR":
                            self.wfile.flush()
                            return
                        sent = int(event["object"]["metadata"]
                                   ["resourceVersion"])
                    self.wfile.flush()

            def do_POST(self):
                body = self._body()
                if self.path.endswith("/eviction"):
                    ns = self.path.split("/namespaces/")[1].split("/")[0]
                    name = self.path.split("/pods/")[1].split("/")[0]
                    code = stub._evict(ns, name)
                    return self._send({"kind": "Status"}, code)
                if self.path.endswith("/events"):
                    stub.events.append(body)
                    return self._send(body, 201)
                if self.path.startswith(_LEASES) and \
                        self.path.endswith("/leases"):
                    code, obj = stub._lease_create(body)
                    return self._send(obj, code)
                return self._send({}, 404)

            def do_PUT(self):
                body = self._body()
                if self.path.startswith(_LEASES) and "/leases/" in self.path:
                    code, obj = stub._lease_update(body)
                    return self._send(obj, code)
                return self._send({}, 404)

            def do_PATCH(self):
                body = self._body()
                if self.path.startswith("/api/v1/nodes/"):
                    name = self.path.rsplit("/", 1)[1]
                    obj = stub._patch_node(name, body)
                    return self._send(obj or {}, 200 if obj else 404)
                return self._send({}, 404)

        self.server = _Server(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @classmethod
    def from_cluster(cls, client, **kw) -> "StubApiServer":
        """A stub serving a ``FakeCluster``'s nodes, pods and PDBs."""
        stub = cls(**kw)
        for node in client.nodes.values():
            stub.put("nodes", encode_node(node))
        for pod in client.pods.values():
            stub.put("pods", encode_pod(pod))
        for pdb in client.pdbs:
            stub.put("pdbs", encode_pdb(pdb))
        return stub

    @property
    def url(self) -> str:
        host, port = self.server.server_address
        return f"http://{host}:{port}"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)

    # --- state, under the condition's lock ---

    def _store(self, resource: str, obj: dict) -> None:
        meta = obj["metadata"]
        self.objects[resource][meta["uid"]] = obj
        self._uids[resource, meta.get("namespace", ""), meta["name"]] = (
            meta["uid"])

    def put(self, resource: str, obj: dict) -> None:
        """Add an object before any client lists (no event)."""
        with self._cond:
            self.rv += 1
            obj["metadata"]["resourceVersion"] = str(self.rv)
            self._store(resource, obj)

    def push(self, resource: str, etype: str, obj: dict) -> int:
        """Apply an ADDED/MODIFIED/DELETED change and send its event;
        returns its version."""
        with self._cond:
            self.rv += 1
            obj = dict(obj, metadata=dict(obj["metadata"],
                                          resourceVersion=str(self.rv)))
            meta = obj["metadata"]
            if etype == "DELETED":
                self.objects[resource].pop(meta["uid"], None)
                self._uids.pop(
                    (resource, meta.get("namespace", ""), meta["name"]), None)
            else:
                self._store(resource, obj)
            self.log[resource].append((self.rv, {"type": etype,
                                                 "object": obj}))
            self.last_event_rv[resource] = self.rv
            self._cond.notify_all()
            return self.rv

    def bookmark(self, resource: str) -> None:
        with self._cond:
            self.rv += 1
            self.log[resource].append((self.rv, {"type": "BOOKMARK",
                "object": {"metadata": {"resourceVersion": str(self.rv)}}}))
            self.last_event_rv[resource] = self.rv
            self._cond.notify_all()

    def expire(self) -> None:
        """Compact the event log: watches from any version up to now get
        410 Gone (and re-list)."""
        with self._cond:
            self.compacted = self.rv + 1
            for events in self.log.values():
                events.clear()
            self._cond.notify_all()

    def _list(self, resource: str) -> dict:
        with self._cond:
            self.list_count[resource] += 1
            return {"metadata": {"resourceVersion": str(self.rv)},
                    "items": list(self.objects[resource].values())}

    def _find(self, resource: str, name: str, ns: str = ""):
        uid = self._uids.get((resource, ns, name))
        return None if uid is None else self.objects[resource].get(uid)

    def _get(self, path: str):
        with self._cond:
            if path.startswith("/api/v1/namespaces/") and "/pods/" in path:
                ns = path.split("/namespaces/")[1].split("/")[0]
                return self._find("pods", path.rsplit("/", 1)[1], ns)
            if path.startswith("/api/v1/nodes/"):
                return self._find("nodes", path.rsplit("/", 1)[1])
            if path.startswith(_LEASES) and "/leases/" in path:
                return self.leases.get(path)
            return None

    def _evict(self, ns: str, name: str) -> int:
        with self._cond:
            obj = self._find("pods", name, ns)
            if obj is None:
                return 404
            self.evictions.append(f"{ns}/{name}")
        self.push("pods", "DELETED", obj)
        return 201

    def _patch_node(self, name: str, body: dict):
        with self._cond:
            obj = self._find("nodes", name)
            if obj is None:
                return None
            taints = body.get("spec", {}).get("taints", [])
            self.patches.append((name, taints))
            obj = dict(obj, spec=dict(obj["spec"], taints=taints))
        self.push("nodes", "MODIFIED", obj)
        return obj

    def _lease_path(self, meta: dict) -> str:
        return (f"{_LEASES}{meta.get('namespace', '')}/leases/"
                f"{meta.get('name', '')}")

    def _lease_create(self, body: dict):
        with self._cond:
            path = self._lease_path(body.get("metadata", {}))
            if path in self.leases:
                return 409, {"kind": "Status", "code": 409}
            self.rv += 1
            body["metadata"]["resourceVersion"] = str(self.rv)
            self.leases[path] = body
            return 201, body

    def _lease_update(self, body: dict):
        with self._cond:
            path = self._lease_path(body.get("metadata", {}))
            cur = self.leases.get(path)
            if cur is None:
                return 404, {"kind": "Status", "code": 404}
            if body["metadata"].get("resourceVersion") != \
                    cur["metadata"]["resourceVersion"]:
                return 409, {"kind": "Status", "code": 409}
            self.rv += 1
            body["metadata"]["resourceVersion"] = str(self.rv)
            self.leases[path] = body
            return 200, body


class MirrorTracker:
    """Follows the versions a ``WatchingKubeClusterClient``'s watchers
    have applied (either package's: it wraps each watcher's ``_relist``
    and ``_apply``; attach before the stub sends its first event).
    ``wait(stub)`` returns once every resource's mirror holds the last
    event the stub sent, so a tick frozen after it sees the previous
    tick's evictions and taints."""

    def __init__(self, watching) -> None:
        self._cond = threading.Condition()
        self.applied = {}
        for w in watching._watchers:
            resource = _LIST_PATHS[w.list_path]
            relist, apply = w._relist, w._apply

            def _relist(_relist=relist, _r=resource):
                rv = _relist()
                self._note(_r, rv)
                return rv

            def _apply(event, rv, _apply=apply, _r=resource):
                out = _apply(event, rv)
                self._note(_r, out)
                return out

            w._relist, w._apply = _relist, _apply

    def _note(self, resource: str, rv) -> None:
        with self._cond:
            self.applied[resource] = max(self.applied.get(resource, 0),
                                         int(rv or 0))
            self._cond.notify_all()

    def wait(self, stub: StubApiServer, timeout: float = 60.0) -> None:
        want = dict(stub.last_event_rv)
        deadline = time.monotonic() + timeout
        with self._cond:
            while any(self.applied.get(r, 0) < v for r, v in want.items()):
                left = deadline - time.monotonic()
                if left <= 0 or not self._cond.wait(left):
                    raise TimeoutError(
                        f"watch mirror at {self.applied}, the server at {want}"
                    )


def run_kube_ticks(rescheduler, stub: StubApiServer,
                   tracker: MirrorTracker | None, clock, ticks: int) -> list:
    """``run_ticks`` through a ``StubApiServer``: before each tick the
    virtual ``clock`` sleeps the effective interval and a watch mirror
    catches up with every event the stub sent (``MirrorTracker.wait``;
    ``tracker`` None for the polling client, which LISTs afresh each
    tick); the evicted pod UIDs are the stub's."""
    out = []
    for _ in range(ticks):
        clock.sleep(rescheduler.effective_interval())
        if tracker is not None:
            tracker.wait(stub)
        seen = len(stub.evictions)
        res = rescheduler.tick()
        out.append({
            "drained": list(res.drained),
            "evicted": sorted(stub.evictions[seen:]),
            "skipped": res.skipped,
            "planner_fallback": bool(res.planner_fallback),
        })
    return out


def track_observations(planner) -> list:
    """Wrap ``planner._pack_observation`` (either package's planner:
    every plan, schedule cut and schedule step packs through it) and
    return the list it appends each observation's class name to, so a
    run can assert which observe path it planned from."""
    seen = []
    pack = planner._pack_observation

    def _pack(observation, pdbs):
        seen.append(type(observation).__name__)
        return pack(observation, pdbs)

    planner._pack_observation = _pack
    return seen


def run_kube(stub: StubApiServer, ticks: int, *, kube_cls, start_watching,
             clock, make_rescheduler, on_ready=None) -> list:
    """One controller run through ``stub`` (either package's classes):
    ``start_watching(kube_cls(stub.url))`` returns the started watch
    client (the CLI's ``start_watch_client``, say) before the stub sees
    any event, ``on_ready(watching)`` runs after the seed, then
    ``make_rescheduler(watching)`` is driven by ``run_kube_ticks`` on the
    virtual ``clock``. The watchers stop at the end."""
    watching = start_watching(kube_cls(stub.url))
    try:
        tracker = MirrorTracker(watching)
        if on_ready is not None:
            on_ready(watching)
        return run_kube_ticks(make_rescheduler(watching), stub, tracker,
                              clock, ticks)
    finally:
        stop = getattr(watching, "stop", None)
        if stop is not None:
            stop()

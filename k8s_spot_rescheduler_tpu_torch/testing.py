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
``run_ticks`` drive a controller over a synthetic cluster tick by tick
and record what each tick did. They are duck-typed over the package, so
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

import numpy as np

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

# (name, synthetic config, ticks, schedule_horizon): the controller runs
# frozen from the JAX package and checked on the card, each from a fresh
# ``generate_cluster(CONFIGS[config], seed, reschedule_evicted=True)``
CONTROLLER_RUNS = (
    ("config3", 3, 5, 32),
    ("config3-horizon0", 3, 3, 0),
    ("config4", 4, 3, 32),
)
# the CLI run: ``--cluster synthetic:1`` with these flags
CLI_ARGS = ("--cluster", "synthetic:1", "--ticks", "3", "--no-metrics-server",
            "--node-drain-delay", "1s")
TICKS_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data", "ticks_seed0.json"
)


def controller_config(config_cls, spec, horizon: int):
    """The controller runs' configuration, of either package's
    ``ReschedulerConfig`` class: the spec's resources, a 1 s drain delay
    (a drain each 10 s tick), the object observe path and ``horizon``
    (0 = schedules off). Only the JAX package's class has
    ``use_columnar``: the port always observes through objects."""
    kw = {}
    if "use_columnar" in {f.name for f in dataclasses.fields(config_cls)}:
        kw["use_columnar"] = False
    return config_cls(
        node_drain_delay=1.0,
        resources=tuple(spec.resources),
        schedule_horizon=horizon,
        **kw,
    )


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
    out = []
    for _ in range(ticks):
        client.clock.sleep(rescheduler.effective_interval())
        seen = len(client.evictions)
        res = rescheduler.tick()
        out.append({
            "drained": list(res.drained),
            "evicted": sorted(client.evictions[seen:]),
            "skipped": res.skipped,
            "planner_fallback": bool(res.planner_fallback),
        })
    return out


def load_ticks(path: str | None = None) -> dict:
    """The frozen controller runs (``tests/torch_port_fixtures.py
    ticks``), from ``TICKS_PATH`` by default."""
    with open(path or TICKS_PATH) as f:
        return json.load(f)

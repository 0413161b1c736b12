"""``--replay-device-only``: the device-only cost of a constrained-replay
tick where best-fit and repair fire.

The port of the root ``bench.py``'s ``run_replay_device_only`` and
``_replay_device_protocol``. The host half replays the constrained
stream (``bench/replay.run_replay(constrained=True)``) with the numpy
oracle planner (``solver="numpy"``: no device is touched) and keeps, by
the reference's rule, the tick whose valid lanes the greedy passes leave
unproven most often, a tick where repair fires before one where only
best-fit does. The device half moves that tick to ``device`` once and
runs the pinned chain protocol (``bench/protocol.run_protocol``, CUDA
events on the card) on the shipped union with its selection
(``union_program(rounds, True, use_kernel=True)``: first-fit and
best-fit as kernels B1/B2 on the card, then repair).

``--harvest-cache PATH`` stores the harvested tick, or reuses it when the
file exists, in the reference's ``.npz`` layout (the PackedCluster
fields, ``unproven``, ``bf_only``, ``replay_p50_ms``, ``replay_p99_ms``;
a path without the ``.npz`` suffix gets it, as ``np.savez`` would add
it), so a cache written by either package loads in the other.
"""

from __future__ import annotations

import os
import time

import numpy as np

from k8s_spot_rescheduler_tpu_torch.models.tensors import (
    PackedCluster,
    load_npz,
)

NO_TICK_ERROR = ("no replay tick left a valid lane greedy-unproven "
                 "(best-fit/repair never fired this seed)")


def cache_path(path: str) -> str:
    """``path`` with the ``.npz`` suffix ``np.savez`` gives it ("" stays
    "")."""
    if path and not path.endswith(".npz"):
        return path + ".npz"
    return path


def harvest_tick(n_events: int, seed: int = 0):
    """Replay the constrained stream on the numpy oracle planner and
    return (harvest, replay stats): ``harvest`` holds ``packed`` (the
    host pack of the tick kept, or None when no tick left a valid lane
    greedy-unproven), ``unproven`` (its valid lanes first-fit left
    unproven plus those best-fit left unproven too) and ``bf_only``
    (True when best-fit proves every lane first-fit missed)."""
    from k8s_spot_rescheduler_tpu_torch.bench.replay import run_replay
    from k8s_spot_rescheduler_tpu_torch.solver.numpy_oracle import plan_oracle
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    harvest = {"packed": None, "unproven": -1, "bf_only": True,
               "last_id": None}

    def tap(packed):
        if packed is None or id(packed) == harvest["last_id"]:
            return  # skipped ticks repeat the previous object
        harvest["last_id"] = id(packed)
        valid = np.asarray(packed.cand_valid)
        miss_ff = valid & ~np.asarray(plan_oracle(packed).feasible)
        if not miss_ff.any():
            return  # greedy proves everything: neither pass fires
        bf = plan_oracle(packed, best_fit=True)
        n = int((miss_ff & ~np.asarray(bf.feasible)).sum())
        bf_only = n == 0
        # prefer repair-firing ticks over bf-only ticks, then max lanes
        better = (
            (harvest["bf_only"] and not bf_only)
            or (harvest["bf_only"] == bf_only
                and n + int(miss_ff.sum()) > harvest["unproven"])
        )
        if harvest["packed"] is None or better:
            harvest.update(packed=packed, unproven=n + int(miss_ff.sum()),
                           bf_only=bf_only)

    stats = run_replay(ReschedulerConfig(solver="numpy"), n_events=n_events,
                       seed=seed, constrained=True, on_packed=tap)
    harvest.pop("last_id")
    return harvest, stats


def save_harvest(path: str, harvest: dict, stats: dict) -> str:
    """Write the harvested tick in the reference's cache layout; returns
    the path written."""
    path = cache_path(path)
    packed = harvest["packed"]
    np.savez_compressed(
        path,
        unproven=harvest["unproven"],
        bf_only=harvest["bf_only"],
        replay_p50_ms=stats["replan_ms_p50"],
        replay_p99_ms=stats["replan_ms_p99"],
        **{f: np.asarray(getattr(packed, f)) for f in PackedCluster._fields},
    )
    return path


def load_harvest(path: str):
    """(harvest, replay stats) from a cache ``save_harvest`` (or the
    reference) wrote."""
    packed, extra = load_npz(cache_path(path))
    harvest = {"packed": packed, "unproven": int(extra["unproven"]),
               "bf_only": bool(extra["bf_only"])}
    stats = {"replan_ms_p50": float(extra["replay_p50_ms"]),
             "replan_ms_p99": float(extra["replay_p99_ms"])}
    return harvest, stats


def run_replay_device_only(args, device, metric: str, unit: str) -> tuple:
    """The mode: harvest (or load ``args.harvest_cache``), then
    ``replay_device_protocol``. With no tick to harvest, the reference's
    error row and exit code 1."""
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import progress

    cache = cache_path(args.harvest_cache)
    if cache and os.path.exists(cache):
        harvest, stats = load_harvest(cache)
        progress(f"reusing harvested tick from {cache}")
        return replay_device_protocol(harvest, stats, device, metric, unit)
    t0 = time.perf_counter()
    harvest, stats = harvest_tick(args.events, args.seed)
    progress(f"constrained replay of {args.events} events on the numpy "
             f"oracle: {time.perf_counter() - t0:.1f} s")
    if harvest["packed"] is None:
        return 1, {"metric": metric, "value": None, "unit": unit,
                   "vs_baseline": None, "error": NO_TICK_ERROR}
    if cache:
        progress(f"harvested tick cached at {save_harvest(cache, harvest, stats)}")
    return replay_device_protocol(harvest, stats, device, metric, unit)


def replay_device_protocol(harvest, stats, device, metric: str,
                           unit: str) -> tuple:
    """The device half: the shipped fused union on the harvested tick,
    moved to ``device`` once; the first call (it builds the kernels
    where they are not built yet), then the pinned chain protocol."""
    from k8s_spot_rescheduler_tpu_torch.bench import protocol
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import (
        TARGET_MS,
        _synced,
        progress,
    )
    from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
    from k8s_spot_rescheduler_tpu_torch.solver.fallback import union_program
    from k8s_spot_rescheduler_tpu_torch.solver.select import (
        decode_selection,
        make_fused_planner,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    packed = harvest["packed"]
    C, K, R = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    note = (
        "best-fit fires, repair gated off (greedy union proves all)"
        if harvest["bf_only"]
        else "best-fit AND repair fire"
    )
    progress(f"harvested constrained-replay tick: C={C} K={K} S={S} R={R}; "
             f"{harvest['unproven']} greedy-unproven valid lanes ({note}); "
             f"replay p50 {stats['replan_ms_p50']:.1f} ms p99 "
             f"{stats['replan_ms_p99']:.1f} ms on the host")
    shipped = ReschedulerConfig()
    fused = make_fused_planner(union_program(
        shipped.repair_rounds, shipped.fallback_best_fit, use_kernel=True))
    device_packed = to_device(packed, device)
    _synced(device)
    t0 = time.perf_counter()
    sel = decode_selection(fused(device_packed))
    first_s = time.perf_counter() - t0
    rec = protocol.run_protocol(fused, device_packed)
    device_ms = rec["device_only_ms"]
    progress(f"first call {first_s:.2f} s  device-only {device_ms} ms/solve "
             f"on the harvested tick ({note}); feasible {sel.n_feasible} "
             f"lanes, first={sel.index}  device {device}")
    return 0, {
        "metric": metric,
        "value": round(device_ms, 3),
        "unit": unit,
        "vs_baseline": round(TARGET_MS / device_ms, 1) if device_ms else None,
        "device": str(device),
        "device_only": rec,
        "first_call_s": round(first_s, 3),
        "tick_shape": {"C": int(C), "K": int(K), "S": int(S), "R": int(R)},
        "note": note,
        "unproven": int(harvest["unproven"]),
        "bf_only": bool(harvest["bf_only"]),
        "feasible": int(sel.n_feasible),
        "selection": [int(sel.index), int(sel.found), int(sel.n_feasible),
                      *(int(v) for v in sel.row)],
        "replay_p50_ms_host": round(stats["replan_ms_p50"], 3),
        "replay_p99_ms_host": round(stats["replan_ms_p99"], 3),
    }

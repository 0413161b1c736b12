"""``--scale-smoke``: the shape-only proof of the dispatch ladder at 20x.

The port of the root ``bench.py``'s ``run_scale_smoke``. At the
1M-pod / 100k-node shapes (``MAX_SHAPES``, the JAX package's
``hot_programs.MAX_SHAPES``) over an 8-device fleet at the JAX
package's default budget (``DEFAULT_HBM_BYTES * BUDGET_FRACTION``), for
the fully narrow carry layout and the conservative guarded one (f32
``used``, int8 count, uint8 aff), it checks without solving anything:

1. the ladder (``solver/memory.pick_tier``, the decision the planner
   runs) keeps repair live (``repair_unavailable`` 0, ``repair_chunks``
   > 0) on a tier whose estimate fits the budget;
2. the estimator's breakdown sums to the tier's estimate, its carries
   term is the tier's ``carry_bytes``, and the carries dominate;
3. kernels B3 and B4 have a launch geometry at the per-device lane
   block under each dispatched layout and chunk count
   (``ops/ffd_kernels.launch_geometry`` on the H100's shared memory; no
   device is touched). The reference traces the lane-block program to a
   jaxpr here; its ``trace_ms``/``trace_eqns`` keys become
   ``geometry_ms`` and ``geometry`` (per layout, B3's and B4's).

Metric ``scale_smoke_20x_shape_proof_s``: the mode's wall seconds. The
other numbers equal the reference's run.
"""

from __future__ import annotations

import time

from k8s_spot_rescheduler_tpu_torch.solver.carry import (
    NARROW_LAYOUT,
    CarryLayout,
)

# (C, K, S, R, W, A) at 20x config 3: 1M pods over 100k nodes
MAX_SHAPES = (51_200, 32, 51_200, 4, 2, 2)
N_DEVICES = 8  # the fleet the 20x deployment targets
GUARDED_LAYOUT = CarryLayout(used="float32", count="int8", aff="uint8")
LAYOUTS = (("narrow", NARROW_LAYOUT), ("guarded", GUARDED_LAYOUT))


def _fail(metric: str, unit: str, error: str) -> tuple:
    return 1, {"metric": metric, "value": None, "unit": unit,
               "vs_baseline": None, "error": error[-600:]}


def lane_block_geometry(tier, layout) -> dict:
    """B3's (first-fit over chunks of ceil(S / carry_chunks) spots) and
    B4's (best-fit over the narrow carry ``layout``) launch geometry at
    the tier's lane block, as ``FfdGeometry`` dicts."""
    from k8s_spot_rescheduler_tpu_torch.ops import ffd_kernels as fk

    C, K, S, R, W, A = MAX_SHAPES
    chunk = -(-S // max(1, tier.carry_chunks))
    lane = tier.lane_block
    return {
        "B3": fk.launch_geometry(lane, K, chunk, R, W, A,
                                 fk.H100_SMEM_LIMIT, False)._asdict(),
        "B4": fk.launch_geometry(lane, K, S, R, W, A, fk.H100_SMEM_LIMIT,
                                 True, layout=layout)._asdict(),
    }


def run_scale_smoke(args, device, metric: str, unit: str) -> tuple:
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import progress
    from k8s_spot_rescheduler_tpu_torch.ops import ffd_kernels as fk
    from k8s_spot_rescheduler_tpu_torch.solver import memory
    from k8s_spot_rescheduler_tpu_torch.solver.carry import plane_bytes

    t0 = time.perf_counter()
    C, K, S, R, W, A = MAX_SHAPES
    budget = int(memory.DEFAULT_HBM_BYTES * memory.BUDGET_FRACTION)
    tiers = {}
    for name, layout in LAYOUTS:
        tier = memory.pick_tier(
            C, K, S, R, W, A,
            n_devices=N_DEVICES,
            budget_bytes=budget,
            wants_repair=True,
            carry_plane_bytes=plane_bytes(layout, R, A),
        )
        tiers[name] = tier
        progress(
            f"scale-smoke dispatch [{name}]: {tier.kind} "
            f"repair_chunks={tier.repair_chunks} "
            f"carry_chunks={tier.carry_chunks} "
            f"est {tier.est_bytes / 1e9:.2f} GB/device "
            f"(carries {tier.carry_bytes / 1e9:.2f} GB) vs budget "
            f"{budget / 1e9:.2f} GB"
        )
        if tier.repair_unavailable or tier.repair_chunks <= 0:
            return _fail(metric, unit,
                         f"20x dispatch [{name}] lost the repair phase: {tier}")
        if tier.est_bytes > budget:
            return _fail(metric, unit,
                         f"20x dispatch [{name}] exceeds the per-device "
                         f"budget: {tier.est_bytes} > {budget}")
    tier = tiers["guarded"]  # what --scale 20 on config 3 dispatches
    bd = memory.estimate_union_hbm_breakdown(
        tier.lane_block, K, S, R, W, A,
        repair_spot_chunks=tier.repair_chunks,
        carry_chunks=tier.carry_chunks,
        carry_plane_bytes=plane_bytes(GUARDED_LAYOUT, R, A),
    )
    if sum(bd.values()) != tier.est_bytes or bd["carries"] != tier.carry_bytes:
        return _fail(metric, unit,
                     f"estimator breakdown disagrees with the tier decision: "
                     f"{bd} vs {tier}")
    if bd["carries"] <= max(v for k, v in bd.items() if k != "carries"):
        return _fail(metric, unit,
                     f"carries no longer dominate the 20x estimate: {bd}")

    t_geo = time.perf_counter()
    geometry = {}
    for name, layout in LAYOUTS:
        geo = geometry[name] = lane_block_geometry(tiers[name], layout)
        for kernel, g in geo.items():
            if g["lanes_per_block"] < 1 or g["smem_bytes"] > fk.H100_SMEM_LIMIT:
                return _fail(metric, unit,
                             f"20x lane block [{name}]: {kernel} has no "
                             f"launch geometry: {g}")
        progress(
            f"scale-smoke geometry [{name}]: lane block "
            f"C={tiers[name].lane_block} S={S} "
            f"carry_chunks={tiers[name].carry_chunks} layout "
            f"{layout.used}/{layout.count}/{layout.aff} -> B3 "
            f"{geo['B3']['lanes_per_block']} lanes x "
            f"{geo['B3']['warps_per_lane']} warps, {geo['B3']['smem_bytes']} "
            f"B; B4 {geo['B4']['lanes_per_block']} lanes x "
            f"{geo['B4']['warps_per_lane']} warps, {geo['B4']['smem_bytes']} B"
        )
    geometry_ms = (time.perf_counter() - t_geo) * 1e3
    return 0, {
        "metric": metric,
        "value": round(time.perf_counter() - t0, 3),
        "unit": unit,
        "carry_chunks": int(tier.carry_chunks),
        "carry_bytes": int(tier.carry_bytes),
        "repair_chunks": int(tier.repair_chunks),
        "repair_unavailable": 0,
        "narrow_carry_chunks": int(tiers["narrow"].carry_chunks),
        "lane_block": int(tier.lane_block),
        "est_device_gb": round(tier.est_bytes / 1e9, 3),
        "budget_gb": round(budget / 1e9, 3),
        "breakdown_mb": {
            k: round(v / 1e6, 1) for k, v in sorted(bd.items())
        },
        "geometry_ms": round(geometry_ms, 3),
        "geometry": geometry,
    }

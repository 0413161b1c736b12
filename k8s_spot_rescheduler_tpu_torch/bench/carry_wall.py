"""``--carry-wall``: the wall clock of the carry-streamed union.

The port of the root ``bench.py``'s ``run_carry_wall``. It runs the
union the dispatch ladder keeps repair live on past the wide carry bound
(``solver/fallback.with_repair_streamed`` on the pack's narrow carry
layout, repair included) at ``--config`` x ``--scale`` on ``device``:
first-fit as kernel B3 over the spot chunks (B1 for one chunk), best-fit
as B4 with the narrow delta carry, then the spot-chunked repair where
the greedy passes leave a valid lane unproven.

``--carry-chunks N`` pins the chunk count; without it the count is the
ladder's verdict at the 20x north star (``solver/memory.pick_tier`` over
8 devices at the default budget, this run's C and S projected to 20x),
as the reference takes it. The pack is moved to the device once; the
first call (which builds the kernels where they are not built yet) is
``compile_s``, then the median wall of ``--repeats`` synchronised calls.
The reference passes host arrays to its jitted union, so its wall also
holds the upload; this one is the solve on resident tensors, the number
a resident service batch pays. ``twin_calibration`` keys that wall by
the planner service's bucket (``service/buckets.bucket_for``), the table
the fleet twin's calibration reads.
"""

from __future__ import annotations

import time

import numpy as np


def ladder_chunks(shapes, layout, scale: float) -> int:
    """The carry chunk count the ladder dispatches at 20x: this run's C
    and S projected back to 1x and out to 20x (K, R, W, A are per-lane
    plane widths), over 8 devices at the default budget; 16 where the
    verdict has no carry tier."""
    from k8s_spot_rescheduler_tpu_torch.solver import carry as solver_carry
    from k8s_spot_rescheduler_tpu_torch.solver import memory as solver_memory

    C, K, S, R, W, A = shapes
    f = 20.0 / max(scale, 1e-9)
    tier20 = solver_memory.pick_tier(
        int(C * f), K, int(S * f), R, W, A,
        n_devices=8,
        budget_bytes=None,
        wants_repair=True,
        carry_plane_bytes=solver_carry.plane_bytes(layout, R, A),
    )
    return max(1, int(tier20.carry_chunks) or 16)


def run_carry_wall(args, device, metric: str, unit: str) -> tuple:
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import (
        _synced,
        build_problem,
        progress,
        scaled_spec,
    )
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import CONFIGS
    from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
    from k8s_spot_rescheduler_tpu_torch.service import buckets
    from k8s_spot_rescheduler_tpu_torch.solver import carry as solver_carry
    from k8s_spot_rescheduler_tpu_torch.solver import memory as solver_memory
    from k8s_spot_rescheduler_tpu_torch.solver.fallback import (
        with_repair_streamed,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.repair import DEFAULT_ROUNDS

    spec = scaled_spec(CONFIGS[args.config], args.scale)
    packed = build_problem(spec, args.seed)[0]
    layout = solver_carry.carry_layout(packed)
    shapes = solver_memory.packed_shapes(packed)
    chunks = (args.carry_chunks if args.carry_chunks > 0
              else ladder_chunks(shapes, layout, args.scale))
    union = with_repair_streamed(DEFAULT_ROUNDS, chunks, layout,
                                 use_kernel=True)
    device_packed = to_device(packed, device)
    _synced(device)
    t0 = time.perf_counter()
    out = union(device_packed)
    _synced(device)
    compile_s = time.perf_counter() - t0
    walls = []
    for _ in range(max(1, args.repeats)):
        t1 = time.perf_counter()
        out = union(device_packed)
        _synced(device)
        walls.append((time.perf_counter() - t1) * 1e3)
    wall_ms = float(np.median(walls))
    feas = int(out.feasible.sum())
    lanes = int(np.asarray(packed.cand_valid).sum())
    bucket = buckets.bucket_for(packed)
    progress(
        f"carry-wall: config {args.config} x{args.scale:g} C={shapes[0]} "
        f"S={shapes[2]} carry_chunks={chunks} layout "
        f"{layout.used}/{layout.count}/{layout.aff}  first call "
        f"{compile_s:.2f}s  union wall median {wall_ms:.3f} ms over "
        f"{len(walls)} runs ({feas}/{lanes} valid lanes feasible)"
    )
    return 0, {
        "metric": metric,
        "value": round(wall_ms, 3),
        "unit": unit,
        "config": args.config,
        "scale": args.scale,
        "carry_chunks": int(chunks),
        "carry_layout": list(layout),
        "carry_plane_bytes": solver_carry.plane_bytes(
            layout, shapes[3], shapes[5]
        ),
        "compile_s": round(compile_s, 3),
        "repeats": len(walls),
        "wall_ms_min": round(min(walls), 3),
        "feasible_lanes": feas,
        "valid_lanes": lanes,
        "bucket": bucket.key,
        "twin_calibration": {bucket.key: {"solve_s": round(wall_ms / 1e3, 6)}},
    }

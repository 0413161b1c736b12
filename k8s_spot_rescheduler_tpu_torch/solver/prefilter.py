"""Cheap, sound per-lane infeasibility bound (the staged-solve gate).

The port of the JAX package's ``solver/prefilter.lane_maybe_feasible``.
A lane whose aggregate evictable demand exceeds the spot pool's
aggregate headroom in any resource, or whose pod count exceeds the
pool's free pod slots, can never pack, so the staged planner may skip
it. The f32 sums may round in another order than the reference's; the
relative margin covers that, and a verdict only decides which lanes are
solved, never a selection.
"""

from __future__ import annotations

import torch

# relative slack covering worst-case naive-f32-summation error
REL_MARGIN = 1.0 / 128.0


def lane_maybe_feasible(packed) -> torch.Tensor:
    """bool [C]: False = lane provably infeasible (skippable); True =
    undecided (must be solved)."""
    valid = packed.slot_valid
    demand = (packed.slot_req * valid[..., None]).sum(dim=1)  # f32 [C, R]
    n_slots = valid.sum(dim=1)  # [C]

    ok = packed.spot_ok
    headroom = (packed.spot_free.clamp(min=0.0) * ok[:, None]).sum(dim=0)
    free_slots = (
        (packed.spot_max_pods - packed.spot_count).clamp(min=0) * ok
    ).sum()  # scalar, integer math: exact

    over_capacity = (
        demand > headroom[None, :] * (1.0 + REL_MARGIN) + 1.0
    ).any(dim=1)
    over_slots = n_slots > free_slots
    return packed.cand_valid & ~(over_capacity | over_slots)

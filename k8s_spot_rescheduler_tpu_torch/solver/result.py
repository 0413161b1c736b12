"""Solver result container."""

from __future__ import annotations

from typing import NamedTuple


class SolveResult(NamedTuple):
    """Per-candidate drain feasibility.

    ``feasible[c]`` (bool [C]): every evictable pod of candidate c fits
    onto the spot pool. ``assignment[c, k]`` (int32 [C, K]): spot index
    receiving slot k, -1 for unplaced or invalid slots and for every
    slot of an infeasible lane.
    """

    feasible: object  # bool [C]
    assignment: object  # int32 [C, K]

"""Device-side plan selection.

The port of the JAX package's ``solver/select.py``. The loop drains the
first feasible candidate in drain-priority order, so a solve is reduced
on the device to ONE int32 vector ``[idx, found, n_feasible, row...]``
and the host fetches only that.

``StagedPlanner`` walks the candidate lanes in selection order in
chunks of ``chunk_lanes``: chunks the prefilter (``solver/prefilter``)
proves infeasible are skipped, the rest are solved with the same union
program sliced to the chunk's lanes (lanes are independent forks, so
slicing changes no verdict), and with ``early_exit`` solving stops at
the first chunk holding a feasible lane. (index, found, row) are
bit-identical to the unstaged planner always; ``n_feasible`` is the
solved prefix's count when early exit fired (``count_truncated``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from k8s_spot_rescheduler_tpu_torch.solver.ffd import first_true


class Selection(NamedTuple):
    index: int  # first feasible candidate lane (drain-priority order)
    found: bool
    n_feasible: int
    row: np.ndarray  # int32 [K] spot assignment of that lane


def selection_vector(solve_fn, packed) -> torch.Tensor:
    """Solve + select on the device: int32 [3 + K]."""
    res = solve_fn(packed)
    feasible = res.feasible
    # candidates are pre-sorted least-requested-first: the first True of
    # the mask IS the reference's drain choice
    idx = first_true(feasible)
    return torch.cat(
        [
            idx.reshape(1).to(torch.int32),
            feasible.any().reshape(1).to(torch.int32),
            feasible.sum().reshape(1).to(torch.int32),
            res.assignment[idx].to(torch.int32),
        ]
    )


def make_fused_planner(solve_fn):
    """A PackedCluster -> int32 [3 + K] selection function over the
    union ``solve_fn``; decode with ``decode_selection``."""

    def fused(packed):
        return selection_vector(solve_fn, packed)

    return fused


def decode_selection(vec) -> Selection:
    """One host fetch, then unpack."""
    if isinstance(vec, torch.Tensor):
        vec = vec.cpu().numpy()
    vec = np.asarray(vec)
    return Selection(
        index=int(vec[0]),
        found=bool(vec[1]),
        n_feasible=int(vec[2]),
        row=vec[3:],
    )


class StagedStats(NamedTuple):
    """Staged-solve coverage bookkeeping for one tick."""

    chunks_solved: int
    chunks_skipped: int  # prefilter-eliminated + early-exit-bypassed
    lanes_eliminated: int  # prefilter verdicts, lane granularity
    count_truncated: bool  # early exit fired: n_feasible is a prefix count


def _lane_slice(packed, start: int, size: int):
    sl = slice(start, start + size)
    return packed._replace(
        slot_req=packed.slot_req[sl],
        slot_valid=packed.slot_valid[sl],
        slot_tol=packed.slot_tol[sl],
        slot_aff=packed.slot_aff[sl],
        cand_valid=packed.cand_valid[sl],
    )


class StagedPlanner:
    """Chunked, early-exiting selection over the candidate axis."""

    def __init__(self, solve_fn, *, chunk_lanes: int = 256,
                 early_exit: bool = True):
        from k8s_spot_rescheduler_tpu_torch.solver.prefilter import (
            lane_maybe_feasible,
        )

        self.solve_fn = solve_fn
        self.chunk_lanes = max(1, int(chunk_lanes))
        self.early_exit = early_exit
        self._prefilter = lane_maybe_feasible

    def solve(self, packed):
        """(Selection, StagedStats). Host syncs: the prefilter verdict,
        then one selection fetch per solved chunk (plus the union's own
        gates)."""
        C, K = packed.slot_req.shape[:2]
        maybe = self._prefilter(packed).cpu().numpy()  # C bools
        chunk = self.chunk_lanes
        starts = list(range(0, C, chunk))
        runnable = [s for s in starts if maybe[s : s + chunk].any()]
        solved = 0
        n_feasible = 0
        found_idx = -1
        row = np.full(K, -1, np.int32)
        for start in runnable:
            size = min(chunk, C - start)
            vec = selection_vector(
                self.solve_fn, _lane_slice(packed, start, size)
            ).cpu().numpy()
            solved += 1
            n_feasible += int(vec[2])
            if found_idx < 0 and vec[1]:
                found_idx = start + int(vec[0])
                row = vec[3:]
                if self.early_exit:
                    break
        sel = Selection(
            index=found_idx if found_idx >= 0 else 0,
            found=found_idx >= 0,
            n_feasible=n_feasible,
            row=row,
        )
        stats = StagedStats(
            chunks_solved=solved,
            chunks_skipped=len(starts) - solved,
            lanes_eliminated=int((~maybe).sum()),
            count_truncated=found_idx >= 0 and solved < len(runnable),
        )
        return sel, stats

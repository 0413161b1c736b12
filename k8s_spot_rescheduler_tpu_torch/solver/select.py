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

import collections
from typing import NamedTuple

import numpy as np
import torch

from k8s_spot_rescheduler_tpu_torch.solver.ffd import first_true
from k8s_spot_rescheduler_tpu_torch.utils.syncs import device_sync


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
    # the lane's row is taken at a host index: a 0-dim device index
    # reads itself to the host where it is used
    row = res.assignment[device_sync("lane", int, idx)]
    return torch.cat(
        [
            idx.reshape(1).to(torch.int32),
            feasible.any().reshape(1).to(torch.int32),
            feasible.sum().reshape(1).to(torch.int32),
            row.to(torch.int32),
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
        vec = device_sync("selection", torch.Tensor.cpu, vec).numpy()
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
    """Chunked, early-exiting selection over the candidate axis,
    pipelined as the reference's: ``start`` fetches the prefilter
    verdict and dispatches the first runnable chunk, ``finish_run``
    dispatches chunk i+1 before it fetches chunk i."""

    def __init__(self, solve_fn, *, chunk_lanes: int = 256,
                 early_exit: bool = True):
        from k8s_spot_rescheduler_tpu_torch.solver.prefilter import (
            lane_maybe_feasible,
        )

        self.solve_fn = solve_fn
        self.chunk_lanes = max(1, int(chunk_lanes))
        self.early_exit = early_exit
        self._prefilter = lane_maybe_feasible

    def dispatch_prefilter(self, packed) -> torch.Tensor:
        """Dispatch the per-lane bound; hand the result to
        ``start``/``solve`` so host work overlaps the device prefilter."""
        return self._prefilter(packed)

    def start(self, packed, maybe=None) -> dict:
        """Fetch the (tiny) prefilter verdict, decide the runnable chunk
        list and dispatch the first chunk: the device is already solving
        while the caller does host work before ``finish_run``."""
        C = packed.slot_req.shape[0]
        if maybe is None:
            maybe = self.dispatch_prefilter(packed)
        if isinstance(maybe, torch.Tensor):
            maybe = device_sync(  # C bools
                "prefilter", torch.Tensor.cpu, maybe
            ).numpy()
        maybe = np.asarray(maybe)
        chunk = self.chunk_lanes
        starts = list(range(0, C, chunk))
        run = {
            "packed": packed,
            "C": C,
            "K": packed.slot_req.shape[1],
            "runnable": [s for s in starts if maybe[s : s + chunk].any()],
            "n_chunks": len(starts),
            "eliminated": int((~maybe).sum()),
            "pending": collections.deque(),  # dispatched, not yet fetched
            "next": 0,
        }
        self._dispatch_next(run)
        return run

    def _dispatch_next(self, run) -> None:
        i = run["next"]
        if i < len(run["runnable"]):
            start = run["runnable"][i]
            size = min(self.chunk_lanes, run["C"] - start)
            run["pending"].append(
                (
                    start,
                    selection_vector(
                        self.solve_fn, _lane_slice(run["packed"], start, size)
                    ),
                )
            )
            run["next"] = i + 1

    def finish_run(self, run):
        """Drain the chunk pipeline; returns (Selection, StagedStats).

        Chunks are fetched in selection order with pipeline depth 2:
        chunk i+1 is dispatched before the fetch of chunk i blocks, so
        the fetch's round trip hides behind the next chunk's work. Early
        exit costs at most the one chunk dispatched ahead. Host syncs:
        one selection fetch per fetched chunk (plus the union's own
        gates)."""
        fetched = 0
        n_feasible = 0
        found_idx = -1
        row = np.full(run["K"], -1, np.int32)
        while run["pending"]:
            self._dispatch_next(run)
            start, pending_vec = run["pending"].popleft()
            vec = device_sync(
                "selection", torch.Tensor.cpu, pending_vec
            ).numpy()
            fetched += 1
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
            chunks_solved=fetched,
            chunks_skipped=run["n_chunks"] - fetched,
            lanes_eliminated=run["eliminated"],
            count_truncated=found_idx >= 0 and fetched < len(run["runnable"]),
        )
        return sel, stats

    def solve(self, packed, maybe=None):
        """Run the staged solve start to finish; returns
        (Selection, StagedStats)."""
        return self.finish_run(self.start(packed, maybe))

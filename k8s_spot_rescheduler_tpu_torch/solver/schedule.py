"""Drain-to-exhaustion on the device: one fetch, a whole schedule.

The port of the JAX package's ``solver/schedule.py``. ``schedule_matrix``
runs the drain -> commit -> re-solve loop with its carry (spot capacity,
pod counts, affinity words, candidate mask) on the device and returns
the schedule as ONE int32 matrix ``[horizon, 3 + K]``: per step
``idx | found | n_feasible | row``, each row decoding like
``solver/select.decode_selection``. The terminal probe (no candidate
drainable) writes its ``found=0`` row and the loop stops; rows after
it stay -1, so the matrix is self-delimiting.

Host syncs: each step reads the chosen lane's index and ``found``
together, once, before its commit: the index takes the lane's rows and
``found`` stops the loop at the terminal probe (the reference's
``while_loop`` condition). Beside it the union reads its own gate
(``solver/fallback``), and the matrix is fetched once. So a cut of H
steps makes 2·H + 1 reads, and one a terminal probe ends after n drains
2·n + 3 (``utils/syncs.device_sync`` counts them by site).
The commit's per-node load is an ``index_add_`` of integral f32
requests (exact in any order), never a matmul.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from k8s_spot_rescheduler_tpu_torch.solver.ffd import first_true, or_reduce
from k8s_spot_rescheduler_tpu_torch.utils import tracing
from k8s_spot_rescheduler_tpu_torch.utils.syncs import device_sync


class ScheduleStep(NamedTuple):
    """One decoded drain step: candidate lane + placement row."""

    index: int
    n_feasible: int
    row: np.ndarray  # int32 [K]


def schedule_matrix(solve_fn, packed, horizon: int) -> torch.Tensor:
    """Drain-to-exhaustion loop on the device; returns int32
    [horizon, 3 + K] on the packed tensors' device."""
    C, K, _ = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    dev = packed.slot_req.device
    out = torch.full((horizon, 3 + K), -1, dtype=torch.int32, device=dev)
    iota_s = torch.arange(S, device=dev)
    iota_c = torch.arange(C, device=dev)
    cand_valid = packed.cand_valid
    free = packed.spot_free
    count = packed.spot_count.to(torch.int32)
    aff = packed.spot_aff
    minus_one = torch.full((1,), -1, dtype=torch.int32, device=dev)
    for step in range(horizon):
        cur = packed._replace(
            cand_valid=cand_valid,
            spot_free=free,
            spot_count=count,
            spot_aff=aff,
        )
        res = solve_fn(cur)
        feasible = res.feasible & cand_valid
        found = feasible.any()
        idx = first_true(feasible)
        # the step's one read: the lane's rows are taken at a host index
        # (a 0-dim device index reads itself to the host at every use),
        # and ``found`` ends the loop after the terminal probe's row
        i, f = device_sync(
            "found", torch.Tensor.tolist, torch.stack((idx, found.long()))
        )
        with tracing.span("schedule.commit"):
            row = res.assignment[i].to(torch.int32)  # [K]
            # commit (a masked no-op when nothing was found): evictees
            # deplete spot capacity, bump pod counts and land their
            # anti-affinity words; the drained lane leaves the candidates
            placed = (row >= 0) & packed.slot_valid[i] & found  # [K]
            onehot = (iota_s[None, :] == row[:, None]) & placed[:, None]
            load = torch.zeros_like(free).index_add_(
                0, row.clamp(min=0).long(),
                packed.slot_req[i] * placed[:, None],
            )
            free = free - load
            count = count + onehot.sum(dim=0).to(count.dtype)
            aff = aff | or_reduce(
                torch.where(
                    onehot[:, :, None], packed.slot_aff[i][:, None, :], 0
                ),
                0,
            )
            cand_valid = cand_valid & ~(found & (iota_c == idx))
            out[step] = torch.cat(
                [
                    torch.where(found, idx.to(torch.int32), minus_one),
                    found.reshape(1).to(torch.int32),
                    feasible.sum().reshape(1).to(torch.int32),
                    torch.where(found, row, -1),
                ]
            )
        if not f:
            break
    return out


def make_schedule_planner(solve_fn, horizon: int):
    """A PackedCluster -> [horizon, 3 + K] schedule function over the
    union ``solve_fn``. The packed tensors are read, never written, so
    a resident cache survives for the next tick's delta."""

    def sched(packed):
        return schedule_matrix(solve_fn, packed, horizon)

    return sched


def decode_schedule(mat) -> List[ScheduleStep]:
    """The drain steps of one fetched schedule matrix, in execution
    order: the prefix of rows with ``found=1``."""
    if isinstance(mat, torch.Tensor):
        mat = mat.cpu().numpy()
    mat = np.asarray(mat)
    steps: List[ScheduleStep] = []
    for r in range(mat.shape[0]):
        if mat[r, 1] != 1:
            break
        steps.append(
            ScheduleStep(
                index=int(mat[r, 0]),
                n_feasible=int(mat[r, 2]),
                row=np.asarray(mat[r, 3:], np.int32),
            )
        )
    return steps


def commit_step_host(packed, idx: int, row: np.ndarray):
    """Host twin of the device commit on a numpy PackedCluster: apply
    one drain step's placements to the spot state and retire the
    drained lane (exact: requests are integral f32 below 2**24)."""
    free = np.array(packed.spot_free)
    count = np.array(packed.spot_count)
    aff = np.array(packed.spot_aff)
    cand = np.array(packed.cand_valid)
    row = np.asarray(row)
    for k in range(min(len(row), packed.slot_req.shape[1])):
        s = int(row[k])
        if s < 0 or not packed.slot_valid[idx, k]:
            continue
        free[s] -= packed.slot_req[idx, k]
        count[s] += 1
        aff[s] |= packed.slot_aff[idx, k]
    cand[idx] = False
    return packed._replace(
        spot_free=free, spot_count=count, spot_aff=aff, cand_valid=cand
    )


def slice_lane(packed, c: int):
    """A single-lane view (C=1) of ``packed``, numpy or torch — lanes
    are independent fork copies, so slicing is exact. The schedule
    execution handle's per-step validation (planner/schedule.py) uses
    it."""
    sl = slice(c, c + 1)
    return packed._replace(
        slot_req=packed.slot_req[sl],
        slot_valid=packed.slot_valid[sl],
        slot_tol=packed.slot_tol[sl],
        slot_aff=packed.slot_aff[sl],
        cand_valid=packed.cand_valid[sl],
    )


def plan_schedule_oracle(
    packed,
    horizon: int,
    *,
    best_fit_fallback: bool = True,
    repair_rounds: int = 8,
) -> np.ndarray:
    """Host-side drain-to-exhaustion schedule on a numpy PackedCluster:
    the same loop over the host union (solver/numpy_oracle.
    plan_union_oracle), emitting the identical int32 [horizon, 3+K]
    matrix."""
    from k8s_spot_rescheduler_tpu_torch.solver.numpy_oracle import (
        plan_union_oracle,
    )

    C, K, _ = packed.slot_req.shape
    out = np.full((horizon, 3 + K), -1, np.int32)
    cur = packed
    for step in range(horizon):
        res = plan_union_oracle(
            cur,
            best_fit_fallback=best_fit_fallback,
            repair_rounds=repair_rounds,
        )
        feasible = np.asarray(res.feasible) & np.asarray(cur.cand_valid)
        out[step, 1] = 0
        out[step, 2] = int(feasible.sum())
        if not feasible.any():
            break
        idx = int(np.argmax(feasible))
        row = np.asarray(res.assignment[idx], np.int32)
        out[step, 0] = idx
        out[step, 1] = 1
        out[step, 3:] = row
        cur = commit_step_host(cur, idx, row)
    return out

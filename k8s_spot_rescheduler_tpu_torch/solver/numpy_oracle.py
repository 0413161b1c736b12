"""Serial first-fit oracle — the correctness anchor.

The port of the JAX package's ``solver/numpy_oracle.py``, with
``plan_repair_oracle`` (the JAX package keeps it in ``solver/repair.py``
beside the JAX program) copied in, so the host union needs nothing of
the device path. ``solver="numpy"`` planners and the controller's
crash-containment planner run these. The repair's from-scratch
validation is the port's ``solver/validate.validate_assignment`` on CPU
tensors.

A direct, readable NumPy rendition of the reference's planning nest
(reference rescheduler.go:334-370):

- ``canDrainNode`` (355-370): walk the candidate's pods in order; every pod
  must land on some spot node or the whole candidate fails;
- ``findSpotNodeForPod`` (334-353): walk spot nodes in their static sorted
  order and return the first that passes the predicates;
- snapshot commit (366): a successful placement depletes that spot node's
  remaining capacity/count for subsequent pods of the *same* candidate;
- fork/revert (rescheduler.go:269-275): every candidate starts from the
  same initial spot pool — implemented here by copying the pool per lane.

The TPU solver (solver/ffd.py) must produce bit-identical feasibility and
assignments; the property tests enforce it.
"""

from __future__ import annotations

import numpy as np

from k8s_spot_rescheduler_tpu_torch.models.tensors import PackedCluster
from k8s_spot_rescheduler_tpu_torch.predicates.masks import fit_mask
from k8s_spot_rescheduler_tpu_torch.solver.result import SolveResult


def plan_oracle(packed: PackedCluster, best_fit: bool = False) -> SolveResult:
    """``best_fit=False`` is the reference's first-fit probe order;
    ``best_fit=True`` places each pod on the admissible node with the
    least remaining primary-resource slack (ties → probe order) — the
    fallback packing mode (solver/ffd.py ``plan_ffd``)."""
    C, K, _ = packed.slot_req.shape
    feasible = np.zeros(C, bool)
    assign = np.full((C, K), -1, np.int32)

    for c in range(C):
        if not packed.cand_valid[c]:
            continue
        # fork: private copy of the spot pool (rescheduler.go:269)
        free = packed.spot_free.copy()
        count = packed.spot_count.copy()
        aff = packed.spot_aff.copy()
        ok = True
        for k in range(K):
            if not packed.slot_valid[c, k]:
                continue
            fits = fit_mask(
                np,
                free=free,
                count=count,
                max_pods=packed.spot_max_pods,
                node_taints=packed.spot_taints,
                node_ok=packed.spot_ok,
                node_aff=aff,
                req=packed.slot_req[c, k],
                tol=packed.slot_tol[c, k],
                aff=packed.slot_aff[c, k],
            )
            if not fits.any():
                ok = False  # pod can't be rescheduled on any spot node
                break
            if best_fit:
                slack = free[:, 0] - packed.slot_req[c, k, 0]
                slack = np.where(fits, slack, np.inf)
                s = int(np.argmin(slack))  # tightest fit, ties → probe order
            else:
                s = int(np.argmax(fits))  # first fit in probe order
            assign[c, k] = s
            # commit into the fork (rescheduler.go:366)
            free[s] -= packed.slot_req[c, k]
            count[s] += 1
            aff[s] |= packed.slot_aff[c, k]
        feasible[c] = ok
        if not ok:
            assign[c] = -1  # revert (rescheduler.go:273)

    return SolveResult(feasible=feasible, assignment=assign)


def plan_union_oracle(
    packed: PackedCluster,
    *,
    best_fit_fallback: bool = True,
    repair_rounds: int = 0,
) -> SolveResult:
    """The host-side union composition — first-fit ∪ best-fit ∪ repair,
    mirroring the device path's ``lax.cond`` gating (solver/fallback.py:
    later passes are consumed only for lanes the earlier ones failed).
    The ONE host union: SolverPlanner's numpy branch and the planner
    service's host batch path both call this, so the two cannot drift."""
    result = plan_oracle(packed)
    if best_fit_fallback:
        bf = plan_oracle(packed, best_fit=True)
        result = SolveResult(
            feasible=result.feasible | bf.feasible,
            assignment=np.where(
                result.feasible[:, None], result.assignment, bf.assignment
            ),
        )
        need_repair = bool(
            np.any(np.asarray(packed.cand_valid) & ~result.feasible)
        )
        if repair_rounds > 0 and need_repair:
            rp = plan_repair_oracle(packed, rounds=repair_rounds)
            result = SolveResult(
                feasible=result.feasible | rp.feasible,
                assignment=np.where(
                    result.feasible[:, None], result.assignment, rp.assignment
                ),
            )
    return result


def _validate_host(packed: PackedCluster, assign: np.ndarray) -> np.ndarray:
    """bool [C]: ``solver/validate.validate_assignment`` on the CPU."""
    import torch

    from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
    from k8s_spot_rescheduler_tpu_torch.solver.validate import (
        validate_assignment,
    )

    ok = validate_assignment(
        to_device(packed, "cpu"), torch.from_numpy(np.asarray(assign, np.int64))
    )
    return ok.numpy()


def plan_repair_oracle(
    packed: PackedCluster, rounds: int = 8, chain: bool = True
) -> SolveResult:
    """Serial NumPy mirror of ``plan_repair`` — identical partial pass,
    rotation, exact affinity ejection, and validation, for bit-parity
    tests against the device solver. ``chain=False`` mirrors the
    depth-1-only analyzer variant."""
    C, K, R = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    assign = np.full((C, K), -1, np.int32)
    frees = np.broadcast_to(packed.spot_free, (C, S, R)).copy()
    counts = np.broadcast_to(packed.spot_count, (C, S)).astype(np.int64).copy()
    affs = np.broadcast_to(packed.spot_aff, (C, *packed.spot_aff.shape)).copy()

    # partial best-fit pass with gaps
    for c in range(C):
        for k in range(K):
            if not packed.slot_valid[c, k]:
                continue
            fits = fit_mask(
                np,
                free=frees[c],
                count=counts[c],
                max_pods=packed.spot_max_pods,
                node_taints=packed.spot_taints,
                node_ok=packed.spot_ok,
                node_aff=affs[c],
                req=packed.slot_req[c, k],
                tol=packed.slot_tol[c, k],
                aff=packed.slot_aff[c, k],
            )
            if not fits.any():
                continue  # leave the gap for repair
            slack = np.where(
                fits, frees[c, :, 0] - packed.slot_req[c, k, 0], np.inf
            )
            s = int(np.argmin(slack))
            assign[c, k] = s
            frees[c, s] -= packed.slot_req[c, k]
            counts[c, s] += 1
            affs[c, s] |= packed.slot_aff[c, k]

    for rnd in range(rounds):
        for c in range(C):
            unplaced = packed.slot_valid[c] & (assign[c] < 0)
            if not unplaced.any():
                continue
            p = int(np.argmax(unplaced))
            req_p = packed.slot_req[c, p]
            tol_p = packed.slot_tol[c, p]
            aff_p = packed.slot_aff[c, p]
            static_p = (
                np.all((packed.spot_taints & ~tol_p) == 0, axis=-1)
                & packed.spot_ok
            )
            unlock = np.zeros(K, bool)
            for k in range(K):
                s = assign[c, k]
                if s < 0:
                    continue
                if not static_p[s]:
                    continue
                if not np.all(
                    frees[c, s] + packed.slot_req[c, k] - req_p >= 0
                ):
                    continue
                unlock[k] = True
            n_unlock = int(unlock.sum())
            if not n_unlock:
                continue
            want = rnd % n_unlock
            q = int(np.flatnonzero(unlock)[want])
            sq = int(assign[c, q])
            # exact aff of q's node after q leaves (device lockstep):
            # static resident bits OR pods still assigned there
            aff_ej = np.asarray(packed.spot_aff[sq]).copy()
            for k in range(K):
                if k != q and assign[c, k] == sq:
                    aff_ej |= packed.slot_aff[c, k]
            if np.any(aff_p & aff_ej):
                continue  # rotation tries a different unlocker next round
            req_q = packed.slot_req[c, q]
            tol_q = packed.slot_tol[c, q]
            aff_q = packed.slot_aff[c, q]
            fits_q = fit_mask(
                np,
                free=frees[c],
                count=counts[c],
                max_pods=packed.spot_max_pods,
                node_taints=packed.spot_taints,
                node_ok=packed.spot_ok,
                node_aff=affs[c],
                req=req_q,
                tol=tol_q,
                aff=aff_q,
            )
            fits_q[sq] = False
            if fits_q.any():
                # depth-1 direct move: p -> s_q, q -> s2
                s2 = int(np.argmax(fits_q))
                assign[c, p] = sq
                assign[c, q] = s2
                frees[c, sq] += req_q - req_p
                frees[c, s2] -= req_q
                counts[c, s2] += 1
                affs[c, s2] |= aff_q
                affs[c, sq] = aff_ej | aff_p  # exact replacement, not OR
                continue
            if not chain:
                continue  # depth-1-only analyzer variant
            # depth-2 chain (device lockstep): q cannot re-place
            # directly; move it onto a third pod r's node and re-place
            # r elsewhere (p -> s_q, q -> s_r, r -> s3)
            static_q = (
                np.all((packed.spot_taints & ~tol_q) == 0, axis=-1)
                & packed.spot_ok
            )
            eligible = np.zeros(K, bool)
            for k in range(K):
                s = assign[c, k]
                if s < 0 or s == sq:
                    continue
                if not static_q[s]:
                    continue
                if not np.all(frees[c, s] + packed.slot_req[c, k] - req_q >= 0):
                    continue
                eligible[k] = True
            n_r = int(eligible.sum())
            if not n_r:
                continue
            # independent r rotation (device lockstep): see _repair_round
            r = int(np.flatnonzero(eligible)[(rnd // max(n_unlock, 1)) % n_r])
            sr = int(assign[c, r])
            fits_r = fit_mask(
                np,
                free=frees[c],
                count=counts[c],
                max_pods=packed.spot_max_pods,
                node_taints=packed.spot_taints,
                node_ok=packed.spot_ok,
                node_aff=affs[c],
                req=packed.slot_req[c, r],
                tol=packed.slot_tol[c, r],
                aff=packed.slot_aff[c, r],
            )
            fits_r[sr] = False
            fits_r[sq] = False
            if not fits_r.any():
                continue  # rotation elects a different r next round
            s3 = int(np.argmax(fits_r))
            aff_ej_r = np.asarray(packed.spot_aff[sr]).copy()
            for k in range(K):
                if k != r and assign[c, k] == sr:
                    aff_ej_r |= packed.slot_aff[c, k]
            if np.any(aff_q & aff_ej_r):
                continue
            assign[c, p] = sq
            assign[c, q] = sr
            assign[c, r] = s3
            frees[c, sq] += req_q - req_p
            frees[c, sr] += packed.slot_req[c, r] - req_q
            frees[c, s3] -= packed.slot_req[c, r]
            counts[c, s3] += 1
            affs[c, sq] = aff_ej | aff_p
            affs[c, sr] = aff_ej_r | aff_q
            affs[c, s3] |= packed.slot_aff[c, r]

    feasible = _validate_host(packed, assign)
    assignment = np.where(feasible[:, None], assign, -1).astype(np.int32)
    return SolveResult(feasible=feasible, assignment=assignment)

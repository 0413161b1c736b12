"""Bounded eject-and-reinsert local search, plain PyTorch.

The port of the JAX package's ``solver/repair.plan_repair``:

1. a partial best-fit pass that leaves gaps instead of failing a lane;
2. ``rounds`` repair rounds. Each unfinished lane picks its first
   unplaced pod p, rotates deterministically through the placed pods q
   whose ejection would let p take their node, and relocates
   ``q -> elsewhere, p -> q's node``; when q cannot re-place directly,
   the depth-2 chain moves q onto a third pod r's node and r elsewhere
   (``chain=False`` leaves the chain out, the depth-1 analyzer variant);
3. from-scratch validation (``solver/validate``): only complete,
   predicate-valid lanes report feasible.

Every election, gate and update copies the reference's arithmetic, so
the result is bit-identical to ``plan_repair`` and
``plan_repair_oracle``. The state is the wide delta carry widened at
the one site ``solver/ffd._widen``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from k8s_spot_rescheduler_tpu_torch.solver.ffd import (
    _Carry,
    _scan_step,
    _slot,
    _spot_statics,
    _widen,
    _zero_carry,
    first_true,
    fit_mask_t,
    or_reduce,
)
from k8s_spot_rescheduler_tpu_torch.solver.result import SolveResult
from k8s_spot_rescheduler_tpu_torch.solver.validate import validate_assignment

DEFAULT_ROUNDS = 8


class _RepairCarry(NamedTuple):
    """Delta-form repair state; absolute views are rebuilt per round."""

    used: torch.Tensor  # [C, R, S]
    dcount: torch.Tensor  # [C, S]
    daff: torch.Tensor  # [C, A, S]
    assign: torch.Tensor  # i32 [C, K]


def _partial_scan_step(static, carry: _Carry, slot):
    """``solver/ffd._scan_step`` in best-fit mode, but a pod that fits
    nowhere leaves a gap instead of failing the lane."""
    new_carry, chosen = _scan_step(static, True, carry, slot)
    return new_carry._replace(feasible=carry.feasible), chosen


def _take(x, idx):
    """Row ``idx[c]`` of ``x[c]`` for every lane: x [C, K, ...] -> [C, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _repair_round(static, chain: bool, state: _RepairCarry, round_idx: int):
    (spot_static, spot_aff_static,
     slot_req, slot_valid, slot_tol, slot_aff) = static
    spot_max_pods = spot_static.max_pods
    spot_taints_t = spot_static.taints_t
    spot_ok = spot_static.ok
    C, K, R = slot_req.shape
    S = state.used.shape[-1]
    dev = slot_req.device
    iota = torch.arange(S, device=dev)[None, :]
    free, count, aff = _widen(
        spot_static, state.used, state.dcount, state.daff
    )

    unplaced = slot_valid & (state.assign < 0)  # [C, K]
    has_gap = unplaced.any(dim=-1)  # [C]
    p = first_true(unplaced)  # first unplaced slot per lane

    req_p = _take(slot_req, p)
    tol_p = _take(slot_tol, p)
    aff_p = _take(slot_aff, p)

    # static admission of p per spot node (taint/selector words + ok)
    word_ok = ((spot_taints_t & ~tol_p[:, :, None]) == 0).all(dim=1)
    static_p = word_ok & spot_ok  # [C, S]

    placed = state.assign >= 0  # [C, K]
    s_q = state.assign.clamp(0, S - 1).long()  # [C, K]

    # would p fit on q's node if q were ejected? (resources + static
    # words; the exact affinity gate vets the ELECTED unlocker below)
    free_at_q = torch.gather(free, 2, s_q[:, None, :].expand(C, R, K))
    req_t = slot_req.transpose(1, 2)  # [C, R, K]
    res_ok = (free_at_q + req_t - req_p[:, :, None] >= 0).all(dim=1)
    static_at_q = torch.gather(static_p, 1, s_q)  # [C, K]

    unlock = placed & res_ok & static_at_q  # [C, K]
    n_unlock = unlock.sum(dim=-1)  # [C]

    # deterministic rotation: try a different unlocker each round
    rank = unlock.cumsum(dim=-1) - 1
    want = torch.where(
        n_unlock > 0, round_idx % n_unlock.clamp(min=1), -1
    )
    is_q = unlock & (rank == want[:, None])
    q = first_true(is_q)  # [C]
    any_q = is_q.any(dim=-1)

    # can q itself re-place somewhere else under the current state?
    req_q = _take(slot_req, q)
    tol_q = _take(slot_tol, q)
    aff_q = _take(slot_aff, q)
    sq_star = _take(s_q, q)  # [C]

    fits_q = fit_mask_t(
        free_t=free,
        count=count,
        max_pods=spot_max_pods,
        node_taints_t=spot_taints_t,
        node_ok=spot_ok,
        node_aff_t=aff,
        req=req_q,
        tol=tol_q,
        aff=aff_q,
    )  # [C, S]
    fits_q &= iota != sq_star[:, None]
    s2 = first_true(fits_q)  # [C]
    can_move = fits_q.any(dim=-1)

    # exact affinity of q's node AFTER q leaves: static resident bits OR
    # the bits of pods still assigned there. ``aff_ejd`` is the
    # pod-contributed half alone (the delta carry's write value).
    ks = torch.arange(K, device=dev)[None, :]
    slot_aff_t = slot_aff.transpose(1, 2)  # [C, A, K]
    others = placed & (state.assign == sq_star[:, None]) & (ks != q[:, None])
    aff_ejd = or_reduce(
        torch.where(others[:, None, :], slot_aff_t, 0), 2
    )  # [C, A]
    aff_ej = aff_ejd | spot_aff_static[sq_star]  # [C, A]
    aff_ok_p = ((aff_p & aff_ej) == 0).all(dim=1)  # [C]

    do_direct = has_gap & any_q & can_move & aff_ok_p  # [C]

    if chain:
        # depth-2 chain: q -> r's node, r re-placed elsewhere
        word_ok_q = ((spot_taints_t & ~tol_q[:, :, None]) == 0).all(dim=1)
        static_q = word_ok_q & spot_ok
        static_q_at = torch.gather(static_q, 1, s_q)  # [C, K]
        res_ok_r = (free_at_q + req_t - req_q[:, :, None] >= 0).all(dim=1)
        eligible_r = (
            placed & (s_q != sq_star[:, None]) & static_q_at & res_ok_r
        )
        n_r = eligible_r.sum(dim=-1)
        rank_r = eligible_r.cumsum(dim=-1) - 1
        # r rotates on an independent schedule (divided by q's period),
        # so n_unlock x n_r rounds sweep every pairing
        want_r = torch.where(
            n_r > 0,
            (round_idx // n_unlock.clamp(min=1)) % n_r.clamp(min=1),
            -1,
        )
        is_r = eligible_r & (rank_r == want_r[:, None])
        r = first_true(is_r)  # [C]
        any_r = is_r.any(dim=-1)
        sr_star = _take(s_q, r)  # [C]
        req_r = _take(slot_req, r)
        tol_r = _take(slot_tol, r)
        aff_r = _take(slot_aff, r)

        fits_r = fit_mask_t(
            free_t=free,
            count=count,
            max_pods=spot_max_pods,
            node_taints_t=spot_taints_t,
            node_ok=spot_ok,
            node_aff_t=aff,
            req=req_r,
            tol=tol_r,
            aff=aff_r,
        )  # [C, S]
        fits_r &= (iota != sr_star[:, None]) & (iota != sq_star[:, None])
        s3 = first_true(fits_r)  # [C]
        r_can_move = fits_r.any(dim=-1)

        # exact affinity of r's node after r leaves, for q's arrival
        others_r = placed & (state.assign == sr_star[:, None]) & (
            ks != r[:, None]
        )
        aff_ejd_r = or_reduce(
            torch.where(others_r[:, None, :], slot_aff_t, 0), 2
        )  # [C, A]
        aff_ej_r = aff_ejd_r | spot_aff_static[sr_star]
        aff_ok_q = ((aff_q & aff_ej_r) == 0).all(dim=1)  # [C]

        do_chain = (
            has_gap & any_q & ~can_move & aff_ok_p
            & any_r & r_can_move & aff_ok_q
        )
    else:
        # depth-1 only: the masked arithmetic below folds to the direct
        # move
        do_chain = torch.zeros_like(do_direct)
        sr_star, s3, r = s2, s2, q
        req_r, aff_r, aff_ejd_r = req_q, aff_q, aff_ejd
    do = do_direct | do_chain  # [C]

    # q's destination: s2 (direct) or r's node (chain); the +1 pod count
    # lands on s2 (direct) or s3 (chain); every other count nets zero
    q_dest = torch.where(do_chain, sr_star, s2)
    inc_node = torch.where(do_chain, s3, s2)
    onehot_sq = iota == sq_star[:, None]  # [C, S]
    onehot_qd = iota == q_dest[:, None]
    onehot_s3 = (iota == s3[:, None]) & do_chain[:, None]
    onehot_inc = iota == inc_node[:, None]
    delta = (
        onehot_sq[:, None, :] * (req_q - req_p)[:, :, None]
        - onehot_qd[:, None, :] * req_q[:, :, None]
        + (onehot_qd[:, None, :] & do_chain[:, None, None]) * req_r[:, :, None]
        - onehot_s3[:, None, :] * req_r[:, :, None]
    )
    # free += delta  <=>  used -= delta (delta form)
    used = torch.where(
        do[:, None, None],
        (state.used.to(delta.dtype) - delta).to(state.used.dtype),
        state.used,
    )
    dcount = torch.where(
        do[:, None],
        state.dcount + onehot_inc.to(state.dcount.dtype),
        state.dcount,
    )
    # s_q's column is REPLACED by the exact recompute (plus p's
    # arrival); q's destination is replaced on a chain or OR'd on a
    # direct move; s3 accumulates r's bits. Written values are
    # pod-contributed bits only (the widen site ORs the statics back).
    qd_col = torch.where(do_chain[:, None], aff_ejd_r | aff_q, 0)
    daff_after = torch.where(
        onehot_sq[:, None, :], (aff_ejd | aff_p)[:, :, None], state.daff
    )
    daff_after = (
        torch.where(
            (onehot_qd & do_chain[:, None])[:, None, :],
            qd_col[:, :, None],
            daff_after,
        )
        | torch.where(
            (onehot_qd & do_direct[:, None])[:, None, :],
            aff_q[:, :, None],
            0,
        )
        | torch.where(onehot_s3[:, None, :], aff_r[:, :, None], 0)
    )
    daff = torch.where(do[:, None, None], daff_after, state.daff)
    assign = torch.where(
        do[:, None],
        torch.where(
            ks == p[:, None],
            sq_star[:, None],
            torch.where(
                ks == q[:, None],
                q_dest[:, None],
                torch.where(
                    (ks == r[:, None]) & do_chain[:, None],
                    s3[:, None],
                    state.assign.long(),
                ),
            ),
        ),
        state.assign.long(),
    ).to(torch.int32)
    return _RepairCarry(used, dcount, daff, assign)


def plan_repair(
    packed, rounds: int = DEFAULT_ROUNDS, chain: bool = True
) -> SolveResult:
    """Partial pack + ``rounds`` repair rounds + from-scratch validation
    over a device PackedCluster (the contract of the JAX
    ``plan_repair``)."""
    C, K, R = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    A = packed.spot_aff.shape[1]

    static = _spot_statics(packed)
    carry = _zero_carry(C, R, A, S, packed.cand_valid)
    assign0 = torch.full(
        (C, K), -1, dtype=torch.int32, device=packed.slot_req.device
    )
    for k in range(K):
        carry, assign0[:, k] = _partial_scan_step(
            static, carry, _slot(packed, k)
        )

    state = _RepairCarry(
        used=carry.used, dcount=carry.dcount, daff=carry.daff, assign=assign0
    )
    repair_static = (
        static,
        packed.spot_aff,  # static resident bits, [S, A]
        packed.slot_req,
        packed.slot_valid,
        packed.slot_tol,
        packed.slot_aff,
    )
    for i in range(rounds):
        state = _repair_round(repair_static, chain, state, i)

    feasible = validate_assignment(packed, state.assign)
    assignment = torch.where(feasible[:, None], state.assign, -1).to(
        torch.int32
    )
    return SolveResult(feasible=feasible, assignment=assignment)

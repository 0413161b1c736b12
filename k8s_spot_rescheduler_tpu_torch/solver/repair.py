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
``plan_repair_oracle``. The state is the delta carry (dtypes from a
``CarryLayout``) widened at the one site ``solver/ffd._widen``.

``plan_repair_chunked`` is the elect-then-commit restructure over
ordered spot chunks (the JAX package's ``plan_repair_chunked``): chunk
sweeps build the unlocker set and the re-placement targets, elections
combine them in global index order (a minimum of chunk-local winners'
global indices is the global first fit), the exact affinity gate vets
the move and only the chunks holding a touched node change. Same
results as ``plan_repair``, per-round temporaries O(S / chunks). Both
run as plain PyTorch on the card, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from k8s_spot_rescheduler_tpu_torch.solver.carry import (
    WIDE_LAYOUT,
    CarryLayout,
)
from k8s_spot_rescheduler_tpu_torch.solver.ffd import (
    _Carry,
    _scan_step,
    _slot,
    _spot_statics,
    _stream_bf_step,
    _widen,
    _widen_chunk,
    _zero_carry,
    _zero_chunk_state,
    chunked_spot_statics,
    first_true,
    fit_mask_t,
    or_reduce,
    pad_spot_axis,
)
from k8s_spot_rescheduler_tpu_torch.solver.result import SolveResult
from k8s_spot_rescheduler_tpu_torch.solver.validate import validate_assignment
from k8s_spot_rescheduler_tpu_torch.utils import tracing

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
    # pod-contributed bits only (the widen site ORs the statics back),
    # narrowed to the plane's dtype (exact within the layout guard).
    dt = state.daff.dtype
    qd_col = torch.where(do_chain[:, None], aff_ejd_r | aff_q, 0).to(dt)
    daff_after = torch.where(
        onehot_sq[:, None, :], (aff_ejd | aff_p).to(dt)[:, :, None], state.daff
    )
    daff_after = (
        torch.where(
            (onehot_qd & do_chain[:, None])[:, None, :],
            qd_col[:, :, None],
            daff_after,
        )
        | torch.where(
            (onehot_qd & do_direct[:, None])[:, None, :],
            aff_q.to(dt)[:, :, None],
            0,
        ).to(dt)
        | torch.where(
            onehot_s3[:, None, :], aff_r.to(dt)[:, :, None], 0
        ).to(dt)
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
    packed,
    rounds: int = DEFAULT_ROUNDS,
    chain: bool = True,
    layout: CarryLayout = WIDE_LAYOUT,
) -> SolveResult:
    """Partial pack + ``rounds`` repair rounds + from-scratch validation
    over a device PackedCluster (the contract of the JAX
    ``plan_repair``). ``layout`` narrows the delta carry; pass only what
    ``solver/carry.carry_layout`` proves the pack fits."""
    C, K, R = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    A = packed.spot_aff.shape[1]

    with tracing.span("repair.partial"):
        static = _spot_statics(packed)
        carry = _zero_carry(layout, C, R, A, S, packed.cand_valid)
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
    with tracing.span("repair.rounds"):
        for i in range(rounds):
            state = _repair_round(repair_static, chain, state, i)

    with tracing.span("repair.validate"):
        feasible = validate_assignment(packed, state.assign)
        assignment = torch.where(feasible[:, None], state.assign, -1).to(
            torch.int32
        )
    return SolveResult(feasible=feasible, assignment=assignment)


# --- spot-chunked repair (elect-then-commit) -----------------------------------

_BIG_IDX = 2**30  # past any global spot index


def _chunked_partial_step(chunk_xs, Sc: int, state, slot):
    """Best-fit-with-gaps placement of one pod slot over spot chunks
    (``solver/ffd._stream_bf_step``; the any-fit flag is repair's to
    ignore)."""
    state, (chosen, _) = _stream_bf_step(chunk_xs, Sc, state, slot)
    return state, chosen


def _chunked_repair_round(small, chunk_xs, chain: bool, Sc: int, state,
                          round_idx: int):
    """One elect-then-commit repair round over the stacked chunk state,
    bit-identical to ``_repair_round``. Returns the new state."""
    spot_aff_static, slot_req, slot_valid, slot_tol, slot_aff = small
    free0_c, count0_c, aff0_c, taints_c, ok_c, maxp_c, offs = chunk_xs
    used_c, dcount_c, daff_c, assign = state
    C, K, R = slot_req.shape
    n = used_c.shape[0]
    Sp = n * Sc
    dev = slot_req.device
    ks = torch.arange(K, device=dev)[None, :]
    gsc = torch.arange(Sc, device=dev)[None, :]

    unplaced = slot_valid & (assign < 0)  # [C, K]
    has_gap = unplaced.any(dim=-1)
    p = first_true(unplaced)
    req_p = _take(slot_req, p)
    tol_p = _take(slot_tol, p)
    aff_p = _take(slot_aff, p)

    placed = assign >= 0  # [C, K]
    s_q = assign.clamp(0, Sp - 1).long()  # [C, K] global node per pod
    req_t = slot_req.transpose(1, 2)  # [C, R, K]

    def at_q(values, loc):
        """values [C, ..., Sc] at each pod's chunk-local node: [C, ..., K]."""
        if values.dim() == 2:
            return torch.gather(values, 1, loc)
        return torch.gather(
            values, 2, loc[:, None, :].expand(C, values.shape[1], K)
        )

    # ---- sweep A (elect): the unlocker candidates, chunk by chunk. Each
    # placed pod lives in exactly one chunk, so the union is exact.
    unlock = torch.zeros((C, K), dtype=torch.bool, device=dev)
    for j in range(n):
        off = offs[j]
        free_j = free0_c[j] - used_c[j].to(free0_c.dtype)
        word_ok = ((taints_c[j] & ~tol_p[:, :, None]) == 0).all(dim=1)
        static_p = word_ok & ok_c[j]  # [C, Sc]
        in_j = (s_q >= off) & (s_q < off + Sc)
        loc = (s_q - off).clamp(0, Sc - 1)
        res_ok = (at_q(free_j, loc) + req_t - req_p[:, :, None] >= 0).all(dim=1)
        unlock = unlock | (placed & in_j & res_ok & at_q(static_p, loc))

    # q election: deterministic rotation in global slot order
    n_unlock = unlock.sum(dim=-1)
    rank = unlock.cumsum(dim=-1) - 1
    want = torch.where(n_unlock > 0, round_idx % n_unlock.clamp(min=1), -1)
    is_q = unlock & (rank == want[:, None])
    q = first_true(is_q)
    any_q = is_q.any(dim=-1)
    req_q = _take(slot_req, q)
    tol_q = _take(slot_tol, q)
    aff_q = _take(slot_aff, q)
    sq_star = _take(s_q, q)

    def widened(j):
        return _widen_chunk(
            free0_c[j], count0_c[j], aff0_c[j], used_c[j], dcount_c[j], daff_c[j]
        )

    def first_fit_target(j, req, tol, aff, exclude):
        """Global index of the first spot of chunk j where the pod fits,
        ``exclude`` [C, Sc] masked out; _BIG_IDX where none."""
        free_j, count_j, aff_j = widened(j)
        fits = fit_mask_t(
            free_t=free_j,
            count=count_j,
            max_pods=maxp_c[j],
            node_taints_t=taints_c[j],
            node_ok=ok_c[j],
            node_aff_t=aff_j,
            req=req,
            tol=tol,
            aff=aff,
        ) & ~exclude
        return torch.where(
            fits.any(dim=-1), offs[j] + first_true(fits), _BIG_IDX
        )

    # ---- sweep B (elect): q's re-placement target (the minimum of the
    # chunk-local winners' global indices IS the global first fit), and
    # with the chain the chunk-local r candidates
    s2g = torch.full((C,), _BIG_IDX, dtype=torch.int64, device=dev)
    eligible_r = torch.zeros((C, K), dtype=torch.bool, device=dev)
    for j in range(n):
        off = offs[j]
        gid = off + gsc
        s2g = torch.minimum(
            s2g,
            first_fit_target(j, req_q, tol_q, aff_q, gid == sq_star[:, None]),
        )
        if chain:
            free_j = free0_c[j] - used_c[j].to(free0_c.dtype)
            word_ok_q = ((taints_c[j] & ~tol_q[:, :, None]) == 0).all(dim=1)
            static_q = word_ok_q & ok_c[j]
            in_j = (s_q >= off) & (s_q < off + Sc)
            loc = (s_q - off).clamp(0, Sc - 1)
            res_ok_r = (
                at_q(free_j, loc) + req_t - req_q[:, :, None] >= 0
            ).all(dim=1)
            eligible_r = eligible_r | (
                placed
                & in_j
                & (s_q != sq_star[:, None])
                & at_q(static_q, loc)
                & res_ok_r
            )
    can_move = s2g < _BIG_IDX

    slot_aff_t = slot_aff.transpose(1, 2)  # [C, A, K]
    # ---- exact affinity gates: O(K*A), no spot-wide work
    others = placed & (assign == sq_star[:, None]) & (ks != q[:, None])
    aff_ejd = or_reduce(torch.where(others[:, None, :], slot_aff_t, 0), 2)
    aff_ej = aff_ejd | spot_aff_static[sq_star]
    aff_ok_p = ((aff_p & aff_ej) == 0).all(dim=1)
    do_direct = has_gap & any_q & can_move & aff_ok_p

    if chain:
        # r election: independent rotation schedule (see _repair_round)
        n_r = eligible_r.sum(dim=-1)
        rank_r = eligible_r.cumsum(dim=-1) - 1
        want_r = torch.where(
            n_r > 0,
            (round_idx // n_unlock.clamp(min=1)) % n_r.clamp(min=1),
            -1,
        )
        is_r = eligible_r & (rank_r == want_r[:, None])
        r = first_true(is_r)
        any_r = is_r.any(dim=-1)
        sr_star = _take(s_q, r)
        req_r = _take(slot_req, r)
        tol_r = _take(slot_tol, r)
        aff_r = _take(slot_aff, r)

        # ---- sweep C (elect): r's re-placement target
        s3g = torch.full((C,), _BIG_IDX, dtype=torch.int64, device=dev)
        for j in range(n):
            gid = offs[j] + gsc
            exclude = (gid == sr_star[:, None]) | (gid == sq_star[:, None])
            s3g = torch.minimum(
                s3g, first_fit_target(j, req_r, tol_r, aff_r, exclude)
            )
        r_can_move = s3g < _BIG_IDX

        others_r = placed & (assign == sr_star[:, None]) & (ks != r[:, None])
        aff_ejd_r = or_reduce(
            torch.where(others_r[:, None, :], slot_aff_t, 0), 2
        )
        aff_ej_r = aff_ejd_r | spot_aff_static[sr_star]
        aff_ok_q = ((aff_q & aff_ej_r) == 0).all(dim=1)
        do_chain = (
            has_gap & any_q & ~can_move & aff_ok_p
            & any_r & r_can_move & aff_ok_q
        )
    else:
        do_chain = torch.zeros_like(do_direct)
        sr_star, s3g, r = s2g, s2g, q
        req_r, aff_r, aff_ejd_r = req_q, aff_q, aff_ejd
    do = do_direct | do_chain

    q_dest = torch.where(do_chain, sr_star, s2g)
    inc_node = torch.where(do_chain, s3g, s2g)
    dt = daff_c.dtype
    qd_col = torch.where(do_chain[:, None], aff_ejd_r | aff_q, 0).to(dt)

    # ---- COMMIT: only chunks holding a touched node change
    for j in range(n):
        gid = offs[j] + gsc
        onehot_sq = gid == sq_star[:, None]  # [C, Sc]
        onehot_qd = gid == q_dest[:, None]
        onehot_s3 = (gid == s3g[:, None]) & do_chain[:, None]
        onehot_inc = gid == inc_node[:, None]
        delta = (
            onehot_sq[:, None, :] * (req_q - req_p)[:, :, None]
            - onehot_qd[:, None, :] * req_q[:, :, None]
            + (onehot_qd[:, None, :] & do_chain[:, None, None])
            * req_r[:, :, None]
            - onehot_s3[:, None, :] * req_r[:, :, None]
        )
        used_c[j] = torch.where(
            do[:, None, None],
            (used_c[j].to(delta.dtype) - delta).to(used_c.dtype),
            used_c[j],
        )
        dcount_c[j] = torch.where(
            do[:, None],
            dcount_c[j] + onehot_inc.to(dcount_c.dtype),
            dcount_c[j],
        )
        daff_after = torch.where(
            onehot_sq[:, None, :], (aff_ejd | aff_p).to(dt)[:, :, None],
            daff_c[j],
        )
        daff_after = (
            torch.where(
                (onehot_qd & do_chain[:, None])[:, None, :],
                qd_col[:, :, None],
                daff_after,
            )
            | torch.where(
                (onehot_qd & do_direct[:, None])[:, None, :],
                aff_q.to(dt)[:, :, None],
                0,
            ).to(dt)
            | torch.where(
                onehot_s3[:, None, :], aff_r.to(dt)[:, :, None], 0
            ).to(dt)
        )
        daff_c[j] = torch.where(do[:, None, None], daff_after, daff_c[j])

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
                    s3g[:, None],
                    assign.long(),
                ),
            ),
        ),
        assign.long(),
    ).to(torch.int32)
    return used_c, dcount_c, daff_c, assign


def plan_repair_chunked(
    packed,
    rounds: int = DEFAULT_ROUNDS,
    chain: bool = True,
    spot_chunks: int = 2,
    layout: CarryLayout = WIDE_LAYOUT,
) -> SolveResult:
    """``plan_repair`` over ``spot_chunks`` ordered spot chunks
    (elect-then-commit; the JAX package's ``plan_repair_chunked``):
    same results, per-round temporaries O(S / spot_chunks), the carried
    state narrow under ``layout``. The spot axis is padded to a chunk
    multiple with inert nodes at the end of the probe order; validation
    runs against the original pack."""
    if spot_chunks <= 1:
        return plan_repair(packed, rounds=rounds, chain=chain, layout=layout)
    C, K, R = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    A = packed.spot_aff.shape[1]
    dev = packed.slot_req.device
    n = int(spot_chunks)
    Sc = -(-S // n)
    pad = n * Sc - S

    with tracing.span("repair.partial"):
        chunk_xs = chunked_spot_statics(packed, n, Sc)
        state = _zero_chunk_state(layout, n, C, R, A, Sc, dev)
        assign0 = torch.full((C, K), -1, dtype=torch.int32, device=dev)
        for k in range(K):
            state, assign0[:, k] = _chunked_partial_step(
                chunk_xs, Sc, state, _slot(packed, k)
            )

    small = (
        pad_spot_axis(packed.spot_aff, pad),  # static resident bits [Sp, A]
        packed.slot_req,
        packed.slot_valid,
        packed.slot_tol,
        packed.slot_aff,
    )
    state = (*state, assign0)
    with tracing.span("repair.rounds"):
        for i in range(rounds):
            state = _chunked_repair_round(small, chunk_xs, chain, Sc, state, i)
    assign = state[3]

    with tracing.span("repair.validate"):
        feasible = validate_assignment(packed, assign)
        assignment = torch.where(feasible[:, None], assign, -1).to(
            torch.int32
        )
    return SolveResult(feasible=feasible, assignment=assignment)

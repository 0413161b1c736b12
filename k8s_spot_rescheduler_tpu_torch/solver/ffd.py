"""Batched first-fit (and best-fit) drain solver, plain PyTorch.

The port of the JAX package's ``solver/ffd``: every candidate lane is an
independent fork of the spot pool, the K pod slots are the one
sequential axis (a Python loop here, a ``lax.scan`` there), and each
step is vectorised over [C, S]. ``plan_ffd`` is the plain version of
kernels B1/B2 and ``plan_ffd_streamed`` (the spot axis in ordered
chunks) of B3/B4 on the streamed union (``ops/ffd_kernels``); both are
the CPU path of the port.

The mutable state is the delta carry (``solver/carry``, in the dtypes
of a ``CarryLayout``) widened at one site (``_widen``); the planes are
updated in place, step by step. Fit and election follow
``predicates/masks.fit_mask_t`` and the reference's probe order: the
first fitting spot (first-fit) or the first spot of least
primary-resource slack (best-fit). Torch's argmax and argmin return the
first index on ties, and argmax is taken over an int32 cast of the bool
mask (torch rejects argmax over bool).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from k8s_spot_rescheduler_tpu_torch.solver.carry import (
    WIDE_LAYOUT,
    CarryLayout,
    torch_dtype,
)
from k8s_spot_rescheduler_tpu_torch.solver.result import SolveResult


class _SpotStatics(NamedTuple):
    """The read-only spot rows the delta carries widen against."""

    free_t: torch.Tensor  # f32 [R, S]
    count: torch.Tensor  # i32 [S]
    aff_t: torch.Tensor  # i32 bits [A, S]
    max_pods: torch.Tensor  # i32 [S]
    taints_t: torch.Tensor  # i32 bits [W, S]
    ok: torch.Tensor  # bool [S]


class _Carry(NamedTuple):
    """Delta-form mutable state (dtypes from a CarryLayout)."""

    used: torch.Tensor  # [C, R, S] capacity consumed
    dcount: torch.Tensor  # [C, S] placements added
    daff: torch.Tensor  # [C, A, S] placed pods' aff bits
    feasible: torch.Tensor  # bool [C]


def first_true(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 where none), int64: the
    reference's argmax-of-bool."""
    return torch.argmax(mask.to(torch.int32), dim=dim)


def or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR over ``dim`` (torch has no OR reduction): halves are
    folded together until one remains."""
    x = x.movedim(dim, -1)
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    while x.shape[-1] > 1:
        n = x.shape[-1]
        if n % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
            n += 1
        x = x[..., : n // 2] | x[..., n // 2:]
    return x[..., 0]


def fit_mask_t(
    *, free_t, count, max_pods, node_taints_t, node_ok, node_aff_t,
    req, tol, aff,
):
    """bool [..., S]: the admission predicates with the spot axis minor
    (``predicates/masks.fit_mask_t``). ``free_t`` [..., R, S], ``count``
    [..., S], ``node_taints_t`` [W, S], ``node_aff_t`` [..., A, S];
    ``req`` [..., R], ``tol`` [..., W], ``aff`` [..., A]."""
    res_ok = (free_t >= req[..., :, None]).all(dim=-2)
    cnt_ok = count < max_pods
    taint_ok = ((node_taints_t & ~tol[..., :, None]) == 0).all(dim=-2)
    aff_ok = ((node_aff_t & aff[..., :, None]) == 0).all(dim=-2)
    return res_ok & cnt_ok & taint_ok & aff_ok & node_ok


def _widen(static: _SpotStatics, used, dcount, daff):
    """THE widen-on-read site: absolute (free_t, count, aff_t) views of
    the delta carry (exact: integral values within the layout)."""
    free_t = static.free_t - used.to(static.free_t.dtype)
    count = static.count + dcount.to(static.count.dtype)
    aff_t = static.aff_t | daff.to(static.aff_t.dtype)
    return free_t, count, aff_t


def _zero_carry(
    layout: CarryLayout, C: int, R: int, A: int, S: int, feasible
) -> _Carry:
    dev = feasible.device
    return _Carry(
        used=torch.zeros((C, R, S), dtype=torch_dtype(layout.used), device=dev),
        dcount=torch.zeros((C, S), dtype=torch_dtype(layout.count), device=dev),
        daff=torch.zeros((C, A, S), dtype=torch_dtype(layout.aff), device=dev),
        feasible=feasible.clone(),
    )


def _spot_statics(packed) -> _SpotStatics:
    return _SpotStatics(
        free_t=packed.spot_free.t(),
        count=packed.spot_count.to(torch.int32),
        aff_t=packed.spot_aff.t(),
        max_pods=packed.spot_max_pods,
        taints_t=packed.spot_taints.t(),
        ok=packed.spot_ok,
    )


def _slot(packed, k: int):
    """Pod slot k of every lane: (req [C, R], valid [C], tol [C, W],
    aff [C, A])."""
    return (
        packed.slot_req[:, k],
        packed.slot_valid[:, k],
        packed.slot_tol[:, k],
        packed.slot_aff[:, k],
    )


def _scan_step(static: _SpotStatics, best_fit: bool, carry: _Carry, slot):
    """Place pod slot k for every candidate lane at once. Updates the
    carry's planes in place; returns (carry, chosen int32 [C])."""
    req, valid, tol, aff = slot
    free_t, count, aff_t = _widen(
        static, carry.used, carry.dcount, carry.daff
    )
    fits = fit_mask_t(
        free_t=free_t,
        count=count,
        max_pods=static.max_pods,
        node_taints_t=static.taints_t,
        node_ok=static.ok,
        node_aff_t=aff_t,
        req=req,
        tol=tol,
        aff=aff,
    )  # bool [C, S]
    any_fit = fits.any(dim=-1)
    if best_fit:
        # tightest primary-resource fit, ties -> probe order
        slack = torch.where(
            fits, free_t[:, 0, :] - req[:, 0, None], float("inf")
        )
        first = torch.argmin(slack, dim=-1)
    else:
        first = first_true(fits)  # first fitting spot per lane
    place = valid & any_fit

    S = fits.shape[-1]
    iota = torch.arange(S, device=fits.device)
    onehot = (iota[None, :] == first[:, None]) & place[:, None]  # [C, S]

    carry.used.add_((onehot[:, None, :] * req[:, :, None]).to(carry.used.dtype))
    carry.dcount.add_(onehot.to(carry.dcount.dtype))
    carry.daff.bitwise_or_(
        torch.where(onehot[:, None, :], aff[:, :, None], 0).to(carry.daff.dtype)
    )
    feasible = carry.feasible & (any_fit | ~valid)
    chosen = torch.where(place, first.to(torch.int32), -1).to(torch.int32)
    return carry._replace(feasible=feasible), chosen


def greedy_pass(
    packed, best_fit: bool = False, layout: CarryLayout = WIDE_LAYOUT
) -> tuple[_Carry, torch.Tensor]:
    """(carry, chosen int32 [C, K]): the greedy pass over every slot, its
    placements NOT masked by lane feasibility (-1 = slot unplaced), and
    the delta carry they leave. A valid pod that fits nowhere fails its
    lane's ``feasible`` and the later slots still place: in best-fit
    mode this is repair's partial pass (``solver/repair.repair_from``
    starts from it)."""
    C, K, R = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    A = packed.spot_aff.shape[1]
    static = _spot_statics(packed)
    carry = _zero_carry(layout, C, R, A, S, packed.cand_valid)
    chosen = torch.full((C, K), -1, dtype=torch.int32, device=carry.used.device)
    # a slot no lane holds changes nothing: stop after the last one held
    held = packed.slot_valid.any(dim=0).nonzero()
    for k in range(int(held[-1]) + 1 if len(held) else 0):
        carry, chosen[:, k] = _scan_step(
            static, best_fit, carry, _slot(packed, k)
        )
    return carry, chosen


def ffd_raw(
    packed, best_fit: bool = False, layout: CarryLayout = WIDE_LAYOUT
):
    """(feasible bool [C], chosen int32 [C, K]): the greedy pass with
    placements NOT masked by lane feasibility (-1 = slot unplaced), the
    output the spot-chunk loop of kernel B3 composes."""
    carry, chosen = greedy_pass(packed, best_fit, layout)
    return carry.feasible & packed.cand_valid, chosen


def plan_ffd(
    packed, best_fit: bool = False, layout: CarryLayout = WIDE_LAYOUT
) -> SolveResult:
    """Batched first-fit (or, with ``best_fit``, best-fit) solve over a
    device PackedCluster; the contract of the JAX ``plan_ffd``.
    ``layout`` narrows the delta carry; pass only what
    ``solver/carry.carry_layout`` proves the pack fits."""
    feasible, chosen = ffd_raw(packed, best_fit, layout)
    # revert semantics: infeasible lanes report no plan
    assignment = torch.where(feasible[:, None], chosen, -1).to(torch.int32)
    return SolveResult(feasible=feasible, assignment=assignment)


# --- spot-streamed passes ----------------------------------------------------


def chunk_minor(arr, n: int, Sc: int):
    """[..., n*Sc] -> [n, ..., Sc]: the minor spot axis split into n
    ordered chunks (chunk j holds global spots [j*Sc, (j+1)*Sc))."""
    return arr.reshape(*arr.shape[:-1], n, Sc).movedim(-2, 0)


def pad_spot_axis(arr, pad: int):
    """``arr`` with ``pad`` inert rows appended on its leading spot axis
    (zeros: ``spot_ok`` False, at the end of the probe order, so no
    placement or index changes)."""
    if pad == 0:
        return arr
    return torch.cat([arr, arr.new_zeros((pad, *arr.shape[1:]))])


def chunked_spot_statics(packed, n: int, Sc: int):
    """The spot statics split into n ordered chunks: (free0 [n, R, Sc],
    count0 [n, Sc], aff0 [n, A, Sc], taints [n, W, Sc], ok [n, Sc],
    max_pods [n, Sc], offs int32 [n])."""
    S = packed.spot_free.shape[0]
    pad = n * Sc - S
    return (
        chunk_minor(pad_spot_axis(packed.spot_free, pad).t(), n, Sc),
        chunk_minor(
            pad_spot_axis(packed.spot_count, pad).to(torch.int32), n, Sc
        ),
        chunk_minor(pad_spot_axis(packed.spot_aff, pad).t(), n, Sc),
        chunk_minor(pad_spot_axis(packed.spot_taints, pad).t(), n, Sc),
        chunk_minor(pad_spot_axis(packed.spot_ok, pad), n, Sc),
        chunk_minor(pad_spot_axis(packed.spot_max_pods, pad), n, Sc),
        torch.arange(n, dtype=torch.int32, device=packed.spot_free.device)
        * Sc,
    )


def _zero_chunk_state(layout: CarryLayout, n, C, R, A, Sc, device):
    """The stacked delta state over n chunks: (used [n, C, R, Sc],
    dcount [n, C, Sc], daff [n, C, A, Sc])."""
    return (
        torch.zeros((n, C, R, Sc), dtype=torch_dtype(layout.used), device=device),
        torch.zeros((n, C, Sc), dtype=torch_dtype(layout.count), device=device),
        torch.zeros((n, C, A, Sc), dtype=torch_dtype(layout.aff), device=device),
    )


def _widen_chunk(free0, count0, aff0, used, dcount, daff):
    """Per-chunk twin of ``_widen`` (chunk statics against chunk deltas)."""
    return (
        free0 - used.to(free0.dtype),
        count0 + dcount.to(count0.dtype),
        aff0 | daff.to(aff0.dtype),
    )


def _stream_bf_step(chunk_xs, Sc: int, state, slot):
    """One best-fit placement over ordered spot chunks: each chunk
    elects its tightest fit, a strict-< (slack, chunk order) election
    picks the global winner (the unchunked argmin: ties go to the
    earlier index) and only the winning chunk's deltas change, in
    place. Returns (state, (chosen global index or -1, any_fit))."""
    free0_c, count0_c, aff0_c, taints_c, ok_c, maxp_c, offs = chunk_xs
    used_c, dcount_c, daff_c = state
    req, valid, tol, aff = slot
    C = req.shape[0]
    dev = req.device
    best_slack = torch.full((C,), float("inf"), dtype=free0_c.dtype, device=dev)
    best_g = torch.zeros((C,), dtype=torch.int32, device=dev)
    for j in range(used_c.shape[0]):
        free_j, count_j, aff_j = _widen_chunk(
            free0_c[j], count0_c[j], aff0_c[j], used_c[j], dcount_c[j], daff_c[j]
        )
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
        )  # [C, Sc]
        slack = torch.where(fits, free_j[:, 0, :] - req[:, 0, None], float("inf"))
        m = slack.amin(dim=-1)
        i = torch.argmin(slack, dim=-1).to(torch.int32)
        better = m < best_slack  # strict: ties keep the earlier chunk
        best_slack = torch.where(better, m, best_slack)
        best_g = torch.where(better, offs[j] + i, best_g)
    any_fit = torch.isfinite(best_slack)
    place = valid & any_fit

    iota = torch.arange(Sc, device=dev)
    for j in range(used_c.shape[0]):
        onehot = (iota[None, :] == (best_g - offs[j])[:, None]) & place[:, None]
        used_c[j].add_((onehot[:, None, :] * req[:, :, None]).to(used_c.dtype))
        dcount_c[j].add_(onehot.to(dcount_c.dtype))
        daff_c[j].bitwise_or_(
            torch.where(onehot[:, None, :], aff[:, :, None], 0).to(daff_c.dtype)
        )
    chosen = torch.where(place, best_g, -1).to(torch.int32)
    return state, (chosen, any_fit)


def plan_ffd_streamed(
    packed,
    *,
    carry_chunks: int = 2,
    layout: CarryLayout = WIDE_LAYOUT,
    best_fit: bool = False,
) -> SolveResult:
    """``plan_ffd`` with the spot axis streamed in ``carry_chunks``
    ordered chunks (the JAX package's ``plan_ffd_streamed``; the plain
    version of kernels B3 and B4 on the streamed union).

    First-fit decomposes exactly over an ordered spot partition with
    leftover pods flowing forward: each chunk runs the K-slot pass
    against its own zero delta carry and places every still-unplaced pod
    that fits, so a lane is feasible when nothing remains. Best-fit's
    election is global: every slot runs ``_stream_bf_step`` over the
    stacked chunk state. Bit-identical to ``plan_ffd`` in both modes;
    the spot axis is padded to a chunk multiple with inert nodes at the
    end of the probe order."""
    if carry_chunks <= 1:
        return plan_ffd(packed, best_fit=best_fit, layout=layout)
    C, K, R = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    A = packed.spot_aff.shape[1]
    dev = packed.slot_req.device
    n = int(carry_chunks)
    Sc = -(-S // n)
    chunk_xs = chunked_spot_statics(packed, n, Sc)
    chosen = torch.full((C, K), -1, dtype=torch.int32, device=dev)

    if best_fit:
        state = _zero_chunk_state(layout, n, C, R, A, Sc, dev)
        feasible = packed.cand_valid.clone()
        for k in range(K):
            slot = _slot(packed, k)
            state, (chosen[:, k], any_fit) = _stream_bf_step(
                chunk_xs, Sc, state, slot
            )
            feasible = feasible & (any_fit | ~slot[1])
        feasible = feasible & packed.cand_valid
        assignment = torch.where(feasible[:, None], chosen, -1)
        return SolveResult(feasible=feasible, assignment=assignment)

    free0_c, count0_c, aff0_c, taints_c, ok_c, maxp_c, offs = chunk_xs
    remaining = packed.slot_valid.clone()
    ones = torch.ones((C,), dtype=torch.bool, device=dev)
    for j in range(n):
        static_j = _SpotStatics(
            free_t=free0_c[j],
            count=count0_c[j],
            aff_t=aff0_c[j],
            max_pods=maxp_c[j],
            taints_t=taints_c[j],
            ok=ok_c[j],
        )
        inner = _zero_carry(layout, C, R, A, Sc, ones)
        chosen_local = torch.full((C, K), -1, dtype=torch.int32, device=dev)
        for k in range(K):
            req, _, tol, aff = _slot(packed, k)
            # feasibility is the chunk loop's verdict: a leftover pod may
            # still place in a later chunk
            inner, chosen_local[:, k] = _scan_step(
                static_j, False, inner, (req, remaining[:, k], tol, aff)
            )
        placed = chosen_local >= 0
        chosen = torch.where(placed, chosen_local + offs[j], chosen)
        remaining = remaining & ~placed
    feasible = packed.cand_valid & ~remaining.any(dim=1)
    assignment = torch.where(feasible[:, None], chosen, -1)
    return SolveResult(feasible=feasible, assignment=assignment)

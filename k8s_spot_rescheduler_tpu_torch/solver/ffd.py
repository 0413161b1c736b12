"""Batched first-fit (and best-fit) drain solver, plain PyTorch.

The port of the JAX package's ``solver/ffd.plan_ffd``: every candidate
lane is an independent fork of the spot pool, the K pod slots are the
one sequential axis (a Python loop here, a ``lax.scan`` there), and
each step is vectorised over [C, S]. This is the plain version of
kernels B1/B2 (``ops/ffd_kernels``) and the CPU path of the port.

The mutable state is the wide delta carry (``solver/carry``) widened
at one site (``_widen``); the planes are updated in place, step by
step. Fit and election follow ``predicates/masks.fit_mask_t`` and the
reference's probe order: the first fitting spot (first-fit) or the
first spot of least primary-resource slack (best-fit). Torch's argmax
and argmin return the first index on ties, and argmax is taken over an
int32 cast of the bool mask (torch rejects argmax over bool).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from k8s_spot_rescheduler_tpu_torch.solver.carry import WIDE_LAYOUT
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


def _zero_carry(C: int, R: int, A: int, S: int, feasible) -> _Carry:
    dev = feasible.device
    return _Carry(
        used=torch.zeros((C, R, S), dtype=WIDE_LAYOUT.used, device=dev),
        dcount=torch.zeros((C, S), dtype=WIDE_LAYOUT.count, device=dev),
        daff=torch.zeros((C, A, S), dtype=WIDE_LAYOUT.aff, device=dev),
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


def ffd_raw(packed, best_fit: bool = False):
    """(feasible bool [C], chosen int32 [C, K]): the greedy pass with
    placements NOT masked by lane feasibility (-1 = slot unplaced), the
    output the spot-chunk loop of kernel B3 composes."""
    C, K, R = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    A = packed.spot_aff.shape[1]
    static = _spot_statics(packed)
    carry = _zero_carry(C, R, A, S, packed.cand_valid)
    chosen = torch.full((C, K), -1, dtype=torch.int32, device=carry.used.device)
    for k in range(K):
        carry, chosen[:, k] = _scan_step(
            static, best_fit, carry, _slot(packed, k)
        )
    return carry.feasible & packed.cand_valid, chosen


def plan_ffd(packed, best_fit: bool = False) -> SolveResult:
    """Batched first-fit (or, with ``best_fit``, best-fit) solve over a
    device PackedCluster; the contract of the JAX ``plan_ffd``."""
    feasible, chosen = ffd_raw(packed, best_fit)
    # revert semantics: infeasible lanes report no plan
    assignment = torch.where(feasible[:, None], chosen, -1).to(torch.int32)
    return SolveResult(feasible=feasible, assignment=assignment)

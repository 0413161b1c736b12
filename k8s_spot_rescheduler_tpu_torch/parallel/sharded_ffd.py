"""The mesh-sharded solves: the port of the JAX package's
``parallel/sharded_ffd.py``.

Same results as ``solver/ffd.plan_ffd`` and ``solver/fallback.
union_program``, bit for bit; the difference is layout:

- ``plan_ffd_sharded``, the 2-D tier: candidate lanes split over the
  ``cand`` axis (no communication) and the spot pool over the ``spot``
  axis. Every slot step, each spot shard elects its local first fit as
  a global index (shard offset plus local index, int32) or ``_BIG``,
  and a min over the row's shards, gathered on the row's first device,
  elects the winner (the JAX ``lax.pmin``); only the shard that owns
  the winner commits its delta carry. Best-fit takes two elections:
  the least slack, then the lowest index at that slack (f32 slack is
  integral, so the equality is exact). No repair on this tier: a
  lane's repair needs its whole spot axis on one device. The per-step
  election is torch ops, as XLA compiles the JAX ``lax.scan`` from
  plain ops (no Pallas kernel there);
- ``plan_union_cand_sharded``, the cand tier: lanes split over every
  device, the spot axis replicated, and each lane block runs the whole
  single-device union (``solver/fallback.union_program``, its greedy
  passes kernels B1/B2, or B3/B4 on the carry-streamed union) on its
  device. Every block's greedy passes are launched before any block's
  host sync (the union's repair gate), so blocks on distinct cards
  overlap; on one card named several times the order changes nothing.

Axes that do not divide the mesh are padded with inert entries: pad
lanes are invalid (``feasible`` False, rows -1), pad spots sit at the
end of the probe order with ``spot_ok`` False and never fit; both are
sliced off. The results land on the mesh's first device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from k8s_spot_rescheduler_tpu_torch.models.tensors import PackedCluster
from k8s_spot_rescheduler_tpu_torch.parallel.mesh import (
    CAND_AXIS,
    SPOT_AXIS,
    DeviceMesh,
    make_mesh,
    place,
)
from k8s_spot_rescheduler_tpu_torch.solver.carry import WIDE_LAYOUT
from k8s_spot_rescheduler_tpu_torch.solver.ffd import (
    _SpotStatics,
    _spot_statics,
    _widen,
    _zero_carry,
    first_true,
    fit_mask_t,
)
from k8s_spot_rescheduler_tpu_torch.solver.result import SolveResult

_BIG = 2**30


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad(arr, n: int):
    """``arr`` with zero rows appended on axis 0 up to ``n`` rows."""
    pad = n - arr.shape[0]
    if pad == 0:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr.new_zeros((pad, *arr.shape[1:]))])
    return np.concatenate([arr, np.zeros((pad, *arr.shape[1:]), arr.dtype)])


def _pad_axes(packed, Cp: int, Sp: int):
    """Pad the candidate and spot axes to ``Cp`` and ``Sp`` with inert
    entries (invalid lanes, spots with ``spot_ok`` False at the end of
    the probe order)."""
    C = packed.slot_req.shape[0]
    S = packed.spot_free.shape[0]
    if Cp == C and Sp == S:
        return packed
    return PackedCluster(
        slot_req=_pad(packed.slot_req, Cp),
        slot_valid=_pad(packed.slot_valid, Cp),
        slot_tol=_pad(packed.slot_tol, Cp),
        slot_aff=_pad(packed.slot_aff, Cp),
        cand_valid=_pad(packed.cand_valid, Cp),
        spot_free=_pad(packed.spot_free, Sp),
        spot_count=_pad(packed.spot_count, Sp),
        spot_max_pods=_pad(packed.spot_max_pods, Sp),
        spot_taints=_pad(packed.spot_taints, Sp),
        spot_ok=_pad(packed.spot_ok, Sp),
        spot_aff=_pad(packed.spot_aff, Sp),
    )


def _pad_to_mesh(packed, mesh: DeviceMesh):
    return _pad_axes(
        packed,
        _round_up(packed.slot_req.shape[0], mesh.shape[CAND_AXIS]),
        _round_up(packed.spot_free.shape[0], mesh.shape[SPOT_AXIS]),
    )


class _Shard(NamedTuple):
    """One (cand, spot) block: its lanes, spot statics, delta carry
    and the global index of its first spot."""

    block: PackedCluster
    static: _SpotStatics
    carry: object  # solver/ffd._Carry
    offset: int


def _elect(values, lead: torch.device) -> torch.Tensor:
    """The elementwise min of one [Cl] tensor a spot shard, on ``lead``."""
    if len(values) == 1:
        return values[0]
    return torch.stack([v.to(lead) for v in values]).amin(dim=0)


def _local_fits(shard: _Shard, k: int):
    """(fits bool [Cl, Sl], free_t [Cl, R, Sl], slot k's rows) of one
    shard, from its delta carry widened on read."""
    b = shard.block
    req, tol, aff = b.slot_req[:, k], b.slot_tol[:, k], b.slot_aff[:, k]
    free_t, count, aff_t = _widen(
        shard.static, shard.carry.used, shard.carry.dcount, shard.carry.daff
    )
    fits = fit_mask_t(
        free_t=free_t,
        count=count,
        max_pods=shard.static.max_pods,
        node_taints_t=shard.static.taints_t,
        node_ok=shard.static.ok,
        node_aff_t=aff_t,
        req=req,
        tol=tol,
        aff=aff,
    )
    return fits, free_t, (req, b.slot_valid[:, k], aff)


def _first_global(mask: torch.Tensor, offset: int) -> torch.Tensor:
    """int32 [Cl]: the global index of each lane's first True, or _BIG."""
    local = first_true(mask).to(torch.int32)
    return torch.where(mask.any(dim=-1), local + offset, _BIG).to(torch.int32)


def _row_step(shards, best_fit: bool, k: int):
    """Place slot k for one cand row's lanes across its spot shards;
    returns (winner int32 [Cl] or _BIG, valid bool [Cl]) on the row's
    first device. Each shard's carry is updated in place."""
    lead = shards[0].block.slot_req.device
    local = [_local_fits(sh, k) for sh in shards]
    if best_fit:
        slacks = [
            torch.where(fits, free_t[:, 0, :] - req[:, 0, None],
                        float("inf"))
            for fits, free_t, (req, _, _) in local
        ]
        least = _elect([s.amin(dim=-1) for s in slacks], lead)
        mine = [
            _first_global(fits & (s == least.to(s.device)[:, None]), sh.offset)
            for (fits, _, _), s, sh in zip(local, slacks, shards)
        ]
    else:
        mine = [_first_global(fits, sh.offset)
                for (fits, _, _), sh in zip(local, shards)]
    winner = _elect(mine, lead)
    for sh, (fits, _, (req, valid, aff)) in zip(shards, local):
        w = winner.to(fits.device)
        local_w = w - sh.offset
        mine_here = valid & (w < _BIG) & (local_w >= 0) & (
            local_w < fits.shape[-1])
        iota = torch.arange(fits.shape[-1], device=fits.device)
        onehot = (iota[None, :] == local_w[:, None]) & mine_here[:, None]
        carry = sh.carry
        carry.used.add_(
            (onehot[:, None, :] * req[:, :, None]).to(carry.used.dtype))
        carry.dcount.add_(onehot.to(carry.dcount.dtype))
        carry.daff.bitwise_or_(
            torch.where(onehot[:, None, :], aff[:, :, None], 0).to(
                carry.daff.dtype))
    return winner, local[0][2][1]


def plan_ffd_sharded(
    mesh: DeviceMesh,
    packed,
    best_fit: bool = False,
    layout=WIDE_LAYOUT,
) -> SolveResult:
    """The 2-D (cand x spot) first-fit (or best-fit) solve over
    ``mesh`` (``make_mesh``); ``packed`` is a PackedCluster of numpy
    arrays or tensors on any device. ``layout`` narrows each shard's
    delta carry; pass only what ``solver/carry.carry_layout(packed)``
    proves. The contract of ``plan_ffd``: feasible [C], assignment
    [C, K], on the mesh's first device."""
    C = packed.slot_req.shape[0]
    K = packed.slot_req.shape[1]
    R = packed.slot_req.shape[2]
    A = packed.spot_aff.shape[1]
    packed = _pad_to_mesh(packed, mesh)
    n_cand, n_spot = mesh.shape[CAND_AXIS], mesh.shape[SPOT_AXIS]
    Cl = packed.slot_req.shape[0] // n_cand
    Sl = packed.spot_free.shape[0] // n_spot
    rows = []
    for i in range(n_cand):
        shards = []
        for j in range(n_spot):
            block = place(packed, mesh.devices[i, j],
                          lanes=slice(i * Cl, (i + 1) * Cl),
                          spots=slice(j * Sl, (j + 1) * Sl))
            shards.append(_Shard(
                block, _spot_statics(block),
                _zero_carry(layout, Cl, R, A, Sl, block.cand_valid),
                j * Sl,
            ))
        rows.append(shards)
    feasible = [sh[0].block.cand_valid.clone() for sh in rows]
    chosen = [torch.full((Cl, K), -1, dtype=torch.int32,
                         device=sh[0].block.slot_req.device) for sh in rows]
    for k in range(K):
        # slot k of every cand row before slot k + 1 of any: rows on
        # distinct devices queue their steps side by side
        for i, shards in enumerate(rows):
            winner, valid = _row_step(shards, best_fit, k)
            any_fit = winner < _BIG
            feasible[i] = feasible[i] & (any_fit | ~valid)
            chosen[i][:, k] = torch.where(valid & any_fit, winner, -1)
    lead = mesh.lead
    out_f, out_a = [], []
    for shards, f, ch in zip(rows, feasible, chosen):
        f = f & shards[0].block.cand_valid
        out_f.append(f.to(lead))
        out_a.append(torch.where(f[:, None], ch, -1).to(lead))
    return SolveResult(
        feasible=torch.cat(out_f)[:C],
        assignment=torch.cat(out_a)[:C].to(torch.int32),
    )


def _cand_devices(mesh: DeviceMesh) -> list:
    if mesh.axis_names != (CAND_AXIS,):
        raise ValueError(
            f"the cand tier takes a 1-D cand mesh (make_cand_mesh), "
            f"not axes {mesh.axis_names}"
        )
    return list(mesh.devices.flat)


def plan_union_cand_sharded(
    mesh: DeviceMesh,
    packed,
    *,
    rounds: int = 0,
    best_fit_fallback: bool = True,
    repair_spot_chunks: int = 1,
    carry_chunks: int = 0,
    carry_layout=None,
    use_kernel: bool = False,
) -> SolveResult:
    """Candidate-only sharding: each device of ``mesh``
    (``make_cand_mesh``) holds a block of lanes with the whole spot axis
    and runs ``solver/fallback.union_program(rounds, best_fit_fallback,
    repair_spot_chunks=, carry_chunks=, carry_layout=, use_kernel=)``
    on it: repair stays live (spot-chunked past ``repair_spot_chunks``
    > 1; ``carry_chunks`` >= 1 runs the carry-streamed narrow union
    under ``carry_layout``). ``use_kernel`` runs the greedy passes as
    the kernels (the JAX package's ``use_pallas``). Returns feasible
    [C] and assignment [C, K] on the mesh's first device."""
    from k8s_spot_rescheduler_tpu_torch.solver.fallback import (
        stages,
        union_program,
    )

    greedy, finish = stages(union_program(
        rounds,
        best_fit_fallback,
        repair_spot_chunks=repair_spot_chunks,
        carry_chunks=carry_chunks,
        carry_layout=carry_layout,
        use_kernel=use_kernel,
    ))
    devices = _cand_devices(mesh)
    C = packed.slot_req.shape[0]
    packed = _pad_axes(packed, _round_up(C, len(devices)),
                       packed.spot_free.shape[0])
    Cl = packed.slot_req.shape[0] // len(devices)
    blocks = [place(packed, dev, lanes=slice(i * Cl, (i + 1) * Cl))
              for i, dev in enumerate(devices)]
    unions = [greedy(b) for b in blocks]  # every block launched first
    results = [finish(b, u) for b, u in zip(blocks, unions)]
    lead = mesh.lead
    return SolveResult(
        feasible=torch.cat([r.feasible.to(lead) for r in results])[:C],
        assignment=torch.cat(
            [r.assignment.to(lead) for r in results])[:C].to(torch.int32),
    )


def make_sharded_planner(mesh_shape: Tuple[int, int] | None = None,
                         devices=None):
    """The 2-D solve bound to a mesh over ``devices`` (every visible
    card when None): the ``"sharded"`` solver's greedy pass."""
    return functools.partial(plan_ffd_sharded, make_mesh(mesh_shape, devices))
